"""Python client library (drop-in compatible with whisper_live.client)."""

from whisperlive_tpu_torch.client.client import (  # noqa: F401
    Client,
    StreamingTranscriptionClient,
    TranscriptionClient,
    TranscriptionTeeClient,
)
