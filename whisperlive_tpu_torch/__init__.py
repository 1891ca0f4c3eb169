"""whisperlive_tpu_torch — the PyTorch/CUDA port of whisperlive_tpu.

The JAX package beside it is the reference; this package serves the same
continuous-batching and window-scheduler paths on an NVIDIA H100 (Hopper,
sm_90a). Module paths and names mirror the JAX package so each counterpart
is easy to find:

    cli/                  the server (WebSocket, REST), client, offline
                          transcribe, convert and distill entry points
    serving/              TranscriptionServer, StreamingSession, the REST
                          endpoint, and TorchBackend: VAD gate ->
                          ContinuousScheduler or BatchScheduler
    client/               the client library
    translation.py,       the translation worker and SMALL100/M2M100
    small100_tokenizer.py (models/m2m100.py) with its tokenizer
    diarization.py        online speaker clustering over the embedders of
                          audio/speaker_model.py and audio/wespeaker.py
    engine/               WhisperEngine, the continuous slot pool and
                          scheduler, the window BatchScheduler, segment
                          splitting, the tokenizer
    models/               functional Whisper and M2M100 over parameter dicts,
                          checkpoint conversion, and the bridge from a JAX
                          parameter tree
    ops/                  log-mel, logit rules (window and ring) and
                          sampling, and the five hand-written CUDA kernels
                          (csrc/) with their plain PyTorch versions
    audio/, utils/        wire PCM conversion, the streaming VAD, speaker
                          embedders, metrics, subtitles

Nothing here imports jax or any module of whisperlive_tpu: the host modules
the port needs are its own copies (tests/test_torch_isolation.py).
"""

__version__ = "0.1.0"
