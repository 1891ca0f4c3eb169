"""whisperlive_tpu_torch — the PyTorch/CUDA port of whisperlive_tpu.

The JAX package beside it is the reference; this package serves the same
continuous-batching and window-scheduler paths on an NVIDIA H100 (Hopper,
sm_90a). Module paths and names mirror the JAX package so each counterpart
is easy to find:

    cli/run_server.py     WebSocket server entry point
    serving/              TranscriptionServer, StreamingSession, and
                          TorchBackend: VAD gate -> ContinuousScheduler or
                          BatchScheduler
    engine/               WhisperEngine, the continuous slot pool and
                          scheduler, the window BatchScheduler, segment
                          splitting, the tokenizer
    models/               functional Whisper over a parameter dict, and the
                          bridge from a JAX parameter tree
    ops/                  log-mel, logit rules (window and ring) and
                          sampling, and the five hand-written CUDA kernels
                          (csrc/) with their plain PyTorch versions
    audio/, utils/        wire PCM conversion, the streaming VAD, metrics

Nothing here imports jax or any module of whisperlive_tpu: the host modules
the port needs are its own copies (tests/test_torch_isolation.py).
"""

__version__ = "0.1.0"
