"""whisperlive_tpu_torch — the PyTorch/CUDA port of whisperlive_tpu.

The JAX package beside it is the reference; this package serves the same
window-scheduler path on an NVIDIA H100 (Hopper, sm_90a). Module paths and
names mirror the JAX package so each counterpart is easy to find:

    cli/run_server.py     WebSocket server entry point (window scheduler)
    serving/backends.py   TorchBackend: VAD gate -> BatchScheduler
    engine/               WhisperEngine, BatchScheduler, segment splitting
    models/               functional Whisper over a parameter dict, and the
                          bridge from a JAX parameter tree
    ops/                  log-mel, logit rules and sampling, and the four
                          hand-written CUDA kernels (csrc/) with their plain
                          PyTorch versions

The host-side modules that import no JAX (tokenizer, session/server, VAD,
metrics, client) are reused from whisperlive_tpu by import. Nothing here
imports jax.
"""

__version__ = "0.1.0"
