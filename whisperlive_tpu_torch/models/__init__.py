"""Functional PyTorch Whisper and the bridge from a JAX parameter tree."""
