"""Compute primitives: log-mel, logit rules (window and ring) and sampling,
and the CUDA kernels (attention, quant_matmul) with their plain PyTorch
versions."""
