"""Compute primitives: log-mel, logit rules and sampling, and the CUDA
kernels (attention, quant_matmul) with their plain PyTorch versions."""
