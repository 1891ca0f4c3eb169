"""The benchmark of the PyTorch/CUDA port (whisperlive_tpu_torch): see README.md."""
