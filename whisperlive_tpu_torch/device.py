"""Device and dtype policy of the port.

Mirrors the platform switch of whisperlive_tpu/engine/engine.py (bf16 and
int8 decoder weights and cross-KV on the accelerator, float32 and full
precision on the CPU). A "cuda" request on a machine without a usable CUDA
device raises: there is no quiet CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The engine's device; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly for a CPU run"
            )
        # float32 products in full precision, as the JAX mel frontend asks
        # with Precision.HIGHEST (whisperlive_tpu/ops/mel.py)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def default_compute_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def default_quantized(device: torch.device) -> bool:
    """Decoder int8 weights and cross_kv_bits=8 are the CUDA defaults."""
    return device.type == "cuda"
