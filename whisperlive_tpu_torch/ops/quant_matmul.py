"""Weight-only int8 matmuls of the slice: K2 (linears) and K3 (logits).

    int8_matmul    x[M,K] @ w8[K,N] * s[N]      every decoder linear, M <= 512
    int8_matmul_t  x[M,K] @ w8[N,K]^T * s[N]    tied-embedding logits

Wrappers of hand-written CUDA kernels (whisperlive_tpu_torch/csrc): a CUDA
tensor launches the kernel or raises; a CPU tensor, and only a CPU tensor,
runs the plain PyTorch `*_ref`. Contracts follow the TPU kernels of
whisperlive_tpu/ops/quant_matmul.py: f32 accumulation, the scale applied in
f32, output in x's dtype (K2) or float32 (K3).
"""

from __future__ import annotations

import torch

from whisperlive_tpu_torch.ops import _kernels
from whisperlive_tpu_torch.ops.attention import require, runs_on_cpu


def int8_matmul_ref(
    x: torch.Tensor, w8: torch.Tensor, s: torch.Tensor, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    acc = torch.matmul(x.float(), w8.float())
    return (acc * s.float()).to(out_dtype or x.dtype)


def int8_matmul_t_ref(x: torch.Tensor, w8: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w8.float().t()) * s.float()


# K2 (csrc/int8_matmul.cu) tiles K and N by 64: 64 k a pipeline stage,
# 64 output columns a CTA.
K2_TILE = 64
# K3 (csrc/int8_matmul_t.cu) splits K into 32-k step pairs over eight
# warps that hold their pairs of x in registers: K a multiple of 64 and at
# most 1280 (every d_model of Whisper). The vocab's ragged last tile is
# masked, so N is free.
K3_K_TILE = 64
K3_MAX_K = 1280


def _check(x: torch.Tensor, w8: torch.Tensor, s: torch.Tensor, k: int, n: int) -> None:
    require(x.dim() == 2 and x.shape[1] == k, f"x {tuple(x.shape)} does not match K={k}")
    require(x.dtype == torch.bfloat16, f"x must be bfloat16, got {x.dtype}")
    require(w8.dtype == torch.int8, f"w8 must be int8, got {w8.dtype}")
    require(s.dtype == torch.bfloat16 and tuple(s.shape) == (n,),
            f"s must be a [{n}] bfloat16, got {tuple(s.shape)} {s.dtype}")
    require(x.is_contiguous() and w8.is_contiguous() and s.is_contiguous(),
            "x, w8 and s must be contiguous")
    require(x.data_ptr() % 16 == 0 and w8.data_ptr() % 16 == 0,
            "x and w8 must be 16-byte aligned")
    require(x.shape[0] >= 1, "x needs at least one row")


def int8_matmul(
    x: torch.Tensor, w8: torch.Tensor, s: torch.Tensor, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """x [M, K] bf16, w8 [K, N] int8, s [N] bf16 -> [M, N] in x's dtype."""
    if runs_on_cpu(x, w8, s):
        return int8_matmul_ref(x, w8, s, out_dtype)
    k, n = w8.shape
    _check(x, w8, s, k, n)
    require(out_dtype in (None, x.dtype), "the kernel writes x's dtype")
    require(k % K2_TILE == 0 and n % K2_TILE == 0,
            f"K={k} and N={n} must be multiples of {K2_TILE}")
    out = torch.empty((x.shape[0], n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _kernels.launch(
            "int8_matmul", x.data_ptr(), w8.data_ptr(), s.data_ptr(), out.data_ptr(),
            x.shape[0], k, n, torch.cuda.current_stream().cuda_stream,
        )
    return out


def int8_matmul_t(x: torch.Tensor, w8: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [M, K] bf16, w8 [N, K] int8, s [N] bf16 -> [M, N] float32."""
    if runs_on_cpu(x, w8, s):
        return int8_matmul_t_ref(x, w8, s)
    n, k = w8.shape
    _check(x, w8, s, k, n)
    require(k % K3_K_TILE == 0 and k <= K3_MAX_K,
            f"K={k} must be a multiple of {K3_K_TILE} and at most {K3_MAX_K}")
    out = torch.empty((x.shape[0], n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _kernels.launch(
            "int8_matmul_t", x.data_ptr(), w8.data_ptr(), s.data_ptr(), out.data_ptr(),
            x.shape[0], k, n, torch.cuda.current_stream().cuda_stream,
        )
    return out
