"""Attention kernels: K1 (encoder), K4 (int8 decode cross) and K5 (K4 with
per-slot lengths and an active mask, for the continuous decode step).

Each public function is the wrapper of a hand-written CUDA kernel
(whisperlive_tpu_torch/csrc): for a CUDA tensor it checks device, dtype,
shape and contiguity, allocates the output and launches the kernel on the
current stream, or raises. For a CPU tensor, and only then, it runs the
plain PyTorch `*_ref` beside it, which is also the kernel's test oracle.

Contracts follow the TPU kernels of whisperlive_tpu/ops/attention.py.
"""

from __future__ import annotations

import torch

from whisperlive_tpu_torch.ops import _kernels

NEG_INF = float(torch.finfo(torch.float32).min)
HEAD_DIM = 64


def runs_on_cpu(*tensors: torch.Tensor) -> bool:
    """True when the inputs lie on the CPU (plain path); False on CUDA.

    Any other device, or inputs on different devices, raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# K1: fused bidirectional attention (encoder)
# ---------------------------------------------------------------------------


def fused_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, T, H, hd] -> [B, T, H, hd] in q's dtype: f32 scores and
    softmax, probabilities cast to v's dtype before the PV product."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd**-0.5
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bidirectional fused attention (encoder). q, k, v [B, T, H, 64] bf16,
    read through their strides; returns a contiguous [B, T, H, 64] bf16."""
    if runs_on_cpu(q, k, v):
        return fused_attention_ref(q, k, v)
    require(q.dim() == 4 and q.shape == k.shape == v.shape,
            f"q, k, v must share a [B, T, H, hd] shape: {q.shape} {k.shape} {v.shape}")
    b, t, h, hd = q.shape
    require(hd == HEAD_DIM, f"head_dim must be {HEAD_DIM}, got {hd}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        require(x.dtype == torch.bfloat16, f"{name} must be bfloat16, got {x.dtype}")
        require(x.stride(3) == 1 and all(s % 8 == 0 for s in x.stride()[:3])
                and x.data_ptr() % 16 == 0,
                f"{name} needs a contiguous head_dim, 16-byte-aligned rows")
    out = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _kernels.launch(
            "fused_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, h, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], hd**-0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    return out


# ---------------------------------------------------------------------------
# K4: single-query cross-attention over packed int8 K|V (decode step)
# ---------------------------------------------------------------------------


def cross_attention_int8_ref(
    q: torch.Tensor, kvp: torch.Tensor, lengths: torch.Tensor | None = None
) -> torch.Tensor:
    """q [B, H, hd] (K scales folded in), kvp [B, H, T, 2*hd] int8 with K in
    lanes [:hd] and V in lanes [hd:], lengths optional [B] -> [B, H, hd]
    f32 (V scales are applied by the caller)."""
    hd = q.shape[-1]
    k = kvp[..., :hd].float()
    v = kvp[..., hd:].float()
    scores = torch.einsum("bhd,bhtd->bht", q.float(), k) * hd**-0.5
    if lengths is not None:
        col = torch.arange(kvp.shape[2], device=kvp.device)
        scores = torch.where(col[None, None, :] < lengths[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bht,bhtd->bhd", probs.float(), v)


def _check_int8_cross(q: torch.Tensor, kvp: torch.Tensor, lengths: torch.Tensor | None):
    """Shape, dtype and layout checks shared by K4 and K5; -> (b, h, t, hd)."""
    require(q.dim() == 3 and kvp.dim() == 4, f"bad ranks: q {q.shape} kvp {kvp.shape}")
    b, h, hd = q.shape
    t = kvp.shape[2]
    require(hd == HEAD_DIM and tuple(kvp.shape) == (b, h, t, 2 * hd),
            f"q {tuple(q.shape)} does not match kvp {tuple(kvp.shape)}")
    require(q.dtype == torch.bfloat16, f"q must be bfloat16, got {q.dtype}")
    require(kvp.dtype == torch.int8, f"kvp must be int8, got {kvp.dtype}")
    require(q.is_contiguous() and kvp.is_contiguous(), "q and kvp must be contiguous")
    require(1 <= t <= 8192, f"T={t} outside the kernel's 1..8192 positions")
    if lengths is not None:
        require(lengths.dtype == torch.int32 and tuple(lengths.shape) == (b,)
                and lengths.is_contiguous(), "lengths must be a contiguous [B] int32")
    return b, h, t, hd


def cross_attention_int8(
    q: torch.Tensor, kvp: torch.Tensor, lengths: torch.Tensor | None = None,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """Single-token cross-attention reading packed int8 K|V. q [B, H, 64]
    bf16, kvp [B, H, T, 128] int8, lengths optional [B] int32; returns
    [B, H, 64] float32. `active` ([B] bool, requires `lengths`) routes to
    K5, cross_attention_int8_skip: inactive rows read no K/V."""
    if active is not None:
        if lengths is None:
            raise ValueError("active-slot skipping requires per-slot lengths")
        return cross_attention_int8_skip(q, kvp, lengths, active)
    tensors = (q, kvp) if lengths is None else (q, kvp, lengths)
    if runs_on_cpu(*tensors):
        return cross_attention_int8_ref(q, kvp, lengths)
    b, h, t, hd = _check_int8_cross(q, kvp, lengths)
    len_ptr = 0 if lengths is None else lengths.data_ptr()
    out = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _kernels.launch(
            "cross_attention_int8", q.data_ptr(), kvp.data_ptr(), len_ptr,
            out.data_ptr(), b, h, t, hd**-0.5, torch.cuda.current_stream().cuda_stream,
        )
    return out


# ---------------------------------------------------------------------------
# K5: K4 with per-slot lengths and an active mask (continuous decode step)
# ---------------------------------------------------------------------------


def cross_attention_int8_skip_ref(
    q: torch.Tensor, kvp: torch.Tensor, lengths: torch.Tensor, active: torch.Tensor
) -> torch.Tensor:
    """K4's masked contract on the active rows; inactive rows are zero. The
    TPU kernel leaves them unspecified, so callers must not read them."""
    out = cross_attention_int8_ref(q, kvp, lengths)
    return torch.where(active[:, None, None], out, 0.0)


def cross_attention_int8_skip(
    q: torch.Tensor, kvp: torch.Tensor, lengths: torch.Tensor, active: torch.Tensor
) -> torch.Tensor:
    """Single-token cross-attention of the continuous decode step. q
    [B, H, 64] bf16 (K scales folded in), kvp [B, H, T, 128] int8, lengths
    [B] int32, active [B] bool; returns [B, H, 64] float32, zero on
    inactive rows, whose K/V the kernel never reads."""
    if runs_on_cpu(q, kvp, lengths, active):
        return cross_attention_int8_skip_ref(q, kvp, lengths, active)
    b, h, t, hd = _check_int8_cross(q, kvp, lengths)
    require(active.dtype == torch.bool and tuple(active.shape) == (b,)
            and active.is_contiguous(), "active must be a contiguous [B] bool")
    out = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _kernels.launch(
            "cross_attention_int8_skip", q.data_ptr(), kvp.data_ptr(), lengths.data_ptr(),
            active.data_ptr(), out.data_ptr(), b, h, t, hd**-0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    return out
