"""Attention kernels: K1 (encoder), K4 (int8 decode cross), K5 (K4 with
per-slot lengths and an active mask, for the continuous decode step) and
its window form, K6 (K4 over a window of up to 8 queries, the speculative
verify pass), K7 and K8 (K4 and K6 over int4 K and V).

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
    read through their strides; returns a contiguous [B, T, H, 64] bf16.

    The kernel has no backward pass (neither has the TPU kernel it ports):
    on CUDA tensors that require grad under grad mode it raises rather than
    return a result cut from the autograd graph."""
    if runs_on_cpu(q, k, v):
        return fused_attention_ref(q, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "fused_attention (K1, csrc/fused_attention.cu) has no backward pass, in this "
            "package or in the JAX package's Pallas kernel: differentiate through the plain "
            "attention (whisperlive_tpu_torch.training.encode_train) or call it under "
            "torch.no_grad()")
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


# ---------------------------------------------------------------------------
# Windows of Tq <= 8 queries (speculative verify) and int4 K/V
# ---------------------------------------------------------------------------

MAX_WINDOW = 8


def window_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor | None = None
) -> torch.Tensor:
    """q [B, H, Tq, hd] (K scales folded in), k and v [B, H, T, hd] of any
    dtype, lengths optional [B] -> [B, H, Tq, hd] f32: f32 scores and
    softmax, positions >= lengths[b] at f32-min, probabilities cast to q's
    dtype before the PV sum (V scales are applied by the caller)."""
    hd = q.shape[-1]
    scores = torch.einsum("bhqd,bhtd->bhqt", q.float(), k.float()) * hd**-0.5
    if lengths is not None:
        col = torch.arange(k.shape[2], device=k.device)
        scores = torch.where(col[None, None, None, :] < lengths[:, None, None, None], scores,
                             NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqt,bhtd->bhqd", probs.float(), v.float())


def _check_window(q: torch.Tensor, b: int, h: int, t: int) -> int:
    """Shape, dtype and layout checks of a [B, H, Tq, 64] query window
    against [B, H, T, *] K/V; -> Tq."""
    require(q.dim() == 4 and tuple(q.shape[:2]) == (b, h) and q.shape[3] == HEAD_DIM,
            f"q {tuple(q.shape)} is not a [{b}, {h}, Tq, {HEAD_DIM}] window")
    tq = q.shape[2]
    require(1 <= tq <= MAX_WINDOW, f"Tq={tq} outside the kernel's 1..{MAX_WINDOW} queries")
    require(q.dtype == torch.bfloat16, f"q must be bfloat16, got {q.dtype}")
    require(q.is_contiguous(), "q must be contiguous")
    return tq


def _check_lengths(lengths: torch.Tensor | None, b: int) -> None:
    if lengths is not None:
        require(lengths.dtype == torch.int32 and tuple(lengths.shape) == (b,)
                and lengths.is_contiguous(), "lengths must be a contiguous [B] int32")


# K6 and K5's window form ----------------------------------------------------


def cross_attention_int8_window_ref(
    q: torch.Tensor, kvp: torch.Tensor, lengths: torch.Tensor | None = None
) -> torch.Tensor:
    """q [B, H, Tq, hd], kvp [B, H, T, 2*hd] int8 (K lanes [:hd], V lanes
    [hd:]), lengths optional [B] -> [B, H, Tq, hd] f32."""
    hd = q.shape[-1]
    return window_attention_ref(q, kvp[..., :hd], kvp[..., hd:], lengths)


def cross_attention_int8_skip_window_ref(
    q: torch.Tensor, kvp: torch.Tensor, lengths: torch.Tensor, active: torch.Tensor
) -> torch.Tensor:
    """K6's masked contract on the active rows; inactive rows are zero (the
    TPU kernel leaves them unspecified, so callers must not read them)."""
    out = cross_attention_int8_window_ref(q, kvp, lengths)
    return torch.where(active[:, None, None, None], out, 0.0)


def _check_int8_window(q, kvp, lengths):
    require(kvp.dim() == 4 and kvp.shape[3] == 2 * HEAD_DIM,
            f"kvp {tuple(kvp.shape)} is not [B, H, T, {2 * HEAD_DIM}]")
    b, h, t, _ = kvp.shape
    require(kvp.dtype == torch.int8 and kvp.is_contiguous() and kvp.data_ptr() % 16 == 0,
            "kvp must be contiguous, 16-byte-aligned int8")
    require(1 <= t <= 8192, f"T={t} outside the kernel's 1..8192 positions")
    _check_lengths(lengths, b)
    return b, h, t, _check_window(q, b, h, t)


def cross_attention_int8_window(
    q: torch.Tensor, kvp: torch.Tensor, lengths: torch.Tensor | None = None,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """Cross-attention of a Tq <= 8 query window over packed int8 K|V, each
    K/V byte read once per window (K6, an instantiation of K4's source:
    T <= 8192 at every Tq). q [B, H, Tq, 64] bf16, kvp [B, H, T, 128] int8,
    lengths optional [B] int32; returns [B, H, Tq, 64] float32. `active`
    ([B] bool, requires `lengths`) routes to K5's window form,
    cross_attention_int8_skip_window: inactive rows read no K/V."""
    if active is not None:
        if lengths is None:
            raise ValueError("active-slot skipping requires per-slot lengths")
        return cross_attention_int8_skip_window(q, kvp, lengths, active)
    tensors = (q, kvp) if lengths is None else (q, kvp, lengths)
    if runs_on_cpu(*tensors):
        return cross_attention_int8_window_ref(q, kvp, lengths)
    b, h, t, tq = _check_int8_window(q, kvp, lengths)
    len_ptr = 0 if lengths is None else lengths.data_ptr()
    out = torch.empty((b, h, tq, HEAD_DIM), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _kernels.launch(
            "cross_attention_int8_window", q.data_ptr(), kvp.data_ptr(), len_ptr,
            out.data_ptr(), b, h, t, tq, HEAD_DIM**-0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    return out


def cross_attention_int8_skip_window(
    q: torch.Tensor, kvp: torch.Tensor, lengths: torch.Tensor, active: torch.Tensor
) -> torch.Tensor:
    """K5's window form, the continuous verify pass: K6 with per-slot
    lengths and an active mask. Returns [B, H, Tq, 64] float32, zero on
    inactive rows, whose K/V the kernel never reads."""
    if runs_on_cpu(q, kvp, lengths, active):
        return cross_attention_int8_skip_window_ref(q, kvp, lengths, active)
    b, h, t, tq = _check_int8_window(q, kvp, lengths)
    require(active.dtype == torch.bool and tuple(active.shape) == (b,)
            and active.is_contiguous(), "active must be a contiguous [B] bool")
    out = torch.empty((b, h, tq, HEAD_DIM), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _kernels.launch(
            "cross_attention_int8_skip_window", q.data_ptr(), kvp.data_ptr(),
            lengths.data_ptr(), active.data_ptr(), out.data_ptr(), b, h, t, tq,
            HEAD_DIM**-0.5, torch.cuda.current_stream().cuda_stream,
        )
    return out


# K7 and K8: int4 K and V ----------------------------------------------------


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., C/2] int8 holding two signed nibbles -> [..., C] int8. Halves
    layout: channel c < C/2 is the low nibble of byte c, channel C/2 + c
    its high nibble."""
    p = packed.to(torch.int16)
    low = ((p & 0xF) ^ 8) - 8
    high = p >> 4  # arithmetic: the sign of the byte is the high nibble's
    return torch.cat([low, high], dim=-1).to(torch.int8)


def pack_int4(values: torch.Tensor) -> torch.Tensor:
    """[..., C] int8 in [-8, 7] -> [..., C/2] packed int8 (halves layout)."""
    c = values.shape[-1]
    v = values.to(torch.int16)
    byte = (v[..., : c // 2] & 0xF) | ((v[..., c // 2:] & 0xF) << 4)  # 0..255
    return torch.where(byte >= 128, byte - 256, byte).to(torch.int8)


def cross_attention_int4_ref(
    q: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor, lengths: torch.Tensor | None = None
) -> torch.Tensor:
    """q [B, H, hd] (K scales folded in), k4 and v4 [B, H, T, hd/2] packed
    int4, lengths optional [B] -> [B, H, hd] f32."""
    return cross_attention_int4_window_ref(q[:, :, None], k4, v4, lengths)[:, :, 0]


def cross_attention_int4_window_ref(
    q: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor, lengths: torch.Tensor | None = None
) -> torch.Tensor:
    """q [B, H, Tq, hd], k4 and v4 [B, H, T, hd/2] packed int4, lengths
    optional [B] -> [B, H, Tq, hd] f32."""
    return window_attention_ref(q, unpack_int4(k4), unpack_int4(v4), lengths)


def _check_int4(k4, v4, lengths):
    require(k4.dim() == 4 and k4.shape[3] == HEAD_DIM // 2 and k4.shape == v4.shape,
            f"k4 {tuple(k4.shape)} and v4 {tuple(v4.shape)} are not [B, H, T, "
            f"{HEAD_DIM // 2}]")
    for name, x in (("k4", k4), ("v4", v4)):
        require(x.dtype == torch.int8 and x.is_contiguous() and x.data_ptr() % 16 == 0,
                f"{name} must be contiguous, 16-byte-aligned int8")
    b, h, t, _ = k4.shape
    require(1 <= t <= 8192, f"T={t} outside the kernel's 1..8192 positions")
    _check_lengths(lengths, b)
    return b, h, t


def cross_attention_int4(
    q: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor, lengths: torch.Tensor | None = None
) -> torch.Tensor:
    """Single-token cross-attention over int4 K and V (K7, an instantiation
    of K4's source: T <= 8192). q [B, H, 64] bf16, k4 and v4 [B, H, T, 32]
    packed int4, lengths optional [B] int32; returns [B, H, 64] float32."""
    tensors = (q, k4, v4) if lengths is None else (q, k4, v4, lengths)
    if runs_on_cpu(*tensors):
        return cross_attention_int4_ref(q, k4, v4, lengths)
    b, h, t = _check_int4(k4, v4, lengths)
    _check_window(q[:, :, None], b, h, t)
    len_ptr = 0 if lengths is None else lengths.data_ptr()
    out = torch.empty((b, h, HEAD_DIM), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _kernels.launch(
            "cross_attention_int4", q.data_ptr(), k4.data_ptr(), v4.data_ptr(), len_ptr,
            out.data_ptr(), b, h, t, HEAD_DIM**-0.5, torch.cuda.current_stream().cuda_stream,
        )
    return out


def cross_attention_int4_window(
    q: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor, lengths: torch.Tensor | None = None
) -> torch.Tensor:
    """Cross-attention of a Tq <= 8 query window over int4 K and V, each
    byte read once per window (K8, an instantiation of K4's source: T <=
    8192 at every Tq). q [B, H, Tq, 64] bf16, k4 and v4 [B, H, T, 32],
    lengths optional [B] int32; returns [B, H, Tq, 64] float32."""
    tensors = (q, k4, v4) if lengths is None else (q, k4, v4, lengths)
    if runs_on_cpu(*tensors):
        return cross_attention_int4_window_ref(q, k4, v4, lengths)
    b, h, t = _check_int4(k4, v4, lengths)
    tq = _check_window(q, b, h, t)
    len_ptr = 0 if lengths is None else lengths.data_ptr()
    out = torch.empty((b, h, tq, HEAD_DIM), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _kernels.launch(
            "cross_attention_int4_window", q.data_ptr(), k4.data_ptr(), v4.data_ptr(),
            len_ptr, out.data_ptr(), b, h, t, tq, HEAD_DIM**-0.5,
            torch.cuda.current_stream().cuda_stream,
        )
    return out
