"""Roofline accounting for the Whisper serving path on the H100.

Closed-form FLOP and HBM-byte models of the engine's two phases — the
once-per-window insert (mel → encoder → cross-KV → prefill) and the
per-token decode step — so benchmarks can report achieved-vs-peak
utilisation (MFU, HBM util) and name the binding bottleneck with numbers.

Conventions: FLOPs count multiply-adds as 2; attention is unmasked full
length (the engine decodes lockstep over static buckets, so padded work is
real work); weight bytes assume the serving defaults (int8 decoder linears
+ int8 tied embedding, models/whisper.py::quantize_decoder_weights; int8
cross-KV; bf16 self-KV and activations).

The port's counterpart of whisperlive_tpu/utils/roofline.py: the cost
model is the same; the peaks are the H100's, and measure_effective_peaks
probes the card with the port's own kernels (K4 and K2), timed with CUDA
events.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

# Nominal peaks by CUDA device name (dense bf16 FLOP/s, HBM B/s), from
# NVIDIA's H100 data sheet (SXM part, without sparsity, at its full 700 W
# power limit): 989 TFLOP/s bf16 and 3.35 TB/s of HBM3.
DEVICE_PEAKS = {
    "h100 80gb hbm3": (989e12, 3.35e12),
}
DEFAULT_PEAK = (989e12, 3.35e12)

# A stream probe rotates over distinct copies of its inputs that together
# exceed the card's 50 MB L2, so each call reads HBM as the decode step does
# (its 32 layers of weights and cross-KV never fit the L2)
COLD_BYTES = 64 << 20


def nominal_peaks(device_kind: str) -> tuple[float, float]:
    """(peak bf16 FLOP/s, peak HBM B/s) for a device name
    (torch.cuda.get_device_name)."""
    kind = device_kind.lower()
    for key, peaks in DEVICE_PEAKS.items():
        if key in kind:
            return peaks
    return DEFAULT_PEAK


def effective_peaks() -> tuple[float, float]:
    """The peaks step_time_roof falls back on without measured envelopes:
    the H100's nominal ones, unless WL_EFFECTIVE_TFLOPS /
    WL_EFFECTIVE_HBM_GBPS override them."""
    tf = float(os.environ.get("WL_EFFECTIVE_TFLOPS", str(DEFAULT_PEAK[0] / 1e12))) * 1e12
    bw = float(os.environ.get("WL_EFFECTIVE_HBM_GBPS", str(DEFAULT_PEAK[1] / 1e9))) * 1e9
    return tf, bw


def _rate(fn: Callable[[int], Any], device: torch.device, iters: int,
          work_per_call: float) -> float:
    """Units of work a second: `work_per_call` over the device time of one
    fn(i) call, from `iters` calls in a row (after a warm-up call). On a
    card the calls queue behind a spin kernel, so the CUDA events bound
    device work only, not the host's launch overhead; on the CPU the host
    clock times the calls, which run as they are issued."""
    fn(0)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        return iters * work_per_call / (time.perf_counter() - t0)
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms of GPU cycles: the host enqueues every call
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return iters * work_per_call / (start.elapsed_time(end) / 1e3)


def measure_effective_peaks(
    device: str | torch.device = "cuda",
    iters: int = 6,
    seconds_budget: float = 90.0,
    n: int = 4096,
    chain: int = 8,
    kv_shape: tuple[int, int, int, int] = (16, 20, 2048, 64),
    inner: int = 16,
    self_shape: tuple[int, int, int, int] | None = None,
) -> dict:
    """Measure the card's effective envelopes with the decode step's own
    op shapes. Probes:

      * tflops — chains of `chain` bf16 [n, n] matmuls
      * int8_gbps / int8_geps — the decode step's dominant int8 read: K4
        (ops/attention.py cross_attention_int8) over packed int8 K|V at
        `kv_shape`, `inner` launches a call
      * bf16_gbps / bf16_geps — the step's bf16 self-KV read pattern:
        single-query attention over bf16 K and V in plain torch, at
        `self_shape` (defaults to kv_shape)
      * int8_mm_gbps — the weight stream: K2 (ops/quant_matmul.py
        int8_matmul) at the decode step's M = 16 over a [1280, 5120] int8
        weight

    Callers pass the kv_shape their step streams: the rate of a small
    cross-KV slab differs from a large one's. The stream probes rotate
    over input copies beyond the L2 (COLD_BYTES). A probe stops the
    measurement early once `seconds_budget` has passed, returning the
    envelopes measured so far; a probe that fails raises (a kernel that
    does not launch must not hide behind effective_peaks' fallback). On
    CPU tensors the probes run the kernels' plain versions, as every
    wrapper does, timed on the host clock."""
    from whisperlive_tpu_torch.ops import attention as attn_ops
    from whisperlive_tpu_torch.ops import quant_matmul as qmm

    dev = torch.device(device)
    t_start = time.monotonic()
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def copies(make, n_bytes: float) -> list:
        return [make() for _ in range(max(1, math.ceil(COLD_BYTES / n_bytes)))]

    out: dict = {}
    x = (randn(n, n) * n ** -0.5).to(torch.bfloat16)

    def mm(_):
        a = x
        for _ in range(chain):
            a = a @ x
        return a

    out["tflops"] = _rate(mm, dev, iters, chain * 2.0 * n ** 3) / 1e12
    if time.monotonic() - t_start > seconds_budget:
        return out

    b, h, t, hd = kv_shape
    kv_bytes = 2.0 * b * h * t * hd  # K + V, once per launch
    kvps = copies(lambda: int8(b, h, t, 2 * hd), kv_bytes)
    q1 = randn(b, h, hd).to(torch.bfloat16)

    def stream8(i):
        for j in range(inner):
            attn_ops.cross_attention_int8(q1, kvps[(i * inner + j) % len(kvps)])

    out["int8_gbps"] = _rate(stream8, dev, iters, inner * kv_bytes) / 1e9
    out["int8_geps"] = out["int8_gbps"]
    if time.monotonic() - t_start > seconds_budget:
        return out

    b, h, t, hd = self_shape or kv_shape
    kv_bytes = 2.0 * b * h * t * hd
    kvs = copies(lambda: (randn(b, h, t, hd).to(torch.bfloat16),
                          randn(b, h, t, hd).to(torch.bfloat16)), 2.0 * kv_bytes)
    q1 = randn(b, h, hd).to(torch.bfloat16)

    def stream16(i):
        for j in range(inner):
            k, v = kvs[(i * inner + j) % len(kvs)]
            s = torch.einsum("bhd,bhtd->bht", q1, k).float() * hd ** -0.5
            p = torch.softmax(s, dim=-1).to(k.dtype)
            torch.einsum("bht,bhtd->bhd", p, v)

    out["bf16_gbps"] = _rate(stream16, dev, iters, inner * kv_bytes * 2.0) / 1e9
    out["bf16_geps"] = out["bf16_gbps"] / 2.0
    if time.monotonic() - t_start > seconds_budget:
        return out

    # the int8-weight matmul at the decode step's small M: the weight
    # stream rides this kernel, not the attention kernel, at its own rate
    m, kdim, ndim = 16, 1280, 5120
    ws = copies(lambda: (int8(kdim, ndim), randn(ndim).to(torch.bfloat16)), kdim * ndim)
    xm = randn(m, kdim).to(torch.bfloat16)

    def wmm(i):
        for j in range(inner):
            w8, sc = ws[(i * inner + j) % len(ws)]
            qmm.int8_matmul(xm, w8, sc)

    out["int8_mm_gbps"] = _rate(wmm, dev, iters, inner * float(kdim * ndim)) / 1e9
    return out


def step_time_roof(step: "StepCost", peaks: dict) -> float:
    """Lower-bound seconds for ONE lockstep decode step on the MEASURED
    envelopes: max(tensor-core time, HBM stream time), charging int8 and
    bf16 traffic at their separately measured rates (conservative: assumes
    the two streams do not overlap each other). The achieved/roof fraction
    this yields is bounded by 1 whenever the probe measured a true
    envelope."""
    if not peaks or not all(
        k in peaks for k in ("tflops", "int8_gbps", "bf16_gbps")
    ):
        tf, bw = effective_peaks()
        return max(step.flops / tf, step.bytes / bw)
    t_mxu = step.flops / (peaks["tflops"] * 1e12)
    # weights ride the dequant-matmul kernel; charge them at its own
    # measured rate when probed (they are int8 whenever weight_bits=8,
    # i.e. part of int8_bytes — split them out of the attention stream)
    kv_int8 = step.int8_bytes
    t_w = 0.0
    if "int8_mm_gbps" in peaks and step.weight_stream_int8:
        kv_int8 = step.int8_bytes - step.weight_bytes
        t_w = step.weight_bytes / (peaks["int8_mm_gbps"] * 1e9)
    t_hbm = (
        t_w
        + kv_int8 / (peaks["int8_gbps"] * 1e9)
        + step.bf16_bytes / (peaks["bf16_gbps"] * 1e9)
    )
    return max(t_mxu, t_hbm)


@dataclass(frozen=True)
class StepCost:
    """Per-decode-step cost at a given batch (lockstep: one step advances
    every item one token)."""

    flops: float  # total FLOPs per step across the batch
    weight_bytes: float  # batch-shared weight reads (int8 decoder + embed)
    kv_bytes: float  # per-item KV reads (int8 cross + bf16 self), summed
    elements: float  # total HBM elements touched
    int8_bytes: float = 0.0  # dtype split of the traffic, for roofs that
    bf16_bytes: float = 0.0  # charge each stream at its measured rate
    weight_stream_int8: bool = True  # weight_bytes included in int8_bytes
    # (int8 decoder weights, the serving default) vs in bf16_bytes

    @property
    def bytes(self) -> float:
        return self.weight_bytes + self.kv_bytes


def decode_step_cost(
    cfg: Any,
    batch: int,
    cache_len: int,
    cross_ctx: int | None = None,
    cross_kv_bits: int = 8,
    weight_bits: int = 8,
) -> StepCost:
    """Cost of ONE lockstep decode step (engine.py decode step).

    cache_len: static self-KV slots (prompt_pad + gen bucket).
    cross_ctx: encoder positions resident in cross-KV (1500 full window,
    512 for reduced-context streaming tails).
    """
    T = cross_ctx or cfg.n_audio_ctx
    d = cfg.n_text_state
    L = cfg.n_text_layer
    V = cfg.n_vocab

    # matmul FLOPs per token per layer: q,k,v,o projections (4 × 2d²) +
    # MLP in/out at 4d width (2 × 2·4d²) = 24d²; attention reads:
    # QKᵀ + AV over self cache (4·cache_len·d) and cross ctx (4·T·d).
    per_item = L * (24 * d * d + 4 * cache_len * d + 4 * T * d)
    per_item += 2 * d * V  # logits matmul (tied embedding)
    flops = batch * float(per_item)

    wbits = weight_bits / 8.0
    weight_bytes = (L * 12 * d * d + V * d) * wbits
    weight_elems = L * 12 * d * d + V * d

    cross_elems = L * 2 * T * d
    self_elems = L * 2 * cache_len * d
    kv_bytes = batch * (cross_elems * cross_kv_bits / 8.0 + self_elems * 2.0)
    kv_elems = batch * (cross_elems + self_elems)

    int8_bytes = 0.0
    bf16_bytes = batch * self_elems * 2.0
    if weight_bits == 8:
        int8_bytes += float(weight_bytes)
    else:
        bf16_bytes += float(weight_bytes)
    if cross_kv_bits in (4, 8):
        int8_bytes += batch * cross_elems * cross_kv_bits / 8.0
    else:
        bf16_bytes += batch * cross_elems * 2.0

    return StepCost(
        flops=flops,
        weight_bytes=float(weight_bytes),
        kv_bytes=float(kv_bytes),
        elements=float(weight_elems + kv_elems),
        int8_bytes=float(int8_bytes),
        bf16_bytes=float(bf16_bytes),
        weight_stream_int8=(weight_bits == 8),
    )


def continuous_step_cost(
    cfg: Any,
    n_rows: int,
    cache_len: int,
    cross_positions: float,
    cross_kv_bits: int = 8,
    weight_bits: int = 8,
) -> StepCost:
    """Cost of one lockstep CONTINUOUS decode step under the length-aware
    active-slot kernel (K5): cross-KV streams only `cross_positions`
    encoder positions (summed over the occupied lane rows —
    ContinuousScheduler tick_stats step_cross_pos per tick), while weights
    and self-KV stream for the full `n_rows` pool (batch ops, no skip).
    Using the full-pool cross model here would overstate mandatory traffic
    and push the step's roofline share past 1 as soon as the kernel skips
    a row."""
    d = cfg.n_text_state
    L = cfg.n_text_layer
    V = cfg.n_vocab

    per_item = L * (24 * d * d + 4 * cache_len * d)
    per_item += 2 * d * V
    # cross_positions is already summed over active rows
    flops = n_rows * float(per_item) + L * 4 * cross_positions * d

    wbits = weight_bits / 8.0
    weight_bytes = (L * 12 * d * d + V * d) * wbits
    weight_elems = L * 12 * d * d + V * d

    cross_elems = L * 2 * cross_positions * d  # summed over active rows
    self_elems = n_rows * L * 2 * cache_len * d
    kv_bytes = cross_elems * cross_kv_bits / 8.0 + self_elems * 2.0

    int8_bytes = cross_elems * cross_kv_bits / 8.0 if cross_kv_bits in (4, 8) else 0.0
    bf16_bytes = self_elems * 2.0 + (0.0 if cross_kv_bits in (4, 8) else cross_elems * 2.0)
    if weight_bits == 8:
        int8_bytes += float(weight_bytes)
    else:
        bf16_bytes += float(weight_bytes)

    return StepCost(
        flops=float(flops),
        weight_bytes=float(weight_bytes),
        kv_bytes=float(kv_bytes),
        elements=float(weight_elems + cross_elems + self_elems),
        int8_bytes=float(int8_bytes),
        bf16_bytes=float(bf16_bytes),
        weight_stream_int8=(weight_bits == 8),
    )


def window_insert_flops(
    cfg: Any,
    batch: int,
    prompt_pad: int,
    cross_ctx: int | None = None,
) -> float:
    """FLOPs of the once-per-window insert work: conv stem + encoder +
    cross-KV projection + prompt prefill (engine.py prepare + prefill).
    Mel extraction is <1% of the encoder and is folded into the conv-stem
    term's margin."""
    T = cross_ctx or cfg.n_audio_ctx
    d = cfg.n_audio_state
    dt = cfg.n_text_state
    La, Lt = cfg.n_audio_layer, cfg.n_text_layer
    V = cfg.n_vocab

    conv = 2 * (2 * T) * 3 * cfg.n_mels * d + 2 * T * 3 * d * d
    enc_layer = 24 * T * d * d + 4 * T * T * d
    encoder = conv + La * enc_layer
    cross_proj = Lt * 2 * (2 * T * dt * dt)
    P = prompt_pad
    prefill = Lt * (24 * P * dt * dt + 4 * P * P * dt + 4 * P * T * dt)
    prefill += 2 * P * dt * V
    return batch * float(encoder + cross_proj + prefill)


def window_flops(
    cfg: Any,
    batch: int,
    prompt_pad: int,
    cache_len: int,
    new_tokens: int,
    cross_ctx: int | None = None,
    cross_kv_bits: int = 8,
) -> float:
    """Total modeled FLOPs for one window: insert + new_tokens decode steps."""
    step = decode_step_cost(
        cfg, batch, cache_len, cross_ctx=cross_ctx, cross_kv_bits=cross_kv_bits
    )
    return window_insert_flops(cfg, batch, prompt_pad, cross_ctx) + (
        step.flops * new_tokens
    )
