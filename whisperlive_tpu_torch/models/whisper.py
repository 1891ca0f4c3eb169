"""Functional PyTorch Whisper: encoder, KV-cached decoder, quantization.

Port of whisperlive_tpu/models/whisper.py over a nested dict of tensors with
the same tree as the JAX parameter pytree: per-layer parameters stacked on a
leading layer axis, linear weights stored [d_in, d_out] (applied as
x @ w), so the int8 kernels read the same bytes. Conv kernels are stored in
torch's [out, in, k] layout (models/bridge.py transposes the JAX [k, in,
out] ones).

Where the JAX code on a TPU reaches a Pallas kernel, this code calls the
wrapper of the matching CUDA kernel under the same condition: K1
fused_attention in the encoder, K2 int8_matmul for int8 linears at
M <= 512, K3 int8_matmul_t for int8 tied-embedding logits, K4
cross_attention_int8 for single-query cross-attention over int8 K|V, K5
cross_attention_int8_skip when the continuous step passes its active
rows, K6 cross_attention_int8_window (K5's window form with active rows)
for query windows of 1 < Tq <= 8 (the speculative verify), and K7 / K8
cross_attention_int4(_window) for the same over int4 K and V. The wrappers
run their plain versions only for CPU tensors. Everything else (encoder
linears, the cross-KV projection, linears at M > 512, the conv stem,
self-attention, cross-attention of prompt-bucket prefills) is plain
PyTorch, as the JAX package leaves it to XLA.

Under tensor parallelism (cfg.tp > 1, parallel/mesh.py) a rank holds its
slice of the heads and MLP units: every function here runs unchanged on
the slice, the head axis of the caches and cross-KV is this rank's, and
the output projection and fc2 all-reduce their partial sums over the
model group before their bias. The logits stay whole: the tied embedding
is on every rank, so every rank samples the same token.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from whisperlive_tpu_torch.ops.attention import (
    MAX_WINDOW,
    NEG_INF,
    cross_attention_int4,
    cross_attention_int4_window,
    cross_attention_int8,
    cross_attention_int8_window,
    fused_attention,
    pack_int4,
    unpack_int4,
)
from whisperlive_tpu_torch.ops.quant_matmul import int8_matmul, int8_matmul_t
from whisperlive_tpu_torch.parallel import mesh as pmesh

Params = dict[str, Any]  # nested dict of tensors

# int8 linears go through the K2 kernel up to this many rows (the JAX gate,
# whisperlive_tpu/models/whisper.py _linear)
INT8_KERNEL_MAX_M = 512


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Whisper architecture hyperparameters (openai names)."""

    n_mels: int = 80
    n_vocab: int = 51865
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    dtype: torch.dtype = torch.float32  # compute dtype for matmuls
    # tensor-parallel degree: a rank of a tp group holds n_head / tp heads
    # and 4d / tp MLP units (parallel/mesh.py slices the weights) and
    # all-reduces the row-parallel partial sums over its model group
    tp: int = 1

    @property
    def head_dim(self) -> int:
        return self.n_text_state // self.n_text_head

    @property
    def audio_head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def text_heads(self) -> int:
        """Decoder heads this rank holds (the self- and cross-KV head axis)."""
        return self.n_text_head // self.tp

    def replace(self, **kw) -> "WhisperConfig":
        return dataclasses.replace(self, **kw)


WHISPER_CONFIGS: dict[str, WhisperConfig] = {
    "tiny": WhisperConfig(80, 51865, 1500, 384, 6, 4, 448, 384, 6, 4),
    "tiny.en": WhisperConfig(80, 51864, 1500, 384, 6, 4, 448, 384, 6, 4),
    "base": WhisperConfig(80, 51865, 1500, 512, 8, 6, 448, 512, 8, 6),
    "base.en": WhisperConfig(80, 51864, 1500, 512, 8, 6, 448, 512, 8, 6),
    "small": WhisperConfig(80, 51865, 1500, 768, 12, 12, 448, 768, 12, 12),
    "small.en": WhisperConfig(80, 51864, 1500, 768, 12, 12, 448, 768, 12, 12),
    "medium": WhisperConfig(80, 51865, 1500, 1024, 16, 24, 448, 1024, 16, 24),
    "medium.en": WhisperConfig(80, 51864, 1500, 1024, 16, 24, 448, 1024, 16, 24),
    "large-v1": WhisperConfig(80, 51865, 1500, 1280, 20, 32, 448, 1280, 20, 32),
    "large-v2": WhisperConfig(80, 51865, 1500, 1280, 20, 32, 448, 1280, 20, 32),
    "large-v3": WhisperConfig(128, 51866, 1500, 1280, 20, 32, 448, 1280, 20, 32),
    "large-v3-turbo": WhisperConfig(128, 51866, 1500, 1280, 20, 32, 448, 1280, 20, 4),
    "distil-small.en": WhisperConfig(80, 51864, 1500, 768, 12, 12, 448, 768, 12, 4),
    "distil-medium.en": WhisperConfig(80, 51864, 1500, 1024, 16, 24, 448, 1024, 16, 2),
    "distil-large-v2": WhisperConfig(80, 51865, 1500, 1280, 20, 32, 448, 1280, 20, 2),
    "distil-large-v3": WhisperConfig(128, 51866, 1500, 1280, 20, 32, 448, 1280, 20, 2),
}
WHISPER_CONFIGS["turbo"] = WHISPER_CONFIGS["large-v3-turbo"]


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Sinusoidal position embedding (whisper encoder convention)."""
    assert channels % 2 == 0
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Parameter init (random; the repo holds no checkpoint)
# ---------------------------------------------------------------------------


def init_params(
    cfg: WhisperConfig,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> Params:
    """Random parameters with the tree the JAX init_params emits, drawn on
    `device` from one seeded torch.Generator (so the numbers differ from
    JAX's; the tests carry JAX weights over with models/bridge.py)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        # drawn in f32 one tensor at a time, then cast: bounded extra memory
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ln(n_layer, d):
        shape = (n_layer, d) if n_layer else (d,)
        return {"scale": torch.ones(shape, device=dev), "bias": torch.zeros(shape, device=dev)}

    def linear(n_layer, d_in, d_out, bias=True):
        p = {"w": normal((n_layer, d_in, d_out), d_in**-0.5)}
        if bias:
            p["b"] = zeros(n_layer, d_out)
        return p

    def attn(n_layer, d):
        return {
            "q": linear(n_layer, d, d),
            "k": linear(n_layer, d, d, bias=False),
            "v": linear(n_layer, d, d),
            "o": linear(n_layer, d, d),
        }

    def blocks(n_layer, d, cross):
        p = {
            "attn": attn(n_layer, d),
            "attn_ln": ln(n_layer, d),
            "mlp": {"fc1": linear(n_layer, d, 4 * d), "fc2": linear(n_layer, 4 * d, d)},
            "mlp_ln": ln(n_layer, d),
        }
        if cross:
            p["cross_attn"] = attn(n_layer, d)
            p["cross_attn_ln"] = ln(n_layer, d)
        return p

    d, dd = cfg.n_audio_state, cfg.n_text_state
    return {
        "encoder": {
            "conv1": {"w": normal((d, cfg.n_mels, 3), 0.05), "b": zeros(d)},
            "conv2": {"w": normal((d, d, 3), 0.05), "b": zeros(d)},
            "pos": torch.from_numpy(sinusoids(cfg.n_audio_ctx, d)).to(dev),
            "layers": blocks(cfg.n_audio_layer, d, cross=False),
            "ln_post": ln(0, d),
        },
        "decoder": {
            "embed": normal((cfg.n_vocab, dd), 0.02),
            "pos": normal((cfg.n_text_ctx, dd), 0.01),
            "layers": blocks(cfg.n_text_layer, dd, cross=True),
            "ln": ln(0, dd),
        },
    }


def layer(tree: Any, i: int) -> Any:
    """Slice layer i out of a stacked [L, ...] parameter or cache tree."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return None if tree is None else tree[i]


def tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def _layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * p["scale"] + p["bias"]).to(x.dtype)


def _linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    if "w8" in p:
        shape = x.shape
        m = math.prod(shape[:-1])
        if m <= INT8_KERNEL_MAX_M:
            out = int8_matmul(
                x.reshape(-1, shape[-1]).contiguous(), p["w8"], p["s"], out_dtype=x.dtype
            ).reshape(*shape[:-1], p["w8"].shape[-1])
        else:
            # big-M single-use products (the cross-KV projection at
            # M = B*1500): one dequant, then a plain matmul
            out = (x @ p["w8"].to(x.dtype)) * p["s"].to(x.dtype)
    else:
        out = x @ p["w"].to(x.dtype)
    if "b" in p:
        out = out + p["b"].to(x.dtype)
    return out


def _embed_lookup(p: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Token-embedding rows, dequantizing int8 embeddings."""
    tokens = tokens.long()
    if "embed8" in p:
        rows = p["embed8"][tokens].to(dtype)
        return rows * p["embed_s"][tokens][..., None].to(dtype)
    return p["embed"].to(dtype)[tokens]


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head)


def _split_head_dim(x: torch.Tensor, hd: int) -> torch.Tensor:
    """[B, T, h * hd] -> [B, T, h, hd]: as many heads as x's width holds,
    all of them or a tensor-parallel rank's share."""
    b, t, d = x.shape
    return x.reshape(b, t, d // hd, hd)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, hd = x.shape
    return x.reshape(b, t, h * hd)


def _attention(q, k, v, mask=None, return_probs=False):
    """q, k, v [B, T, H, hd]; mask broadcastable to [B, H, Tq, Tk]; f32
    scores and softmax, probabilities cast to q's dtype. return_probs: also
    return the probabilities [B, H, Tq, Tk]."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd**-0.5
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return (out, probs) if return_probs else out


def _to_model(x: torch.Tensor, tp: int) -> torch.Tensor:
    """The input of a column-parallel block: f (identity forward, gradient
    all-reduced over the model group) under tensor parallelism."""
    return x if tp == 1 else pmesh.copy_to_model(x)


def _row_linear(x: torch.Tensor, p: Params, tp: int) -> torch.Tensor:
    """A row-parallel linear (o, fc2): under tensor parallelism x holds this
    rank's share of the input features and the weight its rows, so the
    product is a partial sum; the model group adds them up (g) and the
    bias is added once, after the reduce."""
    if tp == 1:
        return _linear(x, p)
    out = pmesh.reduce_from_model(_linear(x, {k: v for k, v in p.items() if k != "b"}))
    return out + p["b"].to(x.dtype) if "b" in p else out


def _mlp(x: torch.Tensor, p: Params, tp: int = 1) -> torch.Tensor:
    h = F.gelu(_linear(_to_model(x, tp), p["fc1"]), approximate="none")
    return _row_linear(h, p["fc2"], tp)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _conv1d(x: torch.Tensor, p: Params, stride: int) -> torch.Tensor:
    # x [B, T, C] features-last; weight [out, in, k]; padding 1 like the JAX
    # conv with padding [(1, 1)]
    y = F.conv1d(x.transpose(1, 2), p["w"].to(x.dtype), p["b"].to(x.dtype),
                 stride=stride, padding=1)
    return y.transpose(1, 2)


def _self_attention(x: torch.Tensor, p: Params, hd: int, attend, tp: int = 1) -> torch.Tensor:
    """The q, k, v projections of x into heads of hd channels, attend(q, k,
    v) and the output projection (this rank's heads under tensor
    parallelism)."""
    x = _to_model(x, tp)
    q = _split_head_dim(_linear(x, p["q"]), hd)
    k = _split_head_dim(_linear(x, p["k"]), hd)
    v = _split_head_dim(_linear(x, p["v"]), hd)
    return _row_linear(_merge_heads(attend(q, k, v)), p["o"], tp)


def _encoder_stem(p: Params, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """The two convolutions and the position table: mel [B, T_mel, n_mels]
    -> [B, T_mel/2, d]."""
    x = mel.to(cfg.dtype)
    x = F.gelu(_conv1d(x, p["conv1"], 1), approximate="none")
    x = F.gelu(_conv1d(x, p["conv2"], 2), approximate="none")
    return x + p["pos"][: x.shape[1]].to(cfg.dtype)


def _encoder_block(x: torch.Tensor, lp: Params, hd: int, attend, tp: int = 1) -> torch.Tensor:
    x = x + _self_attention(_layer_norm(x, lp["attn_ln"]), lp["attn"], hd, attend, tp)
    return x + _mlp(_layer_norm(x, lp["mlp_ln"]), lp["mlp"], tp)


def encode(params: Params, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T_mel, n_mels] -> encoder states [B, T_mel/2, d]; the
    self-attention of every layer is the K1 kernel."""
    p = params["encoder"]
    x = _encoder_stem(p, cfg, mel)
    for i in range(cfg.n_audio_layer):
        x = _encoder_block(x, layer(p["layers"], i), cfg.audio_head_dim, fused_attention,
                           cfg.tp)
    return _layer_norm(x, p["ln_post"])


# ---------------------------------------------------------------------------
# Cross-KV
# ---------------------------------------------------------------------------


def compute_cross_kv(params: Params, cfg: WhisperConfig, enc: torch.Tensor) -> Params:
    """Per-layer cross-attention K, V: {"kv": [L, 2, B, T, H, hd], "scale": None}
    (H: this rank's heads under tensor parallelism)."""
    kvs = []
    for i in range(cfg.n_text_layer):
        ca = layer(params["decoder"]["layers"], i)["cross_attn"]
        k = _split_head_dim(_linear(enc, ca["k"]), cfg.head_dim)
        v = _split_head_dim(_linear(enc, ca["v"]), cfg.head_dim)
        kvs.append(torch.stack([k, v]))
    return {"kv": torch.stack(kvs), "scale": None}


def quantize_cross_kv(cross_kv: Params) -> Params:
    """Cross-KV -> int8 with per-(layer, k/v, batch, head, channel) scales
    over the position axis, in the packed head-major layout
    [L, 1, B, H, T, 2*hd] (K in lanes [:hd], V in lanes [hd:]) that the JAX
    engine stores, so the two can be compared byte for byte."""
    kv = cross_kv["kv"].float()
    amax = kv.abs().amax(dim=3, keepdim=True)  # [L, 2, B, 1, H, hd]
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(kv / scale), -127, 127).to(torch.int8)
    n_l, _, b, t, h, hd = q.shape
    packed = q.permute(0, 2, 4, 3, 1, 5).reshape(n_l, b, h, t, 2 * hd)
    return {"kv8": packed[:, None], "scale": scale.to(torch.bfloat16)}


def quantize_cross_kv_int4(cross_kv: Params) -> Params:
    """Cross-KV -> int4 (two signed nibbles per int8, halves layout) with
    per-(layer, k/v, batch, head, channel) scales over the position axis:
    scale = max(amax, 1e-6) / 7, codes clipped to [-8, 7], head-major
    [L, 2, B, H, T, hd/2], as the JAX engine stores it (cross_kv_bits=4)."""
    kv = cross_kv["kv"].float()
    amax = kv.abs().amax(dim=3, keepdim=True)  # [L, 2, B, 1, H, hd]
    scale = torch.clamp(amax, min=1e-6) / 7.0
    q = torch.clamp(torch.round(kv / scale), -8, 7).to(torch.int8)
    packed = pack_int4(q).permute(0, 1, 2, 4, 3, 5).contiguous()
    return {"kv4": packed, "scale": scale.to(torch.bfloat16)}


def _cross_len_mask(t: int, cross_len: torch.Tensor | None) -> torch.Tensor | None:
    """[B] valid encoder lengths -> [B, 1, 1, T] attention mask (or None).

    A slot whose window was encoded at a reduced context occupies only the
    first cross_len positions of the shared cross-KV region; the tail holds
    stale data from a previous occupant and must get no attention mass."""
    if cross_len is None:
        return None
    return (torch.arange(t, device=cross_len.device)[None, :] < cross_len[:, None])[
        :, None, None, :]


def _cross_attend(qc: torch.Tensor, ckv: Params, dtype: torch.dtype,
                  cross_len: torch.Tensor | None = None,
                  active: torch.Tensor | None = None, collect_probs: bool = False):
    """Cross-attention against one layer's cross-KV slice.

    qc [B, Tq, H, hd]; ckv {"kv": [2, B, T, H, hd], "scale": None},
    {"kv8": [1, B, H, T, 2*hd] int8 packed, "scale": [2, B, 1, H, hd]} or
    {"kv4": [2, B, H, T, hd/2] packed int4, "scale": [2, B, 1, H, hd]}.
    The K scales fold into q in the compute dtype and the V scales into the
    output after the cast, as in the JAX code. cross_len: optional [B] int32
    valid encoder positions (reduced-context slots). active: optional [B]
    bool, the rows whose output the caller keeps (requires cross_len); with
    int8 cross-KV, a single query with it is K5 and a window K5's window
    form, which read nothing for the other rows and return zeros there.
    Int4 takes cross_len but not active, as in the JAX code. A query of one
    token goes to K4 / K5 / K7 and a window of 1 < Tq <= 8 (the speculative
    verify) to K6 / K5's window form / K8; longer prefills dequantize and
    attend. collect_probs (the alignment pass) returns (out, probabilities
    [B, H, Tq, T]) and never takes a kernel, as in the JAX code: the int8
    or int4 cross-KV is dequantized and attended."""
    scale = ckv.get("scale")
    if active is not None and cross_len is None:
        raise ValueError("active-slot skipping requires per-slot cross_len")
    lengths = None if cross_len is None else cross_len.to(torch.int32)
    tq = qc.shape[1]
    if "kv8" in ckv or "kv4" in ckv:
        q_eff = qc * scale[0][:, 0][:, None].to(qc.dtype)
        v_scale = scale[1][:, 0][:, None]  # [B, 1, H, hd]
        if tq <= MAX_WINDOW and not collect_probs:
            if "kv8" in ckv:
                kvp = ckv["kv8"][0]  # [B, H, T, 2*hd]
                out = (cross_attention_int8(q_eff[:, 0].contiguous(), kvp, lengths, active)[:, None]
                       if tq == 1 else cross_attention_int8_window(
                           q_eff.transpose(1, 2).contiguous(), kvp, lengths, active
                       ).transpose(1, 2))
            else:
                k4, v4 = ckv["kv4"][0], ckv["kv4"][1]
                out = (cross_attention_int4(q_eff[:, 0].contiguous(), k4, v4, lengths)[:, None]
                       if tq == 1 else cross_attention_int4_window(
                           q_eff.transpose(1, 2).contiguous(), k4, v4, lengths).transpose(1, 2))
            return out.to(dtype) * v_scale.to(dtype)
        # prompt-bucket prefills (Tq = 16/64/256): dequantize and attend
        if "kv8" in ckv:
            kvp = ckv["kv8"][0]
            hd = kvp.shape[-1] // 2
            k, v = kvp[..., :hd], kvp[..., hd:]
        else:
            k, v = unpack_int4(ckv["kv4"][0]), unpack_int4(ckv["kv4"][1])
        k, v = k.transpose(1, 2).to(dtype), v.transpose(1, 2).to(dtype)
        out = _attention(q_eff, k, v, _cross_len_mask(k.shape[1], cross_len), collect_probs)
        if collect_probs:
            return out[0] * v_scale.to(out[0].dtype), out[1]
        return out * v_scale.to(out.dtype)
    if scale is not None:
        raise ValueError("unquantized cross-KV must not carry scales")
    k, v = ckv["kv"][0], ckv["kv"][1]
    return _attention(qc, k.to(dtype), v.to(dtype), _cross_len_mask(k.shape[1], cross_len),
                      collect_probs)


# ---------------------------------------------------------------------------
# Decoder — KV-cached, batch-uniform cache slot
# ---------------------------------------------------------------------------


def init_self_kv(cfg: WhisperConfig, batch: int, cache_len: int | None = None,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """Zeroed self-attention KV cache [L, 2, B, cache_len, H, hd] (H: this
    rank's heads under tensor parallelism)."""
    if cache_len is None:
        cache_len = cfg.n_text_ctx
    return torch.zeros(
        (cfg.n_text_layer, 2, batch, cache_len, cfg.text_heads, cfg.head_dim),
        dtype=cfg.dtype, device=device,
    )


def _decoder_block_step(x, lp, skv, ckv, slot_start: int, attn_mask, hd: int, tp: int,
                        cross_len=None, active=None, collect_probs=False):
    """One decoder layer for Tq query tokens (prefill or a verify window).
    Writes the new K/V into the cache slice `skv` [2, B, C, H, hd] IN PLACE
    at slot_start, then attends over the whole cache (the JAX code updates
    a copy first, then attends: the same order). collect_probs: return (x,
    cross-attention probabilities [B, H, Tq, Tenc])."""
    h = _layer_norm(x, lp["attn_ln"])
    q = _split_head_dim(_linear(h, lp["attn"]["q"]), hd)
    k_new = _split_head_dim(_linear(h, lp["attn"]["k"]), hd)
    v_new = _split_head_dim(_linear(h, lp["attn"]["v"]), hd)
    tq = k_new.shape[1]
    skv[0, :, slot_start : slot_start + tq] = k_new
    skv[1, :, slot_start : slot_start + tq] = v_new
    attn_out = _attention(q, skv[0], skv[1], attn_mask)
    x = x + _row_linear(_merge_heads(attn_out), lp["attn"]["o"], tp)

    h = _layer_norm(x, lp["cross_attn_ln"])
    qc = _split_head_dim(_linear(h, lp["cross_attn"]["q"]), hd)
    cross_out = _cross_attend(qc, ckv, x.dtype, cross_len, active, collect_probs)
    if collect_probs:
        cross_out, probs = cross_out
    x = x + _row_linear(_merge_heads(cross_out), lp["cross_attn"]["o"], tp)
    x = x + _mlp(_layer_norm(x, lp["mlp_ln"]), lp["mlp"], tp)
    return (x, probs) if collect_probs else x


def _decoder_forward(params, cfg, tokens, pos_idx, slot_start, attn_mask, self_kv, cross_kv,
                     cross_len=None, active=None, collect_cross_attn=False):
    """Teacher-forced pass; self_kv [L, 2, B, C, H, hd] is updated in place.
    collect_cross_attn: return (x, cross-attention maps [L, B, H, Tq, Tenc]
    in the compute dtype)."""
    p = params["decoder"]
    x = _embed_lookup(p, tokens, cfg.dtype) + p["pos"].to(cfg.dtype)[
        pos_idx.clamp(0, cfg.n_text_ctx - 1).long()
    ]
    maps = []
    for i in range(cfg.n_text_layer):
        x = _decoder_block_step(
            x, layer(p["layers"], i), self_kv[i], layer(cross_kv, i), slot_start,
            attn_mask, cfg.head_dim, cfg.tp, cross_len, active, collect_cross_attn,
        )
        if collect_cross_attn:
            x, probs = x
            maps.append(probs)
    x = _layer_norm(x, p["ln"])
    return (x, torch.stack(maps)) if collect_cross_attn else x


def _project_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Hidden states -> f32 logits via the tied token embedding (K3 for
    int8 embeddings)."""
    p = params["decoder"]
    if "embed8" in p:
        shape = x.shape
        out = int8_matmul_t(x.reshape(-1, shape[-1]).contiguous(), p["embed8"], p["embed_s"])
        return out.reshape(*shape[:-1], p["embed8"].shape[0])
    # compute-dtype operands, exact products, f32 accumulation and output
    return torch.matmul(x.float(), p["embed"].to(x.dtype).t().float())


def decode_prefill(params, cfg, tokens, prompt_len, self_kv, cross_kv, sot_idx=None):
    """Teacher-forced pass over right-padded prompts [B, P]; writes cache
    slots [0, P) of self_kv in place. Returns last_logits [B, V] at
    prompt_len-1, or (last_logits, sot_logits) when sot_idx is given."""
    b, pmax = tokens.shape
    dev = tokens.device
    pos_idx = torch.arange(pmax, device=dev)[None, :].expand(b, pmax)
    c = self_kv.shape[3]
    causal = (torch.arange(c, device=dev)[None, :] <= torch.arange(pmax, device=dev)[:, None])
    x = _decoder_forward(params, cfg, tokens, pos_idx, 0, causal[None, None], self_kv, cross_kv)
    rows = torch.arange(b, device=dev)
    last_logits = _project_logits(params, x[rows, (prompt_len - 1).clamp(min=0).long()])
    if sot_idx is None:
        return last_logits
    sot_hidden = x[rows, sot_idx.clamp(0, pmax - 1).long()]
    return last_logits, _project_logits(params, sot_hidden)


def decode_with_cross_attn(params, cfg, tokens, cross_kv, cross_len=None):
    """Teacher-forced pass over right-padded tokens [B, T] returning (logits
    [B, T, V] f32, cross-attention maps [L, B, H, T, Tenc] in the compute
    dtype): the word-alignment pass. The self-KV cache has T slots and the
    mask is causal, so a pad query sees only real tokens before it. The
    decoder linears run K2 and the logits K3; the cross-attention
    dequantizes and attends (collect_probs)."""
    b, t = tokens.shape
    dev = tokens.device
    self_kv = init_self_kv(cfg, b, t, device=dev)
    pos_idx = torch.arange(t, device=dev)[None, :].expand(b, t)
    causal = torch.arange(t, device=dev)[None, :] <= torch.arange(t, device=dev)[:, None]
    x, maps = _decoder_forward(params, cfg, tokens, pos_idx, 0, causal[None, None], self_kv,
                               cross_kv, cross_len, collect_cross_attn=True)
    return _project_logits(params, x), maps


def decode_window(params, cfg, tokens, pos_idx, slot_start: int, prompt_len, prompt_pad: int,
                  self_kv, cross_kv):
    """Multi-token decode pass, the speculative verify: the K window tokens
    [B, K] are written at cache slots [slot_start, slot_start + K) IN PLACE
    and logits [B, K, V] f32 are returned for all of them. Query i attends
    the prompt, every generation slot before slot_start and the window
    causally (j <= slot_start + i): slot validity is purely mask-based, so
    rejected columns of an earlier round need no rollback, the next window
    overwrites them."""
    b, kwin = tokens.shape
    dev = tokens.device
    j = torch.arange(self_kv.shape[3], device=dev)[None, None, :]
    i = torch.arange(kwin, device=dev)[None, :, None]
    mask = (j < prompt_len[:, None, None]) | ((j >= prompt_pad) & (j <= slot_start + i))
    return decode_window_masked(params, cfg, tokens, pos_idx, slot_start, mask, self_kv, cross_kv)


def decode_window_masked(params, cfg, tokens, pos_idx, slot_start: int, mask, self_kv, cross_kv,
                         cross_len=None, active=None):
    """decode_window with a caller-supplied [B, K, C] mask over cache slots,
    the continuous verify: query i must be given its own in-window causal
    columns by the caller (the window's K/V are in the cache before
    attention). cross_len and active as in decode_step_masked; with int8
    cross-KV the window's cross-attention is K5's window form. Returns
    logits [B, K, V] f32."""
    x = _decoder_forward(params, cfg, tokens, pos_idx, slot_start, mask[:, None], self_kv,
                         cross_kv, cross_len, active)
    return _project_logits(params, x)


def decode_step(params, cfg, token, pos, slot: int, prompt_len, prompt_pad: int, self_kv,
                cross_kv):
    """Single autoregressive step with a batch-uniform cache slot. Valid
    slots for item b: [0, prompt_len[b]) plus [prompt_pad, slot). Returns
    logits [B, V]; self_kv gains this step's K/V at `slot` in place."""
    j = torch.arange(self_kv.shape[3], device=token.device)[None, :]
    mask = (j < prompt_len[:, None]) | ((j >= prompt_pad) & (j < slot))
    return decode_step_masked(params, cfg, token, pos, slot, mask, self_kv, cross_kv)


def decode_step_masked(params, cfg, token, pos, slot: int | torch.Tensor, mask, self_kv,
                       cross_kv, cross_len=None, active=None):
    """decode_step with a caller-supplied [B, C] mask over cache slots.

    As in the JAX code, the cache and this step's new K are scored as
    separate columns, and the new K/V are written to `slot` only after the
    layer has run (here in place on self_kv). `slot` is a host int, or a
    [1] int64 tensor on the cache's device (the continuous pool's captured
    step, whose column lives on the card): the same write through
    index_copy_, with no copy to the host. cross_len [B] masks each row's
    stale cross-KV tail; active [B] marks the rows whose output the caller
    keeps (the continuous step's write mask): with int8 cross-KV, the
    cross-attention of the other rows reads nothing (K5)."""
    p = params["decoder"]
    x = _embed_lookup(p, token[:, None], cfg.dtype) + p["pos"].to(cfg.dtype)[
        pos[:, None].clamp(0, cfg.n_text_ctx - 1).long()
    ]  # [B, 1, d]
    c = self_kv.shape[3]
    mask = mask[:, None, None, :]  # [B, 1, 1, C]
    hd, tp = cfg.head_dim, cfg.tp
    for i in range(cfg.n_text_layer):
        lp = layer(p["layers"], i)
        skv = self_kv[i]
        h = _layer_norm(x, lp["attn_ln"])
        q = _split_head_dim(_linear(h, lp["attn"]["q"]), hd)  # [B, 1, H, hd]
        k_new = _split_head_dim(_linear(h, lp["attn"]["k"]), hd)
        v_new = _split_head_dim(_linear(h, lp["attn"]["v"]), hd)
        qf = q.float()
        sc_cache = torch.einsum("bqhd,bkhd->bhqk", qf, skv[0].float()) * hd**-0.5
        sc_cache = torch.where(mask, sc_cache, NEG_INF)
        sc_new = torch.einsum("bqhd,bkhd->bhqk", qf, k_new.float()) * hd**-0.5
        probs = torch.softmax(torch.cat([sc_cache, sc_new], dim=-1), dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs[..., :c], skv[1]) + torch.einsum(
            "bhqk,bkhd->bqhd", probs[..., c:], v_new
        )
        x = x + _row_linear(_merge_heads(out), lp["attn"]["o"], tp)

        h = _layer_norm(x, lp["cross_attn_ln"])
        qc = _split_head_dim(_linear(h, lp["cross_attn"]["q"]), hd)
        cross_out = _cross_attend(qc, layer(cross_kv, i), x.dtype, cross_len, active)
        x = x + _row_linear(_merge_heads(cross_out), lp["cross_attn"]["o"], tp)
        x = x + _mlp(_layer_norm(x, lp["mlp_ln"]), lp["mlp"], tp)

        if isinstance(slot, torch.Tensor):
            skv[0].index_copy_(1, slot, k_new)
            skv[1].index_copy_(1, slot, v_new)
        else:
            skv[0, :, slot] = k_new[:, 0]
            skv[1, :, slot] = v_new[:, 0]
    x = _layer_norm(x, p["ln"])
    return _project_logits(params, x[:, 0])


# ---------------------------------------------------------------------------
# Weight quantization and casting
# ---------------------------------------------------------------------------


def quantize_decoder_weights(params: Params) -> Params:
    """Weight-only int8 of the decoder's linears (per-output-channel scales)
    and of the tied embedding (per-row scales); scales stored bf16, the
    encoder and LayerNorms untouched."""

    def quant(node):
        if isinstance(node, dict) and "w" in node:
            w = node["w"].float()  # [L, d_in, d_out]
            s = torch.clamp(w.abs().amax(dim=-2, keepdim=True), min=1e-8) / 127.0
            out = {
                "w8": torch.clamp(torch.round(w / s), -127, 127).to(torch.int8),
                "s": s.squeeze(-2).to(torch.bfloat16),
            }
            if "b" in node:
                out["b"] = node["b"]
            return out
        if isinstance(node, dict):
            return {k: quant(v) for k, v in node.items()}
        return node

    dec = params["decoder"]
    embed = dec["embed"].float()  # [V, d]
    e_s = torch.clamp(embed.abs().amax(dim=1), min=1e-8) / 127.0
    new_dec = {k: v for k, v in dec.items() if k != "embed"}
    new_dec["layers"] = quant(dec["layers"])
    new_dec["embed8"] = torch.clamp(torch.round(embed / e_s[:, None]), -127, 127).to(torch.int8)
    new_dec["embed_s"] = e_s.to(torch.bfloat16)
    return {"encoder": params["encoder"], "decoder": new_dec}


def dequantize_decoder_weights(params: Params, dtype: torch.dtype = torch.float32) -> Params:
    """Inverse of quantize_decoder_weights: dense decoder weights carrying
    exactly the values the int8 kernels dequantize to (w8 * s per output
    channel, embed8 * embed_s per row, in float32, then cast to `dtype`;
    biases kept), so that the training forwards reproduce the int8 serving
    decoder's numerics. A tree that is not quantized is returned as is."""
    dec = params["decoder"]
    if "embed8" not in dec:
        return params

    def deq(node):
        if isinstance(node, dict) and "w8" in node:
            out = {"w": (node["w8"].float() * node["s"].float()[..., None, :]).to(dtype)}
            if "b" in node:
                out["b"] = node["b"]
            return out
        if isinstance(node, dict):
            return {k: deq(v) for k, v in node.items()}
        return node

    new_dec = {k: v for k, v in dec.items() if k not in ("embed8", "embed_s")}
    new_dec["layers"] = deq(dec["layers"])
    new_dec["embed"] = (dec["embed8"].float() * dec["embed_s"].float()[:, None]).to(dtype)
    return {"encoder": params["encoder"], "decoder": new_dec}


def cast_params(params: Params, dtype: torch.dtype, device: torch.device | str) -> Params:
    """Move to `device`; matmul weights to `dtype`, LayerNorm params f32,
    int8 weights int8 and their scales bf16."""

    def cast(name, x):
        if name in ("scale", "bias"):
            return x.to(device=device, dtype=torch.float32)
        if name in ("w8", "embed8"):
            return x.to(device=device)
        if name in ("s", "embed_s"):
            return x.to(device=device, dtype=torch.bfloat16)
        return x.to(device=device, dtype=dtype)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else cast(k, v) for k, v in tree.items()}

    return walk(params)
