"""M2M100/SMALL100, the translation model, as plain PyTorch functions.

The port of whisperlive_tpu/models/m2m100.py: functions on tensors over a
parameter dict (the layout of the Whisper tree: stacked [L, ...] layers),
on the device the parameters lie on. Architecture (HF
M2M100ForConditionalGeneration conventions):

  * shared token embedding scaled by sqrt(d_model); tied lm_head
  * fairseq-style sinusoidal positions with offset 2 (padding_idx = 1,
    unpadded position i embeds as table[i + 2])
  * pre-norm transformer, ReLU MLP, all attention projections biased
  * final layer_norm on both encoder and decoder

Attention and the linears are the plain ones of models/whisper.py (f32
scores and softmax); the JAX model computes them outside any Pallas kernel
too. Generation loops on the host: the check that every row (or every
item's beam pool) is done is its only per-token host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from whisperlive_tpu_torch.models import convert
from whisperlive_tpu_torch.models.whisper import (
    _attention,
    _layer_norm,
    _linear,
    _merge_heads,
    _split_heads,
    layer,
    tree_map,
)
from whisperlive_tpu_torch.ops.decoding import top_k

Params = Any

_NEG = float(np.finfo(np.float32).min) / 4  # headroom for score arithmetic


@dataclasses.dataclass(frozen=True)
class M2M100Config:
    vocab_size: int = 128112
    d_model: int = 1024
    encoder_layers: int = 12
    decoder_layers: int = 12
    heads: int = 16
    ffn_dim: int = 4096
    max_positions: int = 1024
    pad_token_id: int = 1
    eos_token_id: int = 2
    dtype: torch.dtype = torch.float32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def config_from_hf(hf: Mapping[str, Any]) -> M2M100Config:
    return M2M100Config(
        vocab_size=hf["vocab_size"],
        d_model=hf["d_model"],
        encoder_layers=hf["encoder_layers"],
        decoder_layers=hf["decoder_layers"],
        heads=hf["encoder_attention_heads"],
        ffn_dim=hf["encoder_ffn_dim"],
        max_positions=hf.get("max_position_embeddings", 1024),
        pad_token_id=hf.get("pad_token_id", 1),
        eos_token_id=hf.get("eos_token_id", 2),
    )


def sinusoidal_positions(n_positions: int, dim: int, padding_idx: int = 1) -> np.ndarray:
    """fairseq/M2M100 sinusoid table (cat[sin, cos], padding row zeroed)."""
    half = dim // 2
    emb = np.log(10000.0) / (half - 1)
    freqs = np.exp(np.arange(half) * -emb)
    args = np.arange(n_positions)[:, None] * freqs[None, :]
    table = np.concatenate([np.sin(args), np.cos(args)], axis=1)
    if dim % 2:
        table = np.concatenate([table, np.zeros((n_positions, 1))], axis=1)
    table[padding_idx] = 0.0
    return table.astype(np.float32)


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------


def params_from_state_dict(sd: Mapping[str, Any], cfg: M2M100Config) -> Params:
    """An HF M2M100ForConditionalGeneration state dict (`model.`-prefixed
    or bare) -> the parameter tree, through the Whisper converter's block
    helpers with the k-projection bias. Leaves keep the checkpoint's dtype."""
    sd = dict(sd)
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}

    def side(name: str, n_layers: int, cross: bool) -> Params:
        return {
            "layers": convert._stack([convert._block(sd, f"{name}.layers.{i}", cross=cross,
                                                     k_bias=True) for i in range(n_layers)]),
            "ln": convert._ln(sd, f"{name}.layer_norm"),
        }

    return {
        "embed": convert._t(sd["shared.weight"]),
        "pos": torch.from_numpy(
            sinusoidal_positions(cfg.max_positions + 2, cfg.d_model, cfg.pad_token_id)),
        "encoder": side("encoder", cfg.encoder_layers, cross=False),
        "decoder": side("decoder", cfg.decoder_layers, cross=True),
    }


def cast_params(params: Params, dtype: torch.dtype, device: torch.device | str) -> Params:
    """Every leaf to `dtype` on `device` (the JAX translator casts the whole
    tree to bf16 on its accelerator)."""
    return tree_map(lambda t: t.to(device=device, dtype=dtype), params)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _self_qkv(h: torch.Tensor, p: Params, heads: int):
    return (_split_heads(_linear(h, p["q"]), heads), _split_heads(_linear(h, p["k"]), heads),
            _split_heads(_linear(h, p["v"]), heads))


def _mlp_residual(x: torch.Tensor, lp: Params) -> torch.Tensor:
    h = _layer_norm(x, lp["mlp_ln"])
    return x + _linear(torch.relu(_linear(h, lp["mlp"]["fc1"])), lp["mlp"]["fc2"])


def _block(x, lp, heads, mask=None, enc=None, enc_mask=None):
    q, k, v = _self_qkv(_layer_norm(x, lp["attn_ln"]), lp["attn"], heads)
    x = x + _linear(_merge_heads(_attention(q, k, v, mask)), lp["attn"]["o"])
    if enc is not None:
        ca = lp["cross_attn"]
        qc = _split_heads(_linear(_layer_norm(x, lp["cross_attn_ln"]), ca["q"]), heads)
        kc = _split_heads(_linear(enc, ca["k"]), heads)
        vc = _split_heads(_linear(enc, ca["v"]), heads)
        x = x + _linear(_merge_heads(_attention(qc, kc, vc, enc_mask)), ca["o"])
    return _mlp_residual(x, lp)


def _embed(params, cfg, tokens, positions):
    scale = torch.tensor(np.sqrt(cfg.d_model), dtype=cfg.dtype, device=tokens.device)
    x = params["embed"].to(cfg.dtype)[tokens.long()] * scale
    # fairseq offset-2 positions for unpadded sequences
    return x + params["pos"].to(cfg.dtype)[positions.long() + 2]


def _logits(params, x):
    """Tied lm_head: compute-dtype operands, exact products, f32
    accumulation and output. On the card a bf16 GEMM writes the f32 logits
    itself, so no float32 copy of the embedding is made per step."""
    w = params["embed"].to(x.dtype)
    if x.is_cuda and x.dtype != torch.float32:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[0])
    return torch.matmul(x.float(), w.t().float())


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, device=device)[None, :].expand(b, t)


def encode(params: Params, cfg: M2M100Config, tokens: torch.Tensor,
           pad_mask: torch.Tensor | None = None) -> torch.Tensor:
    """tokens [B, T]; pad_mask [B, T] bool (True = real token). With a mask,
    padded key positions are excluded from self-attention (bucket-padded
    inputs stay numerically identical to unpadded ones)."""
    b, t = tokens.shape
    x = _embed(params, cfg, tokens, _positions(b, t, tokens.device))
    mask = None if pad_mask is None else pad_mask[:, None, None, :]
    layers = params["encoder"]["layers"]
    for i in range(cfg.encoder_layers):
        x = _block(x, layer(layers, i), cfg.heads, mask=mask)
    return _layer_norm(x, params["encoder"]["ln"])


def decode(params: Params, cfg: M2M100Config, tokens: torch.Tensor, enc: torch.Tensor,
           enc_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Teacher-forced decoder pass -> f32 logits [B, T, V]."""
    b, t = tokens.shape
    x = _embed(params, cfg, tokens, _positions(b, t, tokens.device))
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=tokens.device))[None, None]
    emask = None if enc_mask is None else enc_mask[:, None, None, :]
    layers = params["decoder"]["layers"]
    for i in range(cfg.decoder_layers):
        x = _block(x, layer(layers, i), cfg.heads, mask=causal, enc=enc, enc_mask=emask)
    return _logits(params, _layer_norm(x, params["decoder"]["ln"]))


def _compute_cross_kv(params, cfg, enc):
    """Per-layer cross K/V from the encoder output: [L, 2, B, Tsrc, H, hd]."""
    layers = params["decoder"]["layers"]
    kv = []
    for i in range(cfg.decoder_layers):
        ca = layer(layers, i)["cross_attn"]
        kv.append(torch.stack([_split_heads(_linear(enc, ca["k"]), cfg.heads),
                               _split_heads(_linear(enc, ca["v"]), cfg.heads)]))
    return torch.stack(kv)


def _cached_forward(params, cfg, tokens, pos_idx, slot: int, self_kv, cross_kv, enc_mask):
    """Decoder forward writing K/V into self_kv [L, 2, B, C, H, hd] at the
    batch-uniform cache slots slot..slot+Tq (every row of a generation
    starts from the same prefix length); returns (f32 logits, self_kv)."""
    x = _embed(params, cfg, tokens, pos_idx)
    tq = x.shape[1]
    c = self_kv.shape[3]
    causal = (torch.arange(c, device=x.device)[None, None, :] <= pos_idx[:, :, None])[:, None]
    emask = None if enc_mask is None else enc_mask[:, None, None, :]
    layers = params["decoder"]["layers"]
    for i in range(cfg.decoder_layers):
        lp = layer(layers, i)
        q, k_new, v_new = _self_qkv(_layer_norm(x, lp["attn_ln"]), lp["attn"], cfg.heads)
        self_kv[i, 0, :, slot:slot + tq] = k_new
        self_kv[i, 1, :, slot:slot + tq] = v_new
        out = _attention(q, self_kv[i, 0], self_kv[i, 1], causal)
        x = x + _linear(_merge_heads(out), lp["attn"]["o"])
        ca = lp["cross_attn"]
        qc = _split_heads(_linear(_layer_norm(x, lp["cross_attn_ln"]), ca["q"]), cfg.heads)
        out = _attention(qc, cross_kv[i, 0], cross_kv[i, 1], emask)
        x = x + _linear(_merge_heads(out), ca["o"])
        x = _mlp_residual(x, lp)
    return _logits(params, _layer_norm(x, params["decoder"]["ln"])), self_kv


def _start(params, cfg, src_tokens, forced_bos, max_new):
    """Encode, cross K/V, and the prefix pass: [eos] (SMALL100, whose target
    language rides the source) or [eos, lang] (M2M100's forced bos).
    Returns (src_mask, cross_kv, self_kv, last prefix logits [B, V], plen)."""
    b = src_tokens.shape[0]
    dev = src_tokens.device
    src_mask = src_tokens != cfg.pad_token_id
    enc = encode(params, cfg, src_tokens, pad_mask=src_mask)
    cross_kv = _compute_cross_kv(params, cfg, enc)
    hd = cfg.d_model // cfg.heads
    self_kv = torch.zeros((cfg.decoder_layers, 2, b, max_new + 2, cfg.heads, hd),
                          dtype=enc.dtype, device=dev)
    prefix = torch.full((b, 1), cfg.eos_token_id, dtype=torch.int64, device=dev)
    if forced_bos is not None:
        prefix = torch.cat([prefix, forced_bos.to(dev, torch.int64)[:, None]], dim=1)
    plen = prefix.shape[1]
    logits, self_kv = _cached_forward(params, cfg, prefix, _positions(b, plen, dev), 0,
                                      self_kv, cross_kv, src_mask)
    return src_mask, cross_kv, self_kv, logits[:, plen - 1], plen


@torch.inference_mode()
def generate_greedy(params: Params, cfg: M2M100Config, src_tokens: torch.Tensor,
                    forced_bos: torch.Tensor | None, max_new: int = 200) -> torch.Tensor:
    """KV-cached greedy generation: src_tokens [B, T_src], forced_bos [B]
    target-language ids or None (SMALL100) -> [B, max_new] int64, each row
    its tokens through eos, then pad. Stops once every row is done."""
    b = src_tokens.shape[0]
    src_mask, cross_kv, self_kv, logits, plen = _start(params, cfg, src_tokens, forced_bos,
                                                       max_new)
    buf = torch.full((b, max_new), cfg.pad_token_id, dtype=torch.int64, device=src_tokens.device)
    cur = logits.argmax(-1)
    buf[:, 0] = cur
    done = cur == cfg.eos_token_id
    i = 1
    while i < max_new and not bool(done.all()):
        pos = torch.full((b, 1), i + plen - 1, dtype=torch.int64, device=buf.device)
        logits, self_kv = _cached_forward(params, cfg, cur[:, None], pos, i + plen - 1, self_kv,
                                          cross_kv, src_mask)
        cur = torch.where(done, cfg.pad_token_id, logits[:, 0].argmax(-1))
        buf[:, i] = cur
        done = done | (cur == cfg.eos_token_id)
        i += 1
    return buf


@torch.inference_mode()
def generate_beam(params: Params, cfg: M2M100Config, src_tokens: torch.Tensor,
                  forced_bos: torch.Tensor | None, max_new: int = 200, beam_size: int = 5,
                  length_penalty: float = 1.0) -> torch.Tensor:
    """KV-cached beam search -> [B, max_new] int64 (eos-terminated,
    pad-filled).

    Hugging Face `generate()` beam semantics with early_stopping=True, the
    M2M100/SMALL100 generation-config defaults:
      * top-2K candidates per item a step; EOS candidates ranked within K
        enter the finished pool scored sum_logprobs / hyp_len**length_penalty
        (hyp_len counts the decoder prefix, not the EOS), those below K
        are dropped;
      * the K best non-EOS candidates continue (parent gather of the
        self-KV cache);
      * an item stops once its pool holds K hypotheses; the live beams of
        unfinished items enter the pool at the end;
      * output is the best pooled hypothesis per item.
    Every top-K picks the lower index among equal values, as jax.lax.top_k
    does; only lane 0 starts live, its copies at _NEG.
    """
    b = src_tokens.shape[0]
    k = beam_size
    bk = b * k
    eos, pad, v = cfg.eos_token_id, cfg.pad_token_id, cfg.vocab_size
    dev = src_tokens.device
    src_mask, cross_kv, self_kv, logits, plen = _start(params, cfg, src_tokens, forced_bos,
                                                       max_new)
    self_kv = self_kv.repeat_interleave(k, dim=2)
    cross_kv = cross_kv.repeat_interleave(k, dim=2)
    src_mask = src_mask.repeat_interleave(k, dim=0)
    logits = logits.repeat_interleave(k, dim=0)  # [BK, V]
    lane0 = torch.tensor([0.0] + [_NEG] * (k - 1), dtype=torch.float32, device=dev)
    sum_lp = lane0.repeat(b)
    buf = torch.full((bk, max_new), pad, dtype=torch.int64, device=dev)
    pool_scores = torch.full((b, k), _NEG, dtype=torch.float32, device=dev)
    pool_toks = torch.full((b, k, max_new), pad, dtype=torch.int64, device=dev)
    item_done = torch.zeros(b, dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    col = torch.arange(max_new, device=dev)[None, None, :]
    first_k = torch.arange(2 * k, device=dev)[None, :] < k

    def pool_insert(pool_scores, pool_toks, cand_scores, cand_toks, allow):
        """The best K of pool ++ candidates (cand_scores [B, C], cand_toks
        [B, C, L]; _NEG where not allowed)."""
        all_scores = torch.cat([pool_scores, torch.where(allow, cand_scores, _NEG)], dim=1)
        top, idx = top_k(all_scores, k)
        return top, torch.cat([pool_toks, cand_toks], dim=1)[rows, idx]

    i = 0
    while i < max_new and not bool(item_done.all()):
        lp = torch.log_softmax(logits.float(), dim=-1)
        scores2, idx2 = top_k((sum_lp[:, None] + lp).reshape(b, k * v), 2 * k)  # [B, 2K]
        parent2 = idx2 // v  # the item's lane
        tok2 = idx2 % v
        is_eos2 = tok2 == eos

        # finished-pool inserts: EOS candidates ranked within K
        allow = is_eos2 & first_k & ~item_done[:, None]
        hist2 = buf.reshape(b, k, max_new)[rows, parent2]  # [B, 2K, L]
        # a finished hypothesis ends with EOS at column i, pad after
        hist2 = torch.where(col == i, eos, torch.where(col < i, hist2, pad))
        pool_scores, pool_toks = pool_insert(
            pool_scores, pool_toks, scores2 / float(plen + i) ** length_penalty, hist2, allow)
        item_done = item_done | ((pool_scores > _NEG / 2).sum(dim=1) >= k)

        # continuing beams: the best K non-EOS of the 2K
        top_cont, cont_idx = top_k(torch.where(is_eos2, _NEG, scores2), k)
        parent_k = parent2.gather(1, cont_idx) + rows * k
        tok_k = tok2.gather(1, cont_idx)
        done_rows = item_done.repeat_interleave(k)
        parent = torch.where(done_rows, torch.arange(bk, device=dev), parent_k.reshape(bk))
        tok = torch.where(done_rows, pad, tok_k.reshape(bk))
        sum_lp = torch.where(done_rows, sum_lp, top_cont.reshape(bk))
        buf = buf[parent]
        buf[:, i] = tok
        self_kv = self_kv.index_select(2, parent)

        pos = torch.full((bk, 1), i + plen, dtype=torch.int64, device=dev)
        logits, self_kv = _cached_forward(params, cfg, tok[:, None], pos, i + plen, self_kv,
                                          cross_kv, src_mask)
        logits = logits[:, 0]
        i += 1

    # live beams of unfinished items enter the pool, scored at the final length
    live_scores = (sum_lp / float(plen + i) ** length_penalty).reshape(b, k)
    pool_scores, pool_toks = pool_insert(pool_scores, pool_toks, live_scores,
                                         buf.reshape(b, k, max_new), ~item_done[:, None])
    return pool_toks[rows[:, 0], pool_scores.argmax(dim=1)]
