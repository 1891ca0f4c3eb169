"""Whisper decoding logit rules and sampling as batched PyTorch functions.

Port of whisperlive_tpu/ops/decoding.py: the same openai-whisper rules
(suppress list, SuppressBlank, timestamp pairing and monotonicity, initial
timestamp bound, the timestamp-probability rule, CTranslate2-style
repetition penalty and no-repeat n-grams) on [B, V] logits with a small
carried state. The decode loop is driven from the host here, so the
batch-uniform `step` is a Python int; every other field is a tensor on the
engine's device. Sampling at T > 0 draws from an explicit torch.Generator.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

NEG_INF = float(torch.finfo(torch.float32).min)


@dataclasses.dataclass(frozen=True)
class DecodingSpec:
    """Decoding constants for one model/tokenizer."""

    n_vocab: int
    eot: int
    blank: int  # token id of " "
    no_speech: int
    timestamp_begin: int
    max_initial_timestamp_index: int = 50  # 1.0 s
    max_length: int = 448  # total tokens incl. prompt


class SamplerState(NamedTuple):
    """Lockstep decode state (see the JAX SamplerState).

    sampled [B, MAX_GEN] int32 (column s = step s), step int (tokens sampled
    so far, the same for every item), prompt_len / gen_len / last_ts [B]
    int32, finished [B] bool, sum_logprob [B] float32."""

    sampled: torch.Tensor
    step: int
    prompt_len: torch.Tensor
    gen_len: torch.Tensor
    last_ts: torch.Tensor
    finished: torch.Tensor
    sum_logprob: torch.Tensor


def init_sampler_state(
    spec: DecodingSpec, prompt_len: torch.Tensor, max_gen: int
) -> SamplerState:
    b, dev = prompt_len.shape[0], prompt_len.device
    return SamplerState(
        sampled=torch.zeros((b, max_gen), dtype=torch.int32, device=dev),
        step=0,
        prompt_len=prompt_len.to(torch.int32),
        gen_len=torch.zeros((b,), dtype=torch.int32, device=dev),
        last_ts=torch.full((b,), spec.timestamp_begin - 1, dtype=torch.int32, device=dev),
        finished=torch.zeros((b,), dtype=torch.bool, device=dev),
        sum_logprob=torch.zeros((b,), dtype=torch.float32, device=dev),
    )


def _col(sampled: torch.Tensor, idx: int) -> torch.Tensor:
    """Column idx, clamped into the array as jax.lax.dynamic_slice clamps
    (a speculative draft runs up to k steps past the generation budget)."""
    return sampled[:, min(max(idx, 0), sampled.shape[1] - 1)]


def apply_logit_rules(
    spec: DecodingSpec,
    logits: torch.Tensor,  # [B, V] f32
    state: SamplerState,
    suppress_mask: torch.Tensor,  # [V] bool
    timestamps_enabled: torch.Tensor,  # [B] bool
    suppress_blank: torch.Tensor | None = None,  # [B] bool; None = all True
    max_initial_ts_idx: torch.Tensor | None = None,  # [B] int; None = spec value
) -> torch.Tensor:
    """All Whisper logit filters, batched. Returns filtered logits [B, V]."""
    b, v = logits.shape
    dev = logits.device
    vocab = torch.arange(v, device=dev)[None, :]
    step = state.step

    logits = torch.where(suppress_mask[None, :], NEG_INF, logits)

    first = step == 0
    if first:
        blank_rule = (vocab == spec.blank) | (vocab == spec.eot)
        if suppress_blank is not None:
            blank_rule = blank_rule & suppress_blank[:, None]
        logits = torch.where(blank_rule, NEG_INF, logits)

    tb = spec.timestamp_begin
    last_tok = _col(state.sampled, step - 1)
    penult_tok = _col(state.sampled, step - 2)
    last_was_ts = (last_tok >= tb) & (step >= 1)
    penult_was_ts = (penult_tok >= tb) | (step < 2)

    is_ts = vocab >= tb
    is_text = vocab < spec.eot

    suppress_ts = (last_was_ts & penult_was_ts)[:, None] & is_ts
    suppress_text = (last_was_ts & ~penult_was_ts)[:, None] & is_text

    lower = torch.where(last_was_ts & ~penult_was_ts, state.last_ts, state.last_ts + 1)
    has_ts = state.last_ts >= tb
    suppress_low_ts = has_ts[:, None] & is_ts & (vocab < lower[:, None])

    if max_initial_ts_idx is None:
        init_lim = torch.full((b, 1), tb + spec.max_initial_timestamp_index, device=dev)
    else:
        init_lim = (tb + max_initial_ts_idx)[:, None]
    suppress_first = (~is_ts | (vocab > init_lim)) & first

    suppress_nots = vocab == (tb - 1)

    ts_rules = suppress_ts | suppress_text | suppress_low_ts | suppress_first | suppress_nots
    ts_rules = ts_rules & timestamps_enabled[:, None]
    no_ts = ~timestamps_enabled[:, None] & (is_ts | (vocab == tb - 1))
    logits = torch.where(ts_rules | no_ts, NEG_INF, logits)

    # if the total timestamp probability beats the best text token, the
    # sample must be a timestamp
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_logprob = torch.logsumexp(torch.where(is_ts, logprobs, NEG_INF), dim=-1)
    max_text = torch.where(is_ts, NEG_INF, logprobs).amax(dim=-1)
    force_ts = (ts_logprob > max_text) & timestamps_enabled
    return torch.where(force_ts[:, None] & ~is_ts, NEG_INF, logits)


def apply_repetition_penalty(
    logits: torch.Tensor,  # [B, V]
    state: SamplerState,
    penalty: float | torch.Tensor,  # [B] or scalar; 1.0 = disabled
    prompt_tokens: torch.Tensor | None = None,  # [B, P] left-aligned prompt ids
    prompt_len: torch.Tensor | None = None,  # [B]
) -> torch.Tensor:
    """CTranslate2-style repetition penalty over the sequence so far
    (sampled tokens plus, when given, the forced prompt prefix). A Python
    float penalty of 1.0 returns without any device work."""
    if not torch.is_tensor(penalty) and float(penalty) == 1.0:
        return logits
    b, v = logits.shape
    dev = logits.device
    penalty = torch.broadcast_to(
        torch.as_tensor(penalty, dtype=torch.float32, device=dev), (b,)
    )[:, None]
    idx = torch.arange(state.sampled.shape[1], device=dev)[None, :]
    valid = (idx < state.step).to(torch.int8).expand(b, -1)
    seen = torch.zeros((b, v), dtype=torch.int8, device=dev).scatter_reduce(
        1, state.sampled.long(), valid, reduce="amax"
    )
    if prompt_tokens is not None:
        pidx = torch.arange(prompt_tokens.shape[1], device=dev)[None, :]
        pvalid = (pidx < prompt_len[:, None]).to(torch.int8)
        seen = seen.scatter_reduce(1, prompt_tokens.long(), pvalid, reduce="amax")
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen.bool() & (penalty != 1.0), penalized, logits)


def right_align_prompt(prompt_tokens: torch.Tensor, prompt_len: torch.Tensor) -> torch.Tensor:
    """Shift each left-aligned prompt row so its real tokens end at column P;
    vacated columns hold -1 (never a vocab id)."""
    b, p = prompt_tokens.shape
    shift = (p - prompt_len)[:, None]
    src = torch.arange(p, device=prompt_tokens.device)[None, :] - shift
    out = torch.gather(prompt_tokens, 1, src.clamp(0, p - 1).long())
    return torch.where(src >= 0, out, -1)


def apply_no_repeat_ngram(
    logits: torch.Tensor,  # [B, V]
    state: SamplerState,
    n: int,  # ngram size (0 disables)
    prompt_hist: torch.Tensor | None = None,  # [B, P] right_align_prompt output
) -> torch.Tensor:
    """Ban tokens that would complete an already-seen n-gram
    (CTranslate2's no_repeat_ngram_size), over prompt + sampled tokens."""
    if n <= 0:
        return logits
    b, v = logits.shape
    dev = logits.device
    g = state.sampled.shape[1]
    if g < n and prompt_hist is None:
        return logits
    s = state.step
    if prompt_hist is None:
        hist = state.sampled
        p = 0
        start0 = torch.zeros((b,), dtype=torch.int32, device=dev)
    else:
        hist = torch.cat([prompt_hist.to(state.sampled.dtype), state.sampled], dim=1)
        p = prompt_hist.shape[1]
        start0 = (p - (prompt_hist >= 0).sum(dim=1)).to(torch.int32)
    h = hist.shape[1]
    if h < n:
        return logits
    end = p + s
    c0 = min(max(end - (n - 1), 0), h - (n - 1))  # dynamic_slice clamps the start
    ctx = hist[:, c0 : c0 + n - 1]  # [B, n-1]
    windows = hist.unfold(1, n - 1, 1)[:, : h - n + 1]  # [B, W, n-1]
    next_toks = hist[:, n - 1 :]  # [B, W]
    w_start = torch.arange(h - n + 1, device=dev)
    valid = (w_start[None, :] >= start0[:, None]) & ((w_start[None, :] + n - 1) < end)
    match = (windows == ctx[:, None, :]).all(dim=-1) & valid
    ban = torch.zeros((b, v), dtype=torch.int8, device=dev).scatter_reduce(
        1, next_toks.clamp(min=0).long(), match.to(torch.int8), reduce="amax"
    )
    active = (end - start0) >= (n - 1)
    return torch.where(ban.bool() & active[:, None], NEG_INF, logits)


def sample_next(
    logits: torch.Tensor,  # [B, V] post-rules
    temperature: torch.Tensor,  # [B] — 0.0 means greedy
    generator: torch.Generator,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy/temperature sampling. Returns (next_token [B] int32, logprob [B])."""
    greedy = torch.argmax(logits, dim=-1)  # first maximum, as jnp.argmax
    # greedy rows divide by 1 here: their draw is discarded below
    t = torch.where(temperature > 0, temperature, 1.0)[:, None]
    probs = torch.softmax(logits / t, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    next_tok = torch.where(temperature > 0, sampled, greedy).to(torch.int32)
    logprobs = torch.log_softmax(logits, dim=-1)
    lp = logprobs.gather(1, next_tok.long()[:, None])[:, 0]
    return next_tok, lp


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k along the last axis: the k largest values in
    descending order, the lower index first among equal values (torch.topk
    promises no order for ties). Returns (values, indices int64)."""
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    above = x > kth
    tie = x == kth
    need = k - above.sum(dim=-1, keepdim=True)
    take = above | (tie & (torch.cumsum(tie.to(torch.int32), dim=-1) <= need))
    n = x.shape[-1]
    # exactly k taken per row: rank them lower index first (unique keys)
    key = torch.where(take, n - torch.arange(n, device=x.device), 0)
    idx = torch.topk(key, k, dim=-1).indices
    vals = x.gather(-1, idx)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return vals.gather(-1, order), idx.gather(-1, order)


def beam_select(
    filtered: torch.Tensor,  # [B*K, V] rule-filtered logits, K contiguous lanes an item
    sum_lp: torch.Tensor,  # [B*K] f32 cumulative scores
    finished: torch.Tensor,  # [B*K] bool
    first: torch.Tensor | None,  # [B*K] bool: copies of lane 0 before the first expansion
    k: int,
    eot: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One beam expansion: f32 log-softmax, finished lanes frozen (they
    propose only EOT, at an unchanged score), the `first` rows suppressed
    so that an item's first expansion draws K distinct tokens from lane 0,
    and top-K over K*V per item in jax.lax.top_k's order. The JAX window
    loop adds NEG_INF for the suppression where the JAX pool sets it; both
    leave lane 0's V candidates above every suppressed one, so the top-K is
    the same. Returns (parent [B*K] int64, the row each new lane continues;
    tok [B*K] int32; scores [B*K] f32, absolute cumulative)."""
    lp = torch.log_softmax(filtered.float(), dim=-1)
    frozen = torch.full_like(lp[:1], NEG_INF)
    frozen[:, eot] = 0.0
    cand = sum_lp[:, None] + torch.where(finished[:, None], frozen, lp)
    if first is not None:
        cand = torch.where(first[:, None], NEG_INF, cand)
    bk, v = cand.shape
    scores, idx = top_k(cand.reshape(bk // k, k * v), k)
    row0 = torch.arange(0, bk, k, device=cand.device)[:, None]
    return (idx // v + row0).reshape(-1), (idx % v).reshape(-1).to(torch.int32), scores.reshape(-1)


def gather_lanes(
    buf: torch.Tensor, spare: torch.Tensor, parent: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """buf's lanes (axis 2, the self-KV's batch axis) reordered by parent
    into spare: one index_select, no copy back. Returns (the gathered
    buffer, the free one): the caller swaps the two."""
    torch.index_select(buf, 2, parent, out=spare)
    return spare, buf


def advance_state(
    spec: DecodingSpec, state: SamplerState, next_tok: torch.Tensor, logprob: torch.Tensor
) -> SamplerState:
    """Write the sampled token (uniform column) and update bookkeeping."""
    write = ~state.finished
    tok = torch.where(write, next_tok, spec.eot).to(torch.int32)
    sampled = state.sampled.clone()
    # past the last column the write lands on it, as the JAX
    # dynamic_update_slice clamps (only uncommitted speculative states)
    sampled[:, min(state.step, sampled.shape[1] - 1)] = tok
    is_ts = (tok >= spec.timestamp_begin) & write
    sum_logprob = state.sum_logprob + torch.where(write, logprob, 0.0)
    gen_len = state.gen_len + write.to(torch.int32)
    now_finished = (
        state.finished
        | (tok == spec.eot)
        | (state.prompt_len + state.step + 1 >= spec.max_length)
        | (state.step + 1 >= state.sampled.shape[1])
    )
    return SamplerState(
        sampled=sampled,
        step=state.step + 1,
        prompt_len=state.prompt_len,
        gen_len=gen_len,
        last_ts=torch.where(is_ts, tok, state.last_ts),
        finished=now_finished,
        sum_logprob=sum_logprob,
    )


def build_suppress_mask(
    n_vocab: int, token_ids: Sequence[int], device: torch.device | str = "cpu"
) -> torch.Tensor:
    """[V] bool mask from a list of suppressed token ids."""
    mask = np.zeros((n_vocab,), bool)
    for t in token_ids:
        if 0 <= t < n_vocab:
            mask[t] = True
    return torch.from_numpy(mask).to(device)
