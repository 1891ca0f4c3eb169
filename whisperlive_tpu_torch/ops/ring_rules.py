"""Whisper logit rules addressed through the continuous scheduler's ring.

Port of the rule functions of whisperlive_tpu/engine/continuous.py. In the
continuous decode every slot samples in lockstep from one global step
counter, but slots joined at different steps: slot b's i-th sampled token
lives in ring column (join_step[b] + i) % ring. These functions read each
row's last tokens and its validity mask through that addressing and apply
the same openai-whisper rules as ops/decoding.py.

The global step is a host int (the port drives the loop from the host),
so a ring column index is a Python int and costs no device sync; or, in
the continuous pool's captured CUDA graph, a one-element int64 tensor on
the state's device, read through index ops (never by Python indexing,
which would copy it to the host). Every per-row quantity is a tensor on
the state's device.
"""

from __future__ import annotations

import torch

from whisperlive_tpu_torch.ops.decoding import NEG_INF, DecodingSpec


def ring_valid(gstep: int | torch.Tensor, join_step: torch.Tensor, ring: int) -> torch.Tensor:
    """[B, ring] bool: ring column r holds the token of step
    s_r = gstep-1 - ((gstep-1-r) mod ring); valid iff s_r >= join_step."""
    r = torch.arange(ring, device=join_step.device)[None, :]
    s_r = (gstep - 1) - torch.remainder((gstep - 1) - r, ring)
    return (s_r >= join_step[:, None]) & (gstep > join_step)[:, None]


def ring_col(sampled: torch.Tensor, col: int | torch.Tensor) -> torch.Tensor:
    """Column `col` (taken mod the ring width) of the [B, ring] ring; `col`
    a host int or a [1] device tensor."""
    if isinstance(col, torch.Tensor):
        return sampled.index_select(1, col % sampled.shape[1])[:, 0]
    return sampled[:, col % sampled.shape[1]]


def apply_logit_rules_ring(
    spec: DecodingSpec,
    logits: torch.Tensor,  # [B, V]
    sampled: torch.Tensor,  # [B, G] ring
    gstep: int | torch.Tensor,  # host int or [1] int64 device tensor
    gen_len: torch.Tensor,  # [B]
    last_ts: torch.Tensor,  # [B]
    suppress_mask: torch.Tensor,  # [V]
    ts_enabled: torch.Tensor,  # [B]
    has_prefix: torch.Tensor | None = None,  # [B] bool
    pfx_last_ts: torch.Tensor | None = None,  # [B] bool: prefix[-1] is a timestamp
    pfx_penult_ts: torch.Tensor | None = None,  # [B] bool: prefix[-2] is a timestamp
) -> torch.Tensor:
    """The whisper logit rules of decoding.apply_logit_rules, read through
    the ring. has_prefix marks rows whose decode continues a forced token
    prefix: their first sampled token is mid-hypothesis, so the decode-start
    rules do not fire again, and the timestamp-pairing rules read the
    prefix tail's timestamp-ness for the first two sampled tokens."""
    first = gen_len == 0
    if has_prefix is not None:
        first = first & ~has_prefix

    last_tok = ring_col(sampled, gstep - 1)
    penult_tok = ring_col(sampled, gstep - 2)
    last_was_ts = (gen_len >= 1) & (last_tok >= spec.timestamp_begin)
    penult_was_ts = (gen_len < 2) | (penult_tok >= spec.timestamp_begin)
    if has_prefix is not None:
        p_last = has_prefix & (
            pfx_last_ts if pfx_last_ts is not None else torch.zeros_like(has_prefix)
        )
        p_penult = has_prefix & (
            pfx_penult_ts if pfx_penult_ts is not None else torch.zeros_like(has_prefix)
        )
        last_was_ts = torch.where(gen_len >= 1, last_was_ts, p_last)
        penult_was_ts = torch.where(
            gen_len >= 2,
            penult_was_ts,
            torch.where(
                gen_len == 1,
                torch.where(has_prefix, p_last, penult_was_ts),
                torch.where(has_prefix, p_penult, penult_was_ts),
            ),
        )
    return apply_logit_rules_tracked(
        spec, logits, suppress_mask, ts_enabled, first, last_was_ts, penult_was_ts, last_ts,
    )


def apply_logit_rules_tracked(
    spec: DecodingSpec,
    logits: torch.Tensor,  # [B, V]
    suppress_mask: torch.Tensor,  # [V]
    ts_enabled: torch.Tensor,  # [B]
    first: torch.Tensor,  # [B] bool: decode-start rules fire
    last_was_ts: torch.Tensor,  # [B] bool: hypothesis token -1 is a timestamp
    penult_was_ts: torch.Tensor,  # [B] bool: hypothesis token -2 is a timestamp
    last_ts: torch.Tensor,  # [B] last emitted timestamp token id
) -> torch.Tensor:
    """The whisper logit-rule core with the sequence context given as
    explicit per-row state."""
    v = logits.shape[1]
    vocab = torch.arange(v, device=logits.device)[None, :]
    tb = spec.timestamp_begin

    logits = torch.where(suppress_mask[None, :], NEG_INF, logits)
    blank_mask = (vocab == spec.blank) | (vocab == spec.eot)
    logits = torch.where(first[:, None] & blank_mask, NEG_INF, logits)

    is_ts = vocab >= tb
    is_text = vocab < spec.eot
    suppress_ts = (last_was_ts & penult_was_ts)[:, None] & is_ts
    suppress_text = (last_was_ts & ~penult_was_ts)[:, None] & is_text

    lower = torch.where(last_was_ts & ~penult_was_ts, last_ts, last_ts + 1)
    has_ts = last_ts >= tb
    suppress_low_ts = has_ts[:, None] & is_ts & (vocab < lower[:, None])

    init_lim = tb + spec.max_initial_timestamp_index
    suppress_first = first[:, None] & (~is_ts | (vocab > init_lim))
    suppress_nots = vocab == (tb - 1)

    ts_rules = (
        suppress_ts | suppress_text | suppress_low_ts | suppress_first | suppress_nots
    ) & ts_enabled[:, None]
    no_ts = ~ts_enabled[:, None] & (is_ts | (vocab == tb - 1))
    logits = torch.where(ts_rules | no_ts, NEG_INF, logits)

    logprobs = torch.log_softmax(logits, dim=-1)
    ts_logprob = torch.logsumexp(torch.where(is_ts, logprobs, NEG_INF), dim=-1)
    max_text = torch.where(is_ts, NEG_INF, logprobs).amax(dim=-1)
    force_ts = (ts_logprob > max_text) & ts_enabled
    return torch.where(force_ts[:, None] & ~is_ts, NEG_INF, logits)


def apply_repetition_penalty_ring(
    logits: torch.Tensor,  # [B, V]
    sampled: torch.Tensor,  # [B, G]
    valid: torch.Tensor,  # [B, G] ring validity
    penalty: torch.Tensor,  # [B]
    prompt_toks: torch.Tensor | None = None,  # [B, P] post-splice prompt ids
    prompt_len: torch.Tensor | None = None,  # [B]
    enabled: bool | None = None,
) -> torch.Tensor:
    """CTranslate2-style repetition penalty over the ring and the prompt.

    `enabled` is the host's knowledge of whether any row has a penalty
    other than 1.0: False returns the logits untouched with no device work
    (the JAX code's lax.cond guard); None asks the device, which syncs."""
    if enabled is None:
        enabled = bool((penalty != 1.0).any())
    if not enabled:
        return logits
    b, v = logits.shape
    pcol = penalty[:, None]
    seen = torch.zeros((b, v), dtype=torch.int8, device=logits.device).scatter_reduce(
        1, sampled.long(), valid.to(torch.int8), reduce="amax"
    )
    if prompt_toks is not None:
        pidx = torch.arange(prompt_toks.shape[1], device=logits.device)[None, :]
        pvalid = (pidx < prompt_len[:, None]).to(torch.int8)
        seen = seen.scatter_reduce(1, prompt_toks.long(), pvalid, reduce="amax")
    penalized = torch.where(logits > 0, logits / pcol, logits * pcol)
    return torch.where(seen.bool() & (pcol != 1.0), penalized, logits)
