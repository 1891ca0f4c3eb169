"""The lockstep decode chunk of the continuous scheduler.

Port of whisperlive_tpu/engine/continuous.py _step_chunk for greedy slot
pools (one lane per slot). Each of the chunk's steps, for every row at
once: the whisper logit rules through the ring (ops/ring_rules.py), the
repetition penalty, sampling, the ring write at the batch-uniform column
gstep % ring, the finish checks, and one decode_step_masked whose cross-
attention takes the rows' cross_len and the write mask as `active` (K5 on
int8 cross-KV: rows that do not write read no cross-KV).

Rows that do not write this step (free slots, finished slots awaiting
harvest) keep every piece of their state: each update goes through
torch.where on the write mask, never through arithmetic blending, so
whatever their unspecified decode output holds cannot reach their state.

The chunk makes no device-to-host copy: the ring columns are host ints,
and whether any row samples at T > 0 or has a repetition penalty comes
from the host's record of the rows' options. The caller's one sync per
chunk is the status fetch.
"""

from __future__ import annotations

import torch

from whisperlive_tpu_torch.engine.continuous_state import State
from whisperlive_tpu_torch.models import whisper as wmod
from whisperlive_tpu_torch.ops import decoding as dec
from whisperlive_tpu_torch.ops import ring_rules


def _greedy(filtered: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """decoding.sample_next for rows that are all at T = 0, without a draw."""
    tok = torch.argmax(filtered, dim=-1).to(torch.int32)
    lp = torch.log_softmax(filtered, dim=-1).gather(1, tok.long()[:, None])[:, 0]
    return tok, lp


@torch.no_grad()
def step_chunk(
    eng,  # WhisperEngine
    state: State,
    gstep: int,  # global step of the chunk's first step
    n_steps: int,
    ring: int,
    prompt_pad: int,
    suppress_mask: torch.Tensor,  # [V] bool
    sampling: bool,  # some row has T > 0
    penalty: bool,  # some row has a repetition penalty != 1
    generator: torch.Generator,
) -> None:
    """Run n_steps lockstep decode steps on `state` in place."""
    spec, st = eng.spec, state
    n_rows = st["active"].shape[0]
    dev = st["active"].device
    cache_len = prompt_pad + ring
    jmask = torch.arange(cache_len, device=dev)[None, :]
    prompt_zeros = torch.zeros((n_rows, prompt_pad), dtype=torch.bool, device=dev)
    for g in range(gstep, gstep + n_steps):
        valid = ring_rules.ring_valid(g, st["join_step"], ring)
        filtered = ring_rules.apply_logit_rules_ring(
            spec, st["logits"], st["sampled"], g, st["gen_len"], st["last_ts"],
            suppress_mask, st["ts_enabled"], st["has_prefix"], st["pfx_last_ts"],
            st["pfx_penult_ts"],
        )
        filtered = ring_rules.apply_repetition_penalty_ring(
            filtered, st["sampled"], valid, st["rep_penalty"],
            prompt_toks=st["prompt_toks"], prompt_len=st["prompt_len"], enabled=penalty,
        )
        write = st["active"] & ~st["finished"]
        if sampling:
            next_tok, lp = dec.sample_next(filtered, st["temperature"], generator)
        else:
            next_tok, lp = _greedy(filtered)
        tok = torch.where(write, next_tok, spec.eot).to(torch.int32)
        st["idle_row_steps"] += (~write).any()

        col = g % ring
        # rows that do not write keep their ring cell: once gstep wraps, the
        # column lands inside a finished slot's hypothesis
        st["sampled"][:, col] = torch.where(write, tok, st["sampled"][:, col])
        is_ts = (tok >= spec.timestamp_begin) & write
        st["last_ts"].copy_(torch.where(is_ts, tok, st["last_ts"]))
        st["sum_logprob"].add_(torch.where(write, lp, 0.0))
        st["gen_len"].add_(write.to(torch.int32))
        gen_after = st["gen_len"]
        newly_done = write & (
            (tok == spec.eot)
            | (gen_after >= st["max_new"])
            | (st["prompt_len"] + gen_after >= spec.max_length)
            | (gen_after >= ring - 1)
        )
        st["finished"] |= newly_done

        pos = st["prompt_len"] + gen_after - 1
        mask = (jmask < st["prompt_len"][:, None]) | torch.cat([prompt_zeros, valid], dim=1)
        logits = wmod.decode_step_masked(
            eng.params, eng.cfg, tok, pos, prompt_pad + col, mask, st["self_kv"],
            st["cross_kv"], cross_len=st["cross_len"], active=write,
        )
        st["logits"].copy_(logits)
