"""The lockstep decode chunk of the continuous scheduler, plain and
speculative.

step_chunk is the port of whisperlive_tpu/engine/continuous.py _step_chunk,
spec_chunk that of _spec_chunk (below). Each of the chunk's steps, for every
row at once: the whisper logit rules through the ring (ops/ring_rules.py),
the repetition penalty, sampling, the ring write at the batch-uniform
column gstep % ring, the finish checks, and one decode_step_masked whose
cross-attention takes the rows' cross_len and, in a greedy pool, the write
mask as `active` (K5 on int8 cross-KV: rows that do not write read no
cross-KV).

In a beam pool (K lanes a slot) a slot steps while any of its lanes is
live. Its lanes at T = 0 expand together, engine._beam_step's semantics on
the ring state: finished lanes frozen to EOT at an unchanged score, the
lanes > 0 of a fresh slot (copies of lane 0) suppressed on its first
expansion, top-K over K*V, and the parent gather of the lane state and the
self-KV. At T > 0 (fallback retries) the lanes sample independently and
the harvest keeps the best (faster-whisper's best_of). Lanes gather across
rows, so a beam pool passes no `active` and runs K4, not K5.

Rows that do not write this step (free slots, finished slots awaiting
harvest) keep every piece of their state: each update goes through
torch.where on the write mask, never through arithmetic blending, so
whatever their unspecified decode output holds cannot reach their state.

The chunk makes no device-to-host copy: the ring columns are host ints,
and whether any row samples at T > 0 or has a repetition penalty comes
from the host's record of the rows' options. The caller's one sync per
chunk is the status fetch.

step_chunk also takes the global step as a one-element int64 tensor on
the state's device, which it advances in place: the ring columns and the
cache slot are then read and written through index ops, the same
arithmetic on the same values, and a step is one fixed program that
ContinuousEngine captures once in a CUDA graph and replays.
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
    gstep: int | torch.Tensor,  # global step of the chunk's first step
    n_steps: int,
    ring: int,
    prompt_pad: int,
    suppress_mask: torch.Tensor,  # [V] bool
    sampling: bool,  # some row has T > 0
    penalty: bool,  # some row has a repetition penalty != 1
    generator: torch.Generator,
    lanes: int = 1,  # beam width K: each slot's contiguous rows
) -> None:
    """Run n_steps lockstep decode steps on `state` in place. gstep: a host
    int, or a [1] int64 tensor on the state's device that each step
    advances by one in place."""
    spec, st = eng.spec, state
    n_rows = st["active"].shape[0]
    dev = st["active"].device
    cache_len = prompt_pad + ring
    jmask = torch.arange(cache_len, device=dev)[None, :]
    prompt_zeros = torch.zeros((n_rows, prompt_pad), dtype=torch.bool, device=dev)
    if lanes > 1:
        later_lane = torch.arange(n_rows, device=dev) % lanes > 0
    on_device = isinstance(gstep, torch.Tensor)
    for g in [gstep] * n_steps if on_device else range(gstep, gstep + n_steps):
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
        if sampling:
            next_tok, lp = dec.sample_next(filtered, st["temperature"], generator)
        else:
            next_tok, lp = _greedy(filtered)
        if lanes == 1:
            write = st["active"] & ~st["finished"]
            tok = torch.where(write, next_tok, spec.eot).to(torch.int32)
            new_sum = st["sum_logprob"] + torch.where(write, lp, 0.0)
        else:
            write, tok, new_sum, valid = _beam_expand(
                st, filtered, next_tok, lp, valid, lanes, later_lane, spec.eot)
        st["idle_row_steps"] += (~write).any()

        col = g % ring
        # rows that do not write keep their ring cell: once gstep wraps, the
        # column lands inside a finished slot's hypothesis
        cell = torch.where(write, tok, ring_rules.ring_col(st["sampled"], col))
        if on_device:
            st["sampled"].index_copy_(1, col, cell[:, None])
        else:
            st["sampled"][:, col] = cell
        is_ts = (tok >= spec.timestamp_begin) & write
        st["last_ts"].copy_(torch.where(is_ts, tok, st["last_ts"]))
        st["sum_logprob"].copy_(new_sum)
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
            st["cross_kv"], cross_len=st["cross_len"], active=write if lanes == 1 else None,
        )
        st["logits"].copy_(logits)
        if on_device:
            gstep.add_(1)


# lane state a beam pool's parent gather reorders (the rest is per slot)
LANE_FIELDS = ("sampled", "gen_len", "last_ts", "finished", "sum_logprob", "has_prefix",
               "pfx_last_ts", "pfx_penult_ts")


def _beam_expand(st, filtered, samp_tok, samp_lp, valid, lanes, later_lane, eot):
    """One step of a beam pool's lanes: coupled expansion (decoding.beam_select)
    for the stepping slots at T = 0, independent sampling at T > 0, then the
    parent gather of the lane state and the self-KV. Returns (write, tok,
    new sum_logprob, valid), the rows' quantities the plain step goes on
    with."""
    n_rows = filtered.shape[0]
    n_slots = n_rows // lanes
    slot_step = (st["active"].reshape(n_slots, lanes)[:, 0]
                 & ~st["finished"].reshape(n_slots, lanes).all(dim=1))
    step_rows = slot_step.repeat_interleave(lanes)
    # a fresh slot's lanes are copies of lane 0
    beam_parent, beam_tok, beam_sum = dec.beam_select(
        filtered, st["sum_logprob"], st["finished"], later_lane & (st["gen_len"] == 0), lanes,
        eot)
    use_beam = (st["temperature"] == 0.0) & step_rows
    parent = torch.where(use_beam, beam_parent, torch.arange(n_rows, device=filtered.device))
    for name in LANE_FIELDS:
        st[name].copy_(st[name][parent])
    st["self_kv"], st["self_kv_spare"] = dec.gather_lanes(st["self_kv"], st["self_kv_spare"],
                                                          parent)
    write = step_rows & ~st["finished"]
    tok = torch.where(write, torch.where(use_beam, beam_tok, samp_tok), eot).to(torch.int32)
    # a beam row's score is the absolute cumulative one (a frozen lane's
    # child inherits its unchanged score); a sampling row adds its own
    new_sum = torch.where(use_beam, beam_sum,
                          st["sum_logprob"] + torch.where(write, samp_lp, 0.0))
    return write, tok, new_sum, valid[parent]


RS_FIELDS = ("gen_len", "last_ts", "last_was_ts", "penult_was_ts", "finished", "sum_logprob")


@torch.no_grad()
def spec_chunk(
    eng,  # WhisperEngine (the target)
    draft,  # WhisperEngine (the draft)
    state: State,
    gstep: int,  # global step of the chunk's first round (a multiple of spec_k + 2)
    n_rounds: int,
    ring: int,  # a multiple of spec_k + 2
    prompt_pad: int,
    spec_k: int,
    suppress_mask: torch.Tensor,  # [V] bool
    sampling: bool,  # some row has T > 0
    penalty: bool,  # some row has a repetition penalty != 1
    generator: torch.Generator,
) -> None:
    """Run n_rounds speculative verify rounds on `state` in place: the
    lockstep form of engine/speculative.py. Per round, every live slot
    draft-decodes k proposals (k+1 decode_step_masked calls with the write
    mask as `active`: K5 or K7), the target scores [cur, d1..dk] in one
    decode_window_masked pass (K5's window form or K8), and the sampler
    rules replay along the window; the slot commits its accepted draft
    prefix plus the target's bonus token. Token-exact against step_chunk at
    temperature 0, since every committed token is the target's own
    rule-replayed emission. Ring layout per round, k+2 contiguous columns at
    the batch-uniform base c0 = gstep % ring:

      col 0     cur's K/V (fed by both models); its token is stored here
                only on the slot's first round (boot)
      col 1+i   draft d_{i+1}: K/V from the verify window; the token is
                valid iff accepted (i < a)
      col a+1   the bonus token (its K/V arrives next round at col 0)
      col k+1   the bonus's landing column on full acceptance; never holds
                valid K/V

    Every state update is a torch.where on the write mask. The chunk makes
    no device-to-host copy."""
    spec, st = eng.spec, state
    b = st["active"].shape[0]
    dev = st["active"].device
    kp1, kp2 = spec_k + 1, spec_k + 2
    eot, tb = spec.eot, spec.timestamp_begin
    rows = torch.arange(b, device=dev)
    jmask = torch.arange(prompt_pad + ring, device=dev)[None, :]
    prompt_zeros = torch.zeros((b, prompt_pad), dtype=torch.bool, device=dev)
    has_pfx = st["has_prefix"]

    def emit(rs, logits, seen, wr):
        """One rule-replayed emission over the tracked state (step_chunk's
        filter, sample and advance): with acceptance holes the last
        committed token is not at ring column gstep-1. The tracked chain
        starts (False, False); the ring rules' convention that a missing
        token counts as a timestamp applies to fresh rows only."""
        penult_eff = torch.where((rs["gen_len"] >= 2) | has_pfx, rs["penult_was_ts"], True)
        first = (rs["gen_len"] == 0) & ~has_pfx
        filtered = ring_rules.apply_logit_rules_tracked(
            spec, logits, suppress_mask, st["ts_enabled"], first, rs["last_was_ts"], penult_eff,
            rs["last_ts"],
        )
        if penalty:  # prompt + committed + in-round path (CTranslate2's rule)
            pcol = st["rep_penalty"][:, None]
            pen = torch.where(filtered > 0, filtered / pcol, filtered * pcol)
            filtered = torch.where(seen & (pcol != 1.0), pen, filtered)
        if sampling:
            tok, lp = dec.sample_next(filtered, st["temperature"], generator)
        else:
            tok, lp = _greedy(filtered)
        wr = wr & ~rs["finished"]
        tok = torch.where(wr, tok, eot).to(torch.int32)
        gen_after = rs["gen_len"] + wr.to(torch.int32)
        newly_done = wr & (
            (tok == eot)
            | (gen_after >= st["max_new"])
            | (st["prompt_len"] + gen_after >= spec.max_length)
        )
        is_ts = (tok >= tb) & wr
        rs2 = {
            "gen_len": gen_after,
            "last_ts": torch.where(is_ts, tok, rs["last_ts"]),
            "last_was_ts": torch.where(wr, tok >= tb, rs["last_was_ts"]),
            "penult_was_ts": torch.where(wr, rs["last_was_ts"], rs["penult_was_ts"]),
            "finished": rs["finished"] | newly_done,
            "sum_logprob": rs["sum_logprob"] + torch.where(wr, lp, 0.0),
        }
        if penalty:
            seen = seen.clone()
            seen[rows, tok.long()] |= wr
        return rs2, tok, seen

    for r in range(n_rounds):
        g = gstep + r * kp2
        c0 = g % ring
        write = st["active"] & ~st["finished"]
        boot = write & (st["gen_len"] == 0)
        st["idle_row_steps"] += (~write).any()
        seen0 = None
        if penalty:  # prompt + committed ring tokens
            v = st["logits"].shape[1]
            pvalid = torch.arange(prompt_pad, device=dev)[None, :] < st["prompt_len"][:, None]
            seen0 = torch.zeros((b, v), dtype=torch.int8, device=dev).scatter_reduce(
                1, st["sampled"].long(), st["tok_valid"].to(torch.int8), reduce="amax"
            ).scatter_reduce(1, st["prompt_toks"].long(), pvalid.to(torch.int8),
                             reduce="amax").bool()
        rs0 = {f: st[f] for f in RS_FIELDS}
        # boot: a freshly inserted slot's first token comes from its prefill
        # logits (the plain loop's first step)
        rs_b, boot_tok, seen_b = emit(rs0, st["logits"], seen0, boot)
        cur = torch.where(boot, boot_tok, st["cur"])
        base = (jmask < st["prompt_len"][:, None]) | torch.cat([prompt_zeros, st["kv_valid"]], 1)

        # draft: k proposals in k+1 steps (the extra step feeds d_k so its
        # K/V lands at column k; see engine/speculative.py)
        drs, tok, seen, drafts = rs_b, cur, seen_b, []
        for i in range(kp1):
            pos = st["prompt_len"] + drs["gen_len"] - 1
            mask = base.clone()
            mask[:, prompt_pad + c0: prompt_pad + c0 + i] = True
            dlogits = wmod.decode_step_masked(
                draft.params, draft.cfg, tok, pos, prompt_pad + c0 + i, mask, st["d_self_kv"],
                st["d_cross_kv"], cross_len=st["cross_len"], active=write,
            )
            drs, tok, seen = emit(drs, dlogits, seen, write)
            drafts.append(tok)
        drafts = torch.stack(drafts[:spec_k])  # [k, B]

        # target: verify [cur, d1..dk] in one pass
        win = torch.cat([cur[:, None], drafts.t()], dim=1)  # [B, k+1]
        pos0 = st["prompt_len"] + rs_b["gen_len"] - 1
        wpos = pos0[:, None] + torch.arange(kp1, device=dev)[None, :]
        iwin = torch.arange(kp1, device=dev)[None, :, None]
        wmask = base[:, None, :] | ((jmask[:, None, :] >= prompt_pad + c0)
                                    & (jmask[:, None, :] <= prompt_pad + c0 + iwin))
        logits_w = wmod.decode_window_masked(
            eng.params, eng.cfg, win, wpos, prompt_pad + c0, wmask, st["self_kv"], st["cross_kv"],
            cross_len=st["cross_len"], active=write,
        )

        # replay the sampler rules along the draft path
        vrs, seen, gs, vstack = rs_b, seen_b, [], []
        for i in range(kp1):
            vrs, gtok, seen = emit(vrs, logits_w[:, i], seen, write)
            gs.append(gtok)
            vstack.append(vrs)
        gs = torch.stack(gs)  # [k+1, B]
        # d_{i+1} is accepted iff the target's emission agrees and the
        # hypothesis was not already finished there
        fin = torch.stack([v["finished"] for v in vstack])
        acc = (gs[:-1] == drafts) & ~fin[:-1]
        a = torch.cumprod(acc.to(torch.int32), dim=0).sum(dim=0)  # [B]

        def take(xs):
            return xs.gather(0, a[None])[0]

        bonus = take(gs)
        for f in RS_FIELDS:
            st[f].copy_(torch.where(write, take(torch.stack([v[f] for v in vstack])), st[f]))
        st["cur"].copy_(torch.where(write, bonus, st["cur"]))

        # commit: one uniform k+2-column block write
        cidx = torch.arange(kp2, device=dev)[None, :]
        win_pad = torch.cat([win, torch.zeros((b, 1), dtype=torch.int32, device=dev)], dim=1)
        block_tok = torch.where(cidx == (a + 1)[:, None], bonus[:, None], win_pad)
        new_tbits = write[:, None] & (((cidx >= 1) & (cidx <= (a + 1)[:, None]))
                                      | (boot[:, None] & (cidx == 0)))
        new_kbits = write[:, None] & (cidx <= a[:, None]) & (cidx < kp1)
        wcol = write[:, None]
        cols = slice(c0, c0 + kp2)
        st["sampled"][:, cols] = torch.where(wcol, block_tok, st["sampled"][:, cols])
        st["tok_valid"][:, cols] = torch.where(wcol, new_tbits, st["tok_valid"][:, cols])
        st["kv_valid"][:, cols] = torch.where(wcol, new_kbits, st["kv_valid"][:, cols])
        # ring-budget force finish: the next round's block must not clobber
        # this slot's live columns
        st["finished"] |= write & (g + 2 * kp2 - 1 - st["join_step"] >= ring)
