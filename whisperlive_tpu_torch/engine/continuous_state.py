"""Slot state of the continuous decode: allocation, insert, release, status.

Port of the state half of whisperlive_tpu/engine/continuous.py (_init_state,
_base_state, _insert, _release, _pack_status). A slot owns `lanes` (the beam
width K) contiguous rows, slot s rows [s*K, s*K + K); a greedy pool has one
lane per slot. The state is a dict of tensors on the engine's device, one
row per lane:

  self_kv     [L, 2, B, prompt_pad + ring, H, hd]: the prompt region, then
              the ring; slot b's i-th sampled token has its K/V at ring
              column (join_step[b] + i) % ring, the same column for every
              slot at a given step;
  cross_kv    the cross-KV of every slot, capped at cross_ctx positions:
              {"kv8": [L, 1, B, H, cross_ctx, 2*hd] int8, "scale": [L, 2, B,
              1, H, hd] bf16}, {"kv4": [L, 2, B, H, cross_ctx, hd/2] int4
              pairs, "scale": as kv8's} or {"kv": [L, 2, B, cross_ctx, H,
              hd], "scale": None};
  cross_len   [B] valid positions of each slot's cross-KV (a window encoded
              at a reduced context leaves the previous occupant's data in
              the tail);
  sampled     [B, ring] the sampled tokens, addressed like the self-KV ring;
  active, finished, gen_len, last_ts, ...: per-lane decode state;
  self_kv_spare (beam pools only) the target of the step's parent gather of
              self_kv, the two swapping each step.

A pool with a speculative draft (continuous_step.spec_chunk) also holds
the draft's self-KV and cross-KV (d_self_kv, d_cross_kv, the same layouts
at the draft's depth and cross-KV width), the committed-but-unfed token
`cur`, the tracked rule chain (last_was_ts, penult_was_ts: with
acceptance holes the last committed token is not at ring column gstep-1)
and two validity planes over the ring: tok_valid (committed hypothesis
tokens, for harvest and the repetition penalty) and kv_valid (columns
whose K/V may be attended).

The JAX engine updates this state functionally, donating the old buffers
to each jitted program. Here the tensors are allocated once and updated in
place (index writes and copy_), so a slot's buffers never move; reset_state
empties the pool without moving them either, so a CUDA graph captured over
the state stays valid. The global step counter is a host int kept by the
caller.
"""

from __future__ import annotations

import numpy as np
import torch

from whisperlive_tpu_torch.models import whisper as wmod
from whisperlive_tpu_torch.ops import decoding as dec
from whisperlive_tpu_torch.ops import mel as mel_ops

State = dict  # name -> tensor (or nested dict for cross_kv)

# per-slot fields an insert sets from its arguments, with their dtypes
_ROW_FIELDS = {
    "last_ts": torch.int32, "has_prefix": torch.bool,
    "pfx_last_ts": torch.bool, "pfx_penult_ts": torch.bool, "temperature": torch.float32,
    "ts_enabled": torch.bool, "rep_penalty": torch.float32,
    "length_penalty": torch.float32, "max_new": torch.int32,
}


def cross_template(cfg: wmod.WhisperConfig, bits: int, b: int, tcap: int,
                   device: torch.device) -> dict:
    """Zeroed cross-KV region of b slots capped at tcap positions (this
    rank's heads under tensor parallelism)."""
    hd, h = cfg.head_dim, cfg.text_heads
    scale = torch.zeros((cfg.n_text_layer, 2, b, 1, h, hd),
                        dtype=torch.bfloat16, device=device)
    if bits == 8:
        return {
            "kv8": torch.zeros((cfg.n_text_layer, 1, b, h, tcap, 2 * hd),
                               dtype=torch.int8, device=device),
            "scale": scale,
        }
    if bits == 4:
        return {
            "kv4": torch.zeros((cfg.n_text_layer, 2, b, h, tcap, hd // 2),
                               dtype=torch.int8, device=device),
            "scale": scale,
        }
    return {
        "kv": torch.zeros((cfg.n_text_layer, 2, b, tcap, h, hd),
                          dtype=cfg.dtype, device=device),
        "scale": None,
    }


def _fills(spec: dec.DecodingSpec, ring: int, cross_ctx: int) -> dict:
    """The fields of an empty pool that do not start at zero, with their
    values (every other tensor of the state starts zeroed)."""
    return {
        "logits": dec.NEG_INF,
        "last_ts": spec.timestamp_begin - 1,
        "ts_enabled": True,
        "rep_penalty": 1.0,
        "length_penalty": 1.0,
        "max_new": ring - 1,
        "cross_len": cross_ctx,
    }


def init_state(cfg: wmod.WhisperConfig, spec: dec.DecodingSpec, n_rows: int, prompt_pad: int,
               ring: int, cross_ctx: int, bits: int, device: torch.device,
               draft=None, lanes: int = 1) -> State:
    """The empty slot pool of n_rows lane rows (every slot inactive); with a
    draft engine, also the speculative round state."""
    b = n_rows

    def empty(dtype, *shape):
        return torch.empty(shape or (b,), dtype=dtype, device=device)

    spec_state = {} if draft is None else {
        "cur": empty(torch.int32),
        "last_was_ts": empty(torch.bool),
        "penult_was_ts": empty(torch.bool),
        "tok_valid": empty(torch.bool, b, ring),
        "kv_valid": empty(torch.bool, b, ring),
        "d_self_kv": wmod.init_self_kv(draft.cfg, b, prompt_pad + ring, device=device),
        "d_cross_kv": cross_template(draft.cfg, draft.cross_kv_bits, b, cross_ctx, device),
    }
    beam_state = {} if lanes == 1 else {
        "self_kv_spare": wmod.init_self_kv(cfg, b, prompt_pad + ring, device=device),
    }
    state = {
        **spec_state,
        **beam_state,
        "self_kv": wmod.init_self_kv(cfg, b, prompt_pad + ring, device=device),
        "cross_kv": cross_template(cfg, bits, b, cross_ctx, device),
        "sampled": empty(torch.int32, b, ring),
        "logits": empty(torch.float32, b, cfg.n_vocab),
        # prompt ids after the language splice: the repetition penalty sees
        # the whole sequence, prompt included
        "prompt_toks": empty(torch.int32, b, prompt_pad),
        "prompt_len": empty(torch.int32),
        "join_step": empty(torch.int32),
        "gen_len": empty(torch.int32),
        "last_ts": empty(torch.int32),
        "active": empty(torch.bool),
        "finished": empty(torch.bool),
        "has_prefix": empty(torch.bool),
        "pfx_last_ts": empty(torch.bool),
        "pfx_penult_ts": empty(torch.bool),
        "sum_logprob": empty(torch.float32),
        "ns_prob": empty(torch.float32),
        "temperature": empty(torch.float32),
        "ts_enabled": empty(torch.bool),
        "rep_penalty": empty(torch.float32),
        "length_penalty": empty(torch.float32),
        "max_new": empty(torch.int32),
        "cross_len": empty(torch.int32),
        # steps in which some row did not write (inactive or finished): the
        # share of steps K5 had rows to skip; read by the host at will
        "idle_row_steps": torch.empty((), dtype=torch.int64, device=device),
    }
    reset_state(state, spec, ring, cross_ctx)
    return state


def reset_state(state: State, spec: dec.DecodingSpec, ring: int, cross_ctx: int) -> None:
    """Empty the pool in place: init_state's values, every tensor keeping its
    storage (a CUDA graph captured over the state stays valid)."""
    fills = _fills(spec, ring, cross_ctx)
    for name, x in state.items():
        if isinstance(x, dict):  # a cross-KV region
            for leaf in x.values():
                if leaf is not None:
                    leaf.zero_()
        else:
            x.fill_(fills.get(name, 0))


@torch.no_grad()
def insert(
    eng,  # WhisperEngine
    state: State,
    gstep: int,
    cross_ctx: int,
    audio: torch.Tensor,  # [j, n_samples] f32 PCM
    prompts: torch.Tensor,  # [j, prompt_pad] int32
    prompt_len: torch.Tensor,  # [j] int32
    sot_idx: torch.Tensor,  # [j] int32
    lang_known: torch.Tensor,  # [j] bool
    slot_ids: torch.Tensor,  # [j] int64 (a padded wave repeats its last slot)
    rows: dict[str, torch.Tensor],  # _ROW_FIELDS name -> [j]
    draft=None,  # the draft WhisperEngine of a speculative pool
    lanes: int = 1,
) -> torch.Tensor:
    """Encode a wave of windows and seat each in its slot: log-mel, encoder
    at the wave's context bucket, cross-KV (int8-quantized when the engine
    keeps int8 cross-KV) cut to cross_ctx positions, language ID for rows
    whose language is unknown (spliced into their prompt), prompt prefill,
    and the slot's rule state. With a draft, its cross-KV is projected from
    the same encoder output (a distil draft shares the teacher's encoder)
    and it prefills the same prompt. A beam pool (lanes K > 1) repeats each
    window's prefill on its slot's K rows. Returns the language
    probabilities [j, n_lang] (zeros [j, 1] for an English-only model). Rows
    of a padded wave that repeat a slot write identical data into it."""
    cfg, spec, params, dev = eng.cfg, eng.spec, eng.params, eng.device
    j = audio.shape[0]
    mel = mel_ops.log_mel_spectrogram(audio, n_mels=cfg.n_mels)
    enc = wmod.encode(params, cfg, mel)
    t_here = min(enc.shape[1], cross_ctx)
    enc = enc[:, :t_here]
    cross = eng.quantize_cross(wmod.compute_cross_kv(params, cfg, enc))

    if eng.tokenizer.spec.multilingual:
        lang_ids = eng._lang_ids
        self_kv_d = wmod.init_self_kv(cfg, j, 8, device=dev)
        sot = torch.full((j, 1), spec.eot + 1, dtype=torch.int32, device=dev)
        ones = torch.ones((j,), dtype=torch.int32, device=dev)
        det_logits = wmod.decode_prefill(params, cfg, sot, ones, self_kv_d, cross)
        lmask = torch.zeros((cfg.n_vocab,), dtype=torch.bool, device=dev)
        lmask[lang_ids] = True
        det_logits = torch.where(lmask[None, :], det_logits, dec.NEG_INF)
        lang_probs = torch.softmax(det_logits, dim=-1)[:, lang_ids]
        detected = lang_ids[torch.argmax(lang_probs, dim=-1)].to(torch.int32)
        idx = torch.arange(j, device=dev)
        lang_pos = (sot_idx + 1).clamp(0, prompts.shape[1] - 1).long()
        prompts = prompts.clone()
        prompts[idx, lang_pos] = torch.where(lang_known, prompts[idx, lang_pos], detected)
    else:
        lang_probs = torch.zeros((j, 1), dtype=torch.float32, device=dev)

    prompt_pad = prompts.shape[1]
    self_kv_j = wmod.init_self_kv(cfg, j, prompt_pad, device=dev)
    last_logits, sot_logits = wmod.decode_prefill(
        params, cfg, prompts, prompt_len, self_kv_j, cross, sot_idx=sot_idx
    )
    ns = torch.softmax(sot_logits, dim=-1)[:, spec.no_speech]

    if lanes > 1:  # each window on its slot's K contiguous rows
        slot_ids = (slot_ids[:, None] * lanes + torch.arange(lanes, device=dev)).reshape(-1)
        self_kv_j = self_kv_j.repeat_interleave(lanes, dim=2)
        cross = wmod.tree_map(lambda a: a.repeat_interleave(lanes, dim=2), cross)
        prompts, prompt_len, last_logits, ns = (
            x.repeat_interleave(lanes, dim=0) for x in (prompts, prompt_len, last_logits, ns))
        rows = {name: v.repeat_interleave(lanes, dim=0) for name, v in rows.items()}
    state["self_kv"][:, :, slot_ids, :prompt_pad] = self_kv_j
    _write_cross(state["cross_kv"], cross, slot_ids, t_here)
    if draft is not None:
        cross_d = draft.quantize_cross(wmod.compute_cross_kv(draft.params, draft.cfg, enc))
        d_kv_j = wmod.init_self_kv(draft.cfg, j, prompt_pad, device=dev)
        wmod.decode_prefill(draft.params, draft.cfg, prompts, prompt_len, d_kv_j, cross_d)
        state["d_self_kv"][:, :, slot_ids, :prompt_pad] = d_kv_j
        _write_cross(state["d_cross_kv"], cross_d, slot_ids, t_here)
        state["tok_valid"][slot_ids] = False
        state["kv_valid"][slot_ids] = False
        state["cur"][slot_ids] = 0
        # the tracked rule chain: a prefix row carries its tail's
        # timestamp-ness, a fresh row starts (False, False)
        state["last_was_ts"][slot_ids] = rows["has_prefix"] & rows["pfx_last_ts"]
        state["penult_was_ts"][slot_ids] = rows["has_prefix"] & rows["pfx_penult_ts"]
    state["logits"][slot_ids] = last_logits
    state["prompt_toks"][slot_ids] = prompts
    state["prompt_len"][slot_ids] = prompt_len
    for name, value in rows.items():
        state[name][slot_ids] = value.to(_ROW_FIELDS[name])
    state["join_step"][slot_ids] = gstep
    state["gen_len"][slot_ids] = 0
    state["active"][slot_ids] = True
    state["finished"][slot_ids] = False
    state["sum_logprob"][slot_ids] = 0.0
    state["ns_prob"][slot_ids] = ns.float()
    state["cross_len"][slot_ids] = t_here
    return lang_probs


def _write_cross(dst: dict, cross: dict, slot_ids: torch.Tensor, t_here: int) -> None:
    """Seat a wave's cross-KV in its slots' rows of the capped region."""
    for leaf in ("kv8", "kv4"):  # [L, 1|2, B, H, T, *]
        if leaf in dst:
            dst[leaf][:, :, slot_ids, :, :t_here] = cross[leaf]
    if "kv" in dst:  # [L, 2, B, T, H, hd]
        dst["kv"][:, :, slot_ids, :t_here] = cross["kv"]
    if dst.get("scale") is not None:
        dst["scale"][:, :, slot_ids] = cross["scale"]


def release(state: State, rows: torch.Tensor) -> None:
    """Free the slots of the [B] bool mask `rows`."""
    state["active"] &= ~rows
    state["finished"] &= ~rows


def pack_status(state: State, lanes: int = 1) -> torch.Tensor:
    """Per-row packed status and tokens [rows, 6 + ring] float32. Columns
    0..5 hold the row's slot's status, repeated on each of its `lanes`
    rows: active, all lanes finished, the winning lane's gen_len and
    sum_logprob, the no-speech probability and the winning lane (the best
    sum / len^length_penalty, CTranslate2's score; 0 with one lane). Then
    the row's sampled ring (token ids < 2^24 are exact in float32); a
    speculative pool appends its committed-token mask tok_valid ([B, 6 +
    2*ring]: acceptance holes break the contiguous ring addressing). One
    device-to-host copy of it per chunk carries every finished hypothesis
    with the scheduling state."""
    n_slots = state["active"].shape[0] // lanes

    def per_slot(name):
        return state[name].reshape(n_slots, lanes)

    gen = per_slot("gen_len").float()
    slp = per_slot("sum_logprob")
    winner = torch.argmax(slp / gen.clamp(min=1.0) ** per_slot("length_penalty"), dim=1)
    slots = torch.arange(n_slots, device=gen.device)
    cols = [
        per_slot("active")[:, 0].float(), per_slot("finished").all(dim=1).float(),
        gen[slots, winner], slp[slots, winner], per_slot("ns_prob")[:, 0], winner.float(),
    ]
    status = torch.stack(cols, dim=1).repeat_interleave(lanes, dim=0)
    parts = [status, state["sampled"].float()]
    if "tok_valid" in state:
        parts.append(state["tok_valid"].float())
    return torch.cat(parts, dim=1)


def unroll(row: np.ndarray, join_step: int, gen_len: int, ring: int) -> np.ndarray:
    """Ring-unroll one slot's tokens from its sampled row."""
    cols = (join_step + np.arange(gen_len)) % ring
    return row[cols]


def unroll_masked(tokens: np.ndarray, valid: np.ndarray, join_step: int, ring: int) -> np.ndarray:
    """Ring-unroll through the committed-token mask (speculative pools):
    the valid columns ordered by age since the slot's join. The ring-budget
    force finish keeps a slot's data within one ring of global steps, so
    (col - join_step) % ring orders them."""
    cols = np.nonzero(valid)[0]
    cols = cols[np.argsort((cols - join_step) % ring, kind="stable")]
    return tokens[cols]
