"""Slot state of the continuous decode: allocation, insert, release, status.

Port of the state half of whisperlive_tpu/engine/continuous.py (_init_state,
_base_state, _insert, _release, _pack_status) for greedy slot pools (one
lane per slot). The state is a dict of tensors on the engine's device:

  self_kv     [L, 2, B, prompt_pad + ring, H, hd]: the prompt region, then
              the ring; slot b's i-th sampled token has its K/V at ring
              column (join_step[b] + i) % ring, the same column for every
              slot at a given step;
  cross_kv    the cross-KV of every slot, capped at cross_ctx positions:
              {"kv8": [L, 1, B, H, cross_ctx, 2*hd] int8, "scale": [L, 2, B,
              1, H, hd] bf16} or {"kv": [L, 2, B, cross_ctx, H, hd],
              "scale": None};
  cross_len   [B] valid positions of each slot's cross-KV (a window encoded
              at a reduced context leaves the previous occupant's data in
              the tail);
  sampled     [B, ring] the sampled tokens, addressed like the self-KV ring;
  active, finished, gen_len, last_ts, ...: per-slot decode state.

The JAX engine updates this state functionally, donating the old buffers
to each jitted program. Here the tensors are allocated once and updated in
place (index writes and copy_), so a slot's buffers never move. The
global step counter is a host int kept by the caller.
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
    """Zeroed cross-KV region of b slots capped at tcap positions."""
    hd = cfg.n_text_state // cfg.n_text_head
    if bits == 8:
        return {
            "kv8": torch.zeros((cfg.n_text_layer, 1, b, cfg.n_text_head, tcap, 2 * hd),
                               dtype=torch.int8, device=device),
            "scale": torch.zeros((cfg.n_text_layer, 2, b, 1, cfg.n_text_head, hd),
                                 dtype=torch.bfloat16, device=device),
        }
    return {
        "kv": torch.zeros((cfg.n_text_layer, 2, b, tcap, cfg.n_text_head, hd),
                          dtype=cfg.dtype, device=device),
        "scale": None,
    }


def init_state(cfg: wmod.WhisperConfig, spec: dec.DecodingSpec, n_rows: int, prompt_pad: int,
               ring: int, cross_ctx: int, bits: int, device: torch.device) -> State:
    """The empty slot pool (every slot inactive)."""
    b = n_rows

    def full(value, dtype, *shape):
        return torch.full(shape or (b,), value, dtype=dtype, device=device)

    return {
        "self_kv": wmod.init_self_kv(cfg, b, prompt_pad + ring, device=device),
        "cross_kv": cross_template(cfg, bits, b, cross_ctx, device),
        "sampled": full(0, torch.int32, b, ring),
        "logits": full(dec.NEG_INF, torch.float32, b, cfg.n_vocab),
        # prompt ids after the language splice: the repetition penalty sees
        # the whole sequence, prompt included
        "prompt_toks": full(0, torch.int32, b, prompt_pad),
        "prompt_len": full(0, torch.int32),
        "join_step": full(0, torch.int32),
        "gen_len": full(0, torch.int32),
        "last_ts": full(spec.timestamp_begin - 1, torch.int32),
        "active": full(False, torch.bool),
        "finished": full(False, torch.bool),
        "has_prefix": full(False, torch.bool),
        "pfx_last_ts": full(False, torch.bool),
        "pfx_penult_ts": full(False, torch.bool),
        "sum_logprob": full(0.0, torch.float32),
        "ns_prob": full(0.0, torch.float32),
        "temperature": full(0.0, torch.float32),
        "ts_enabled": full(True, torch.bool),
        "rep_penalty": full(1.0, torch.float32),
        "length_penalty": full(1.0, torch.float32),
        "max_new": full(ring - 1, torch.int32),
        "cross_len": full(cross_ctx, torch.int32),
        # steps in which some row did not write (inactive or finished): the
        # share of steps K5 had rows to skip; read by the host at will
        "idle_row_steps": torch.zeros((), dtype=torch.int64, device=device),
    }


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
) -> torch.Tensor:
    """Encode a wave of windows and seat each in its slot: log-mel, encoder
    at the wave's context bucket, cross-KV (int8-quantized when the engine
    keeps int8 cross-KV) cut to cross_ctx positions, language ID for rows
    whose language is unknown (spliced into their prompt), prompt prefill,
    and the slot's rule state. Returns the language probabilities [j, n_lang]
    (zeros [j, 1] for an English-only model). Rows of a padded wave that
    repeat a slot write identical data into it."""
    cfg, spec, params, dev = eng.cfg, eng.spec, eng.params, eng.device
    j = audio.shape[0]
    mel = mel_ops.log_mel_spectrogram(audio, n_mels=cfg.n_mels)
    enc = wmod.encode(params, cfg, mel)
    t_here = min(enc.shape[1], cross_ctx)
    cross = wmod.compute_cross_kv(params, cfg, enc[:, :t_here])
    if eng.cross_kv_bits == 8:
        cross = wmod.quantize_cross_kv(cross)

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

    state["self_kv"][:, :, slot_ids, :prompt_pad] = self_kv_j
    for leaf in ("kv", "kv8"):
        if leaf in state["cross_kv"]:
            if leaf == "kv8":  # [L, 1, B, H, T, 2*hd]
                state["cross_kv"][leaf][:, :, slot_ids, :, :t_here] = cross[leaf]
            else:  # [L, 2, B, T, H, hd]
                state["cross_kv"][leaf][:, :, slot_ids, :t_here] = cross[leaf]
    if state["cross_kv"].get("scale") is not None:
        state["cross_kv"]["scale"][:, :, slot_ids] = cross["scale"]
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


def release(state: State, rows: torch.Tensor) -> None:
    """Free the slots of the [B] bool mask `rows`."""
    state["active"] &= ~rows
    state["finished"] &= ~rows


def pack_status(state: State) -> torch.Tensor:
    """Per-row packed status and tokens [B, 6 + ring] float32: active,
    finished, gen_len, sum_logprob, no-speech probability, winning lane (0:
    one lane per slot), then the row's sampled ring (token ids < 2^24 are
    exact in float32). One device-to-host copy of it per chunk carries every
    finished hypothesis with the scheduling state."""
    b = state["active"].shape[0]
    cols = [
        state["active"].float(), state["finished"].float(), state["gen_len"].float(),
        state["sum_logprob"], state["ns_prob"], torch.zeros(b, device=state["active"].device),
    ]
    return torch.cat([torch.stack(cols, dim=1), state["sampled"].float()], dim=1)


def unroll(row: np.ndarray, join_step: int, gen_len: int, ring: int) -> np.ndarray:
    """Ring-unroll one slot's tokens from its sampled row."""
    cols = (join_step + np.arange(gen_len)) % ring
    return row[cols]
