"""WhisperEngine in PyTorch: the window-path engine behind every session.

Port of whisperlive_tpu/engine/engine.py for the server's window-scheduler
path:

  prepare(audio)      log-mel -> encoder (K1) -> cross-attention KV
                      (-> packed int8 or int4 with per-channel scales);
                      prepare_mel the same from a seek window's features
  transcribe_batch    fused language ID + prompt splice + prefill + greedy
                      or temperature sampling loop (K2, K3, and K4 or
                      K7 per step), or beam search at T = 0
  decode_with_fallback  temperature-fallback retries of the items that
                      fail the quality gates, on a gathered cross-KV subset
                      (beam at T = 0, sampling on the retries)
  align_words         word timings of one decoded item: a teacher-forced
                      pass that returns the cross-attention maps, then DTW
                      on the host (engine/align.py)

PyTorch runs eagerly, so the JAX `lax.while_loop` becomes a Python loop on
the host whose only device-to-host sync per token is the termination check;
a chunked (preemptible) beam decode syncs once per segment instead.
Shapes stay bucketed (batch, prompt and generation budget) as in the JAX
engine.

With `shardings` (parallel/mesh.py EngineShardings, one process per rank)
the engine holds this rank's tensor-parallel slice of the weights: every
rank of a tp group builds the engine from the same full tree and then
calls the same methods in the same order (SPMD; the continuous path keeps
them in step through the op log of parallel/serve_multihost.py). The
logits are whole on every rank and every draw uses a generator seeded the
same way on each, so every rank samples the same tokens.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import threading
import zlib
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from whisperlive_tpu_torch.engine.tokenizer import (
    TokenSpec,
    WhisperTokenizer,
    get_suppressed_tokens,
)
from whisperlive_tpu_torch import device as device_policy
from whisperlive_tpu_torch.models import whisper as wmod
from whisperlive_tpu_torch.ops import decoding as dec
from whisperlive_tpu_torch.ops import mel as mel_ops
from whisperlive_tpu_torch.parallel import mesh as pmesh
from whisperlive_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16)
DEFAULT_PROMPT_BUCKETS = (16, 64, 256)


@dataclasses.dataclass(frozen=True)
class TranscribeOptions:
    """Per-request decode options; the same fields as the JAX engine's."""

    language: str | None = None
    task: str = "transcribe"
    temperatures: tuple[float, ...] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    compression_ratio_threshold: float | None = 2.4
    log_prob_threshold: float | None = -1.0
    no_speech_threshold: float | None = 0.6
    condition_on_previous_text: bool = True
    initial_prompt: str | None = None
    prefix: str | None = None
    hotwords: str | None = None
    suppress_blank: bool = True
    suppress_tokens: tuple[int, ...] | None = (-1,)
    without_timestamps: bool = False
    max_initial_timestamp: float = 1.0
    word_timestamps: bool = False
    repetition_penalty: float = 1.0
    max_new_tokens: int | None = None
    beam_size: int = 1
    best_of: int = 5
    length_penalty: float = 1.0
    patience: float = 1.0
    no_repeat_ngram_size: int = 0
    multilingual: bool = False
    language_detection_threshold: float | None = 0.5
    language_detection_segments: int = 1
    chunk_length: int | None = None
    prepend_punctuations: str = "\"'“¿([{-"
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、"
    hallucination_silence_threshold: float | None = None
    prompt_reset_on_temperature: float = 0.5
    clip_timestamps: str | tuple[float, ...] = "0"


@dataclasses.dataclass
class DecodeResult:
    """Per-item decode output (host numpy)."""

    tokens: np.ndarray  # sampled tokens, EOT stripped
    avg_logprob: float
    no_speech_prob: float
    compression_ratio: float
    temperature: float


def compression_ratio(text: str) -> float:
    """zlib compression ratio of the text (hallucination repetition gate)."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def best_failed_attempt(
    options: TranscribeOptions, attempts: list[DecodeResult]
) -> DecodeResult:
    """Every temperature failed the gates: keep the best attempt (highest
    avg_logprob among below-compression-ratio results, else among all),
    stamped with the final temperature."""
    below_cr = [
        a for a in attempts
        if options.compression_ratio_threshold is None
        or a.compression_ratio <= options.compression_ratio_threshold
    ]
    best = max(below_cr or attempts, key=lambda a: a.avg_logprob)
    return dataclasses.replace(best, temperature=attempts[-1].temperature)


def _rule_statics(options: TranscribeOptions) -> tuple[bool, int]:
    """(suppress_blank, max_initial_timestamp index); -1 keeps the spec's
    default of 1.0 s."""
    sb = bool(options.suppress_blank)
    mit = -1
    if (
        options.max_initial_timestamp is not None
        and float(options.max_initial_timestamp) != 1.0
    ):
        mit = max(int(round(float(options.max_initial_timestamp) / 0.02)), 0)
    return sb, mit


def fails_quality_gates(options: TranscribeOptions, r: DecodeResult) -> bool:
    """Temperature-fallback gate: re-decode on a compression-ratio or
    avg-logprob failure, unless the window is confidently silence."""
    needs = False
    if (
        options.compression_ratio_threshold is not None
        and r.compression_ratio > options.compression_ratio_threshold
    ):
        needs = True
    if (
        options.log_prob_threshold is not None
        and r.avg_logprob < options.log_prob_threshold
    ):
        needs = True
    if (
        options.no_speech_threshold is not None
        and r.no_speech_prob > options.no_speech_threshold
        and options.log_prob_threshold is not None
        and r.avg_logprob < options.log_prob_threshold
    ):
        needs = False
    return needs


def beam_lanes(options: TranscribeOptions) -> int:
    """Lanes of a beam decode: patience widens the pool to
    ceil(beam_size * patience), the frozen-lane analogue of CTranslate2's
    "collect beam_size * patience finished hypotheses"."""
    return max(options.beam_size,
               int(math.ceil(options.beam_size * max(options.patience, 1.0))))


@dataclasses.dataclass
class _BeamInputs:
    """A beam decode's loop invariants, tiled beam-major to B*K rows once
    per decode (the cross-KV too: one tiled copy serves every segment)."""

    k: int
    prompt_pad: int
    max_steps: int
    cross: dict
    prompts: torch.Tensor  # [BK, P]
    prompt_len: torch.Tensor  # [BK]
    ts_enabled: torch.Tensor  # [BK]
    suppress_mask: torch.Tensor  # [V]
    rep_penalty: float
    no_repeat_ngram: int
    phist: torch.Tensor | None
    sb_vec: torch.Tensor | None
    mit_vec: torch.Tensor | None
    ident: torch.Tensor  # [BK]
    later_lane: torch.Tensor  # [BK] lanes > 0, copies of lane 0 at step 0


@dataclasses.dataclass
class _BeamCarry:
    """The beam decode's state between steps and segments."""

    state: dec.SamplerState
    self_kv: torch.Tensor  # [L, 2, BK, C, H, hd]
    spare: torch.Tensor  # the parent gather's target; the two swap each step
    logits: torch.Tensor  # [BK, V] f32
    sum_lp: torch.Tensor  # [BK] cumulative beam scores


def _kv_array(cross_kv: dict) -> torch.Tensor:
    """The cross-KV's main array; its batch axis is 2 in every layout."""
    for leaf in ("kv8", "kv4", "kv"):
        if leaf in cross_kv:
            return cross_kv[leaf]
    raise KeyError(f"no cross-KV array in {sorted(cross_kv)}")


class WhisperEngine:
    """Owns the parameters on one device. All public methods take an
    internal lock: in serving only the scheduler thread calls in."""

    def __init__(
        self,
        cfg: wmod.WhisperConfig,
        params: wmod.Params,
        tokenizer: WhisperTokenizer | None = None,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        prompt_buckets: Sequence[int] = DEFAULT_PROMPT_BUCKETS,
        shardings: Any = None,
        decoder_int8: bool | None = None,
        cross_kv_bits: int | None = None,
        device: str | torch.device = "cuda",
        compute_dtype: torch.dtype | None = None,
    ):
        self.device = device_policy.resolve_device(device)
        self.shardings = shardings
        tp = 1
        if shardings is not None:
            if not isinstance(shardings, pmesh.EngineShardings):
                raise TypeError("shardings must be a parallel.mesh.EngineShardings (one "
                                f"process per rank), not {type(shardings).__name__}")
            shardings.validate(cfg)
            tp = shardings.tp
        # bf16 on CUDA (the kernels take bf16), float32 on the CPU
        if compute_dtype is None:
            compute_dtype = device_policy.default_compute_dtype(self.device)
        if self.device.type == "cuda" and compute_dtype != torch.bfloat16:
            raise ValueError(f"the CUDA kernels take bfloat16, not {compute_dtype}")
        self.cfg = cfg.replace(dtype=compute_dtype, tp=tp)
        self.tokenizer = tokenizer or WhisperTokenizer(
            TokenSpec(cfg.n_vocab, multilingual=cfg.n_vocab >= 51865)
        )
        self.spec = dec.DecodingSpec(
            n_vocab=cfg.n_vocab,
            eot=self.tokenizer.eot,
            blank=(self.tokenizer.encode(" ") or [220])[0],
            no_speech=self.tokenizer.no_speech,
            timestamp_begin=self.tokenizer.timestamp_begin,
            max_length=cfg.n_text_ctx,
        )
        self.batch_buckets = tuple(batch_buckets)
        self.prompt_buckets = tuple(p for p in prompt_buckets if p <= cfg.n_text_ctx)
        self.gen_buckets = (128, 256, cfg.n_text_ctx)
        # WL_CROSS_BITS is read once, here; int8 by default on CUDA
        if cross_kv_bits is None:
            env_bits = os.environ.get("WL_CROSS_BITS")
            quantized = device_policy.default_quantized(self.device)
            cross_kv_bits = int(env_bits) if env_bits else (8 if quantized else 16)
        if cross_kv_bits not in (4, 8, 16):
            raise ValueError(f"cross_kv_bits must be 4, 8 or 16, got {cross_kv_bits}")
        self.cross_kv_bits = cross_kv_bits
        self.params = wmod.cast_params(params, compute_dtype, self.device)
        self.decoder_int8 = (
            device_policy.default_quantized(self.device)
            if decoder_int8 is None else decoder_int8
        )
        if self.decoder_int8:
            self.params = wmod.quantize_decoder_weights(self.params)
        # the whole tree's fingerprint, for the op log's handshake
        self.params_fp = None
        if shardings is not None:
            self.params_fp = pmesh.params_fingerprint(self.params)
            # quantized whole, then sliced: a row-parallel shard quantized
            # alone would get other scales than the JAX engine's global
            # ones (its int8 runs on the global arrays)
            self.params = pmesh.shard_params(self.params, shardings)
        self._lock = threading.Lock()
        # device seconds of prepares (utils/profiling.py)
        self.device_timer = profiling.DeviceTimer(self.device)
        self._suppress_cache: dict[tuple, torch.Tensor] = {}
        self._lang_ids = torch.tensor(
            self.tokenizer.spec.all_language_tokens, dtype=torch.long, device=self.device
        )
        # Preemptible beamed decodes: > 0 runs beam search in segments of
        # this many steps with one host sync and the lock released between
        # them, so other threads' work (the continuous scheduler's chunks in
        # hybrid beam serving) interleaves; 0 is one monolithic decode.
        # WL_BEAM_CHUNK, read once here, wins over enable_beam_chunk.
        env_chunk = os.environ.get("WL_BEAM_CHUNK")
        self.beam_chunk = int(env_chunk) if env_chunk else 0
        self._beam_chunk_forced = env_chunk is not None

    # ------------------------------------------------------------------
    # device programs (run under the lock, in inference mode)
    # ------------------------------------------------------------------

    def _prepare(self, audio: torch.Tensor):
        with profiling.span("engine.prepare", device_s=None) as s:
            if audio.dtype == torch.int16:
                audio = audio.float() * (1.0 / 32767.0)
            return self._encode(mel_ops.log_mel_spectrogram(audio, n_mels=self.cfg.n_mels), s)

    def _prepare_mel(self, melspec: torch.Tensor):
        with profiling.span("engine.prepare", device_s=None) as s:
            return self._encode(melspec, s)

    def _encode(self, melspec: torch.Tensor, s: profiling.Span):
        """Encoder and cross-KV of the prepare span `s`, which the card
        paces: one event pair gives the span its device_s, read after a
        later sync (the log-mel before them copies its bases to the card,
        each copy a sync)."""
        with self.device_timer.time(s):
            enc = wmod.encode(self.params, self.cfg, melspec)
            cross = self.quantize_cross(wmod.compute_cross_kv(self.params, self.cfg, enc))
        return enc, cross

    def quantize_cross(self, cross: dict) -> dict:
        """Float cross-KV -> the engine's cross-KV width (int8, int4 or as is)."""
        if self.cross_kv_bits == 8:
            return wmod.quantize_cross_kv(cross)
        if self.cross_kv_bits == 4:
            return wmod.quantize_cross_kv_int4(cross)
        return cross

    def _detect(self, cross_kv: dict) -> torch.Tensor:
        """Language probabilities [B, n_languages] from one <|sot|> prefill."""
        cfg, dev = self.cfg, self.device
        b = _kv_array(cross_kv).shape[2]
        self_kv = wmod.init_self_kv(cfg, b, device=dev)
        sot = torch.full((b, 1), self.spec.eot + 1, dtype=torch.int32, device=dev)
        ones = torch.ones((b,), dtype=torch.int32, device=dev)
        logits = wmod.decode_prefill(self.params, cfg, sot, ones, self_kv, cross_kv)
        mask = torch.zeros((cfg.n_vocab,), dtype=torch.bool, device=dev)
        mask[self._lang_ids] = True
        logits = torch.where(mask[None, :], logits, dec.NEG_INF)
        return torch.softmax(logits, dim=-1)[:, self._lang_ids]

    def _decode(
        self,
        cross_kv: dict,
        prompts: torch.Tensor,  # [B, P] int32, right-padded
        prompt_len: torch.Tensor,  # [B]
        sot_idx: torch.Tensor,  # [B]
        suppress_mask: torch.Tensor,  # [V] bool
        ts_enabled: torch.Tensor,  # [B] bool
        temperature: torch.Tensor,  # [B] f32
        rep_penalty: float,
        max_new: int,
        seed: int,
        cache_len: int,
        no_repeat_ngram: int,
        suppress_blank: bool,
        max_init_idx: int,
        span: profiling.Span,
    ):
        """Prefill, then the sampling loop. Returns (sampled [B, G], gen_len,
        sum_logprob, no_speech_prob). span: the engine.decode span, given
        its steps."""
        cfg, spec, dev = self.cfg, self.spec, self.device
        b, prompt_pad = prompts.shape
        sb_vec = None if suppress_blank else torch.zeros((1,), dtype=torch.bool, device=dev)
        mit_vec = (
            None if max_init_idx < 0
            else torch.full((1,), max_init_idx, dtype=torch.int32, device=dev)
        )
        max_gen = cache_len - prompt_pad
        self_kv = wmod.init_self_kv(cfg, b, cache_len, device=dev)
        state = dec.init_sampler_state(spec, prompt_len, max_gen)
        logits, sot_logits = wmod.decode_prefill(
            self.params, cfg, prompts, prompt_len, self_kv, cross_kv, sot_idx=sot_idx
        )
        no_speech_prob = torch.softmax(sot_logits, dim=-1)[:, spec.no_speech]
        max_steps = min(max_new, max_gen)
        phist = (
            dec.right_align_prompt(prompts, prompt_len) if no_repeat_ngram > 0 else None
        )
        gen = torch.Generator(device=dev).manual_seed(seed)
        while True:
            filtered = dec.apply_logit_rules(
                spec, logits, state, suppress_mask, ts_enabled,
                suppress_blank=sb_vec, max_initial_ts_idx=mit_vec,
            )
            filtered = dec.apply_repetition_penalty(
                filtered, state, rep_penalty, prompt_tokens=prompts, prompt_len=prompt_len,
            )
            filtered = dec.apply_no_repeat_ngram(
                filtered, state, no_repeat_ngram, prompt_hist=phist
            )
            next_tok, lp = dec.sample_next(filtered, temperature, gen)
            slot = prompt_pad + state.step  # batch-uniform cache slot
            pos = state.prompt_len + state.step  # per-item logical position
            state = dec.advance_state(spec, state, next_tok, lp)
            span.attrs["steps"] = state.step
            if state.step >= max_steps:
                state = state._replace(finished=torch.ones_like(state.finished))
                break
            if bool(state.finished.all()):  # the loop's one host sync
                break
            logits = wmod.decode_step(
                self.params, cfg, next_tok, pos, slot, prompt_len, prompt_pad,
                self_kv, cross_kv,
            )
        return state.sampled, state.gen_len, state.sum_logprob, no_speech_prob

    def _beam_start(
        self,
        cross_kv: dict,
        prompts: torch.Tensor,  # [B, P]
        prompt_len: torch.Tensor,  # [B]
        sot_idx: torch.Tensor,  # [B]
        suppress_mask: torch.Tensor,  # [V]
        ts_enabled: torch.Tensor,  # [B]
        rep_penalty: float,
        max_new: int,
        cache_len: int,
        no_repeat_ngram: int,
        suppress_blank: bool,
        max_init_idx: int,
        beam_size: int,
    ) -> tuple[_BeamInputs, _BeamCarry, torch.Tensor]:
        """Prefill at B, then the carry and the invariants tiled beam-major
        to B*K rows. Returns (inputs, carry, no_speech_prob [B])."""
        cfg, spec, dev = self.cfg, self.spec, self.device
        b, prompt_pad = prompts.shape
        k = beam_size
        bk = b * k
        max_gen = cache_len - prompt_pad
        self_kv0 = wmod.init_self_kv(cfg, b, cache_len, device=dev)
        last_logits, sot_logits = wmod.decode_prefill(
            self.params, cfg, prompts, prompt_len, self_kv0, cross_kv, sot_idx=sot_idx
        )
        no_speech_prob = torch.softmax(sot_logits, dim=-1)[:, spec.no_speech]

        def tile(x):
            return x.repeat_interleave(k, dim=0)

        prompts_bk, plen_bk = tile(prompts), tile(prompt_len)
        inputs = _BeamInputs(
            k=k, prompt_pad=prompt_pad, max_steps=min(max_new, max_gen),
            cross=wmod.tree_map(lambda a: a.repeat_interleave(k, dim=2), cross_kv),
            prompts=prompts_bk, prompt_len=plen_bk, ts_enabled=tile(ts_enabled),
            suppress_mask=suppress_mask, rep_penalty=rep_penalty,
            no_repeat_ngram=no_repeat_ngram,
            phist=dec.right_align_prompt(prompts_bk, plen_bk) if no_repeat_ngram > 0 else None,
            sb_vec=None if suppress_blank else torch.zeros((1,), dtype=torch.bool, device=dev),
            mit_vec=(None if max_init_idx < 0
                     else torch.full((1,), max_init_idx, dtype=torch.int32, device=dev)),
            ident=torch.arange(bk, device=dev),
            later_lane=torch.arange(bk, device=dev) % k > 0,
        )
        self_kv = self_kv0.repeat_interleave(k, dim=2)
        carry = _BeamCarry(
            state=dec.init_sampler_state(spec, plen_bk, max_gen),
            self_kv=self_kv, spare=torch.empty_like(self_kv), logits=tile(last_logits),
            sum_lp=torch.zeros((bk,), dtype=torch.float32, device=dev),
        )
        return inputs, carry, no_speech_prob

    def _beam_step(self, inp: _BeamInputs, c: _BeamCarry, gate) -> torch.Tensor:
        """One expansion: the logit rules on B*K rows, f32 log-softmax,
        finished lanes frozen to EOT at an unchanged score, the step-0
        duplicate-lane penalty, top-K over K*V per item, and the parent
        gather of the sampler state and the self-KV cache (one index_select
        into the spare buffer, then the two swap). gate: None, or a device
        bool that is False once every lane has finished; such a step then
        changes no score or lane (a segment runs on without a host sync).
        Returns the chosen tokens [BK], the decode step's input."""
        spec, st = self.spec, c.state
        filtered = dec.apply_logit_rules(
            spec, c.logits, st, inp.suppress_mask, inp.ts_enabled,
            suppress_blank=inp.sb_vec, max_initial_ts_idx=inp.mit_vec,
        )
        filtered = dec.apply_repetition_penalty(
            filtered, st, inp.rep_penalty, prompt_tokens=inp.prompts, prompt_len=inp.prompt_len,
        )
        filtered = dec.apply_no_repeat_ngram(filtered, st, inp.no_repeat_ngram,
                                             prompt_hist=inp.phist)
        parent, next_tok, new_sum = dec.beam_select(
            filtered, c.sum_lp, st.finished, inp.later_lane if st.step == 0 else None, inp.k,
            spec.eot)
        if gate is not None:
            parent = torch.where(gate, parent, inp.ident)
            new_sum = torch.where(gate, new_sum, c.sum_lp)
        st = st._replace(
            sampled=st.sampled[parent], gen_len=st.gen_len[parent], last_ts=st.last_ts[parent],
            finished=st.finished[parent], sum_logprob=st.sum_logprob[parent],
        )
        c.self_kv, c.spare = dec.gather_lanes(c.self_kv, c.spare, parent)
        tok_lp = new_sum - c.sum_lp[parent]
        c.sum_lp = new_sum
        c.state = dec.advance_state(spec, st, next_tok, tok_lp)
        return next_tok

    def _beam_run(self, inp: _BeamInputs, c: _BeamCarry, n_steps: int, sync_each: bool,
                  span: profiling.Span | None = None) -> bool:
        """Up to n_steps beam steps on the carry; True once the decode is
        done. sync_each: stop on the first step after which every lane has
        finished (one host sync a step, as the greedy loop); otherwise the
        caller syncs once after the segment, and steps after the last lane
        finished are gated into no-ops. span: the engine.decode span, given
        the steps."""
        attrs = span.attrs if span is not None else {}
        for i in range(n_steps):
            gate = None if sync_each or i == 0 else ~c.state.finished.all()
            slot = inp.prompt_pad + c.state.step  # batch-uniform cache slot
            pos = c.state.prompt_len + c.state.step
            next_tok = self._beam_step(inp, c, gate)
            attrs["steps"] = c.state.step
            if c.state.step >= inp.max_steps:
                c.state = c.state._replace(finished=torch.ones_like(c.state.finished))
                return True
            if sync_each and bool(c.state.finished.all()):  # the loop's one host sync
                return True
            c.logits = wmod.decode_step(
                self.params, self.cfg, next_tok, pos, slot, inp.prompt_len, inp.prompt_pad,
                c.self_kv, inp.cross,
            )
        return False

    @staticmethod
    def _beam_best(c: _BeamCarry, k: int, length_penalty: float):
        """The best lane of each item by sum / len^penalty (CTranslate2's
        convention): (sampled [B, G], gen_len [B], sum_logprob [B])."""
        st = c.state
        lengths = st.gen_len.float().clamp(min=1.0)
        score = st.sum_logprob / lengths**length_penalty
        b = score.shape[0] // k
        best = torch.argmax(score.reshape(b, k), dim=1) + torch.arange(b, device=score.device) * k
        return st.sampled[best], st.gen_len[best], st.sum_logprob[best]

    def _decode_beam(self, beam_args: tuple, beam_size: int, length_penalty: float,
                     span: profiling.Span | None = None):
        """Batched beam search at T = 0 (the reference transcriber decodes
        at beam 5, transcriber_faster_whisper.py:1394-1407) in one
        monolithic loop under the lock, or, with beam_chunk > 0, in
        preemptible segments of beam_chunk steps: after each segment the
        host syncs once on whether every lane has finished, with the lock
        released, and that gap is where other threads' work runs. The two
        are token-exact by construction (the same step; the steps a segment
        runs after its last lane finished change nothing). Returns (sampled,
        gen_len, sum_logprob, no_speech_prob). span: the engine.decode
        span (_beam_run)."""
        chunk = int(self.beam_chunk)
        with self._lock:
            inp, carry, ns_prob = self._beam_start(*beam_args, beam_size=beam_size)
            if chunk <= 0:
                self._beam_run(inp, carry, inp.max_steps, sync_each=True, span=span)
                return (*self._beam_best(carry, beam_size, length_penalty), ns_prob)
        while True:
            with self._lock:
                done = self._beam_run(inp, carry, chunk, sync_each=False, span=span)
                done = done or bool(carry.state.finished.all())  # the segment's one sync
            if done:
                break
        with self._lock:
            return (*self._beam_best(carry, beam_size, length_penalty), ns_prob)

    def enable_beam_chunk(self, steps: int = 24) -> None:
        """Opt into preemptible beamed decodes (hybrid beam serving, where
        beamed full re-decodes share the card with continuous chunks). No-op
        when WL_BEAM_CHUNK pinned a value (including 0) or a caller already
        set one."""
        if not self._beam_chunk_forced and not self.beam_chunk:
            self.beam_chunk = steps

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def suppress_mask_for(self, options: TranscribeOptions) -> torch.Tensor:
        key = options.suppress_tokens
        if key not in self._suppress_cache:
            ids = get_suppressed_tokens(self.tokenizer, options.suppress_tokens)
            self._suppress_cache[key] = dec.build_suppress_mask(
                self.cfg.n_vocab, ids, self.device
            )
        return self._suppress_cache[key]

    def build_prompt(
        self,
        options: TranscribeOptions,
        previous_tokens: Sequence[int] = (),
        language: str | None = None,
        context_preseeded: bool = False,
    ) -> tuple[list[int], int]:
        """[<|sot_prev|> prev...] + sot-sequence + prefix tokens. Returns
        (prompt_tokens, sot_index). The serving default is the JAX engine's
        policy: initial_prompt on every window, previous text gated by
        condition_on_previous_text. context_preseeded=True is the offline
        seek loop's contract: it seeds initial_prompt into its rolling
        context itself and conditions through prompt_reset_since, so
        previous_tokens ride ungated and initial_prompt is not re-added."""
        tok = self.tokenizer
        prev: list[int] = []
        if options.hotwords and not options.prefix:
            prev += tok.encode(" " + options.hotwords.strip())
        if context_preseeded:
            prev += list(previous_tokens)
        else:
            if options.initial_prompt:
                prev += tok.encode(" " + options.initial_prompt.strip())
            if previous_tokens and options.condition_on_previous_text:
                prev += list(previous_tokens)
        prev = prev[-(self.cfg.n_text_ctx // 2 - 1):]

        lang = language or options.language
        seq_tok = WhisperTokenizer(tok.spec, tok.backend, language=lang, task=options.task)
        tail = list(seq_tok.sot_sequence(include_timestamps=not options.without_timestamps))
        if options.prefix:
            prefix_tokens = tok.encode(" " + options.prefix.strip())
            tail.extend(prefix_tokens[-(self.cfg.n_text_ctx // 2 - 1):])

        pmax = self.prompt_buckets[-1]
        head_budget = pmax - len(tail)
        if prev and head_budget >= 2:
            prev = prev[-(head_budget - 1):]
        elif prev:
            logger.warning(
                "prompt overflow: dropping all %d previous/hotword tokens "
                "(tail alone is %d of %d slots)", len(prev), len(tail), pmax
            )
            prev = []
        if len(tail) > pmax:
            logger.warning(
                "prompt overflow: truncating prefix — prompt tail %d > "
                "largest prompt bucket %d", len(tail), pmax
            )
            tail = tail[:pmax]

        prompt: list[int] = []
        if prev:
            prompt.append(tok.sot_prev)
            prompt.extend(prev)
        sot_index = len(prompt)
        prompt.extend(tail)
        return prompt, sot_index

    def _pad_prompts(self, prompts: list[list[int]]) -> tuple[np.ndarray, np.ndarray]:
        pmax = _bucket(max(len(p) for p in prompts), self.prompt_buckets)
        arr = np.zeros((len(prompts), pmax), np.int32)
        lens = np.zeros((len(prompts),), np.int32)
        for i, p in enumerate(prompts):
            p = p[:pmax]
            arr[i, : len(p)] = p
            lens[i] = len(p)
        return arr, lens

    def _cache_len(self, prompt_pad: int, requested: int) -> int:
        """Static self-KV length: prompt bucket + generation-budget bucket."""
        return min(
            prompt_pad + _bucket(min(requested, self.cfg.n_text_ctx), self.gen_buckets),
            self.cfg.n_text_ctx,
        )

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def gather_cross(self, cross_kv: dict, idx: Sequence[int]) -> dict:
        """Rows `idx` of the cross-KV along its batch axis (axis 2 in every
        layout): the fallback sub-batch and best_of tiling gather."""
        index = torch.as_tensor(list(idx), dtype=torch.long, device=self.device)
        return wmod.tree_map(lambda a: a.index_select(2, index), cross_kv)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def warmup(
        self,
        batch_sizes: Sequence[int] | None = None,
        options: TranscribeOptions | None = None,
    ) -> None:
        """Run the serving path once per batch bucket before traffic (on
        CUDA this also builds the kernels)."""
        from whisperlive_tpu_torch.serving.session import SessionOptions
        from whisperlive_tpu_torch.serving.backends import transcribe_options_from_session

        if options is None:
            options = transcribe_options_from_session(SessionOptions())
        if batch_sizes is None:
            batch_sizes = {self.batch_buckets[0], self.batch_buckets[-1]}
        for b in sorted(set(batch_sizes)):
            logger.info("warmup: batch=%d", b)
            audio = np.zeros((b, mel_ops.N_SAMPLES), np.float32)
            prompt, sot = self.build_prompt(options, language="en")
            if options.beam_size > 1:
                # beamed serving takes the split path: prepare, detect and
                # the beam program
                _, cross = self.prepare(audio)
                if self.tokenizer.spec.multilingual:
                    self.detect_language_from_cross(cross)
                self.decode_batch(cross, [prompt] * b, [sot] * b, options)
            else:
                self.transcribe_batch(audio, [prompt] * b, [sot] * b, [True] * b, options)
        # the split path of word-timestamp requests and fallback retries:
        # prepare, detect, plain decode
        b = sorted(set(batch_sizes))[0]
        _, cross = self.prepare(np.zeros((b, mel_ops.N_SAMPLES), np.float32))
        if self.tokenizer.spec.multilingual:
            self.detect_language_from_cross(cross)
        prompt, sot = self.build_prompt(options, language="en")
        self.decode_batch(cross, [prompt] * b, [sot] * b, options)
        logger.info("warmup complete")

    @torch.inference_mode()
    def prepare(self, audio: np.ndarray):
        """audio [B, N_SAMPLES] f32 or int16 PCM -> (enc, cross_kv) on the
        engine's device. int16 is divided by 32767, as the JAX engine does."""
        audio = np.asarray(audio)
        if audio.dtype != np.int16:
            audio = audio.astype(np.float32, copy=False)
        with self._lock:
            return self._prepare(self._tensor(audio))

    @torch.inference_mode()
    def prepare_mel(self, melspec: np.ndarray):
        """melspec [B, N_FRAMES, n_mels] log-mel features (a seek window of
        ops/mel.log_mel_full) -> (enc, cross_kv) on the engine's device."""
        with self._lock:
            return self._prepare_mel(self._tensor(np.asarray(melspec, np.float32)))

    def detect_language_from_cross(self, cross_kv: dict) -> list[tuple[str, float]]:
        codes = self.tokenizer.spec.language_codes
        out = []
        for row in self.detect_language_probs_from_cross(cross_kv):
            i = int(np.argmax(row))
            out.append((codes[i], float(row[i])))
        return out

    @torch.inference_mode()
    def detect_language_probs_from_cross(self, cross_kv: dict) -> np.ndarray:
        """Per-language probability rows aligned with language_codes."""
        with profiling.span("engine.detect"), self._lock:
            probs = self._detect(cross_kv).cpu().numpy()
        self.device_timer.settle()  # the copy has synced: the prepare's pair is done
        return probs

    @torch.inference_mode()
    def decode_batch(
        self,
        cross_kv: dict,
        prompts: list[list[int]],
        sot_indices: Sequence[int],
        options: TranscribeOptions,
        temperatures: Sequence[float] | None = None,
        seed: int = 0,
    ) -> list[DecodeResult]:
        """One decode pass over a prepared batch (cross_kv batch dim already
        padded to a bucket, >= len(prompts)): beam search when beam_size > 1
        and every temperature is 0, else the sampling loop."""
        b = _kv_array(cross_kv).shape[2]
        assert len(prompts) <= b
        n_real = len(prompts)
        prompts = list(prompts) + [[self.spec.eot + 1]] * (b - n_real)
        sot_idx = list(sot_indices) + [0] * (b - n_real)
        if temperatures is None:
            temperatures = [options.temperatures[0]] * n_real

        # best_of (T > 0 only): tile each item K times, keep the best by
        # average log-probability, when the tiled batch fits a bucket
        k_bo = 1
        if (
            options.best_of > 1
            and n_real > 0
            and all(t > 0 for t in temperatures[:n_real])
            and n_real * options.best_of <= self.batch_buckets[-1]
        ):
            k_bo = options.best_of
            bucket = _bucket(n_real * k_bo, self.batch_buckets)
            gather = list(np.repeat(np.arange(n_real), k_bo)) + [0] * (bucket - n_real * k_bo)
            cross_kv = self.gather_cross(cross_kv, gather)
            b = bucket
            prompts = [prompts[i] for i in range(n_real) for _ in range(k_bo)] + [
                [self.spec.eot + 1]
            ] * (b - n_real * k_bo)
            sot_idx = [sot_indices[i] for i in range(n_real) for _ in range(k_bo)] + [0] * (
                b - n_real * k_bo
            )
            temperatures = [temperatures[i] for i in range(n_real) for _ in range(k_bo)]
            n_tiled = n_real * k_bo
        else:
            n_tiled = n_real
        temps = np.asarray(list(temperatures) + [0.0] * (b - n_tiled), np.float32)
        prompt_arr, prompt_len = self._pad_prompts(prompts)
        tokens, gen_len, sum_lp, ns_prob = self._run_decode(
            options, cross_kv, self._tensor(prompt_arr), self._tensor(prompt_len),
            self._tensor(np.asarray(sot_idx, np.int32)), temps, seed,
        )
        results = self._extract_results(tokens, gen_len, sum_lp, ns_prob, temps, n_tiled)
        if k_bo == 1:
            return results
        return [
            max(results[i * k_bo : (i + 1) * k_bo], key=lambda r: r.avg_logprob)
            for i in range(n_real)
        ]

    def _run_decode(self, options: TranscribeOptions, cross_kv: dict, prompts: torch.Tensor,
                    prompt_len: torch.Tensor, sot_idx: torch.Tensor, temps: np.ndarray,
                    seed: int):
        """The decode of a prepared batch: beam search when beam_size > 1 and
        every temperature is 0 (fallback retries at T > 0 sample, as the
        reference's beam-to-sampling escalation), else the sampling loop.
        Returns (sampled [B, G], gen_len, sum_logprob, no_speech_prob)."""
        requested = (
            options.max_new_tokens if options.max_new_tokens is not None
            else self.cfg.n_text_ctx
        )
        b, prompt_pad = prompts.shape
        head = (cross_kv, prompts, prompt_len, sot_idx, self.suppress_mask_for(options),
                self._tensor(~np.full((b,), options.without_timestamps)))
        rules = (options.no_repeat_ngram_size, *_rule_statics(options))
        cache_len = self._cache_len(prompt_pad, requested)
        # the decode's host time and its steps
        with profiling.span("engine.decode", steps=0) as s:
            if options.beam_size > 1 and not temps.any():
                out = self._decode_beam(
                    (*head, options.repetition_penalty, int(requested), cache_len, *rules),
                    beam_lanes(options), options.length_penalty, span=s,
                )
            else:
                with self._lock:
                    out = self._decode(*head, self._tensor(temps), options.repetition_penalty,
                                       int(requested), seed, cache_len, *rules, span=s)
        return out

    def _extract_results(
        self, tokens, gen_len, sum_lp, ns_prob, temps, n_real
    ) -> list[DecodeResult]:
        with profiling.span("engine.results"):
            tokens = tokens.cpu().numpy()
            self.device_timer.settle()  # the copy has synced: the prepare's pair is done
            gen_len = gen_len.cpu().numpy()
            sum_lp = sum_lp.cpu().numpy()
            ns_prob = ns_prob.float().cpu().numpy()
            results = []
            for i in range(n_real):
                sampled = tokens[i, : gen_len[i]]
                ended_with_eot = len(sampled) > 0 and sampled[-1] == self.spec.eot
                text_tokens = sampled[:-1] if ended_with_eot else sampled
                denom = len(text_tokens) + 1  # whisper convention: +1 for EOT
                text = self.tokenizer.decode([int(t) for t in text_tokens])
                results.append(
                    DecodeResult(
                        tokens=text_tokens.astype(np.int32),
                        avg_logprob=float(sum_lp[i]) / max(denom, 1),
                        no_speech_prob=float(ns_prob[i]),
                        compression_ratio=compression_ratio(text),
                        temperature=float(temps[i]),
                    )
                )
            return results

    @torch.inference_mode()
    def transcribe_batch_async(
        self,
        audio: np.ndarray,  # [B_bucket, N_SAMPLES] float32
        prompts: list[list[int]],
        sot_indices: Sequence[int],
        lang_known: Sequence[bool],
        options: TranscribeOptions,
        seed: int = 0,
    ) -> "_PendingBatch":
        """Attempt-1 transcription of a window batch: prepare, then language
        ID for the items whose language is unknown (the detected token is
        spliced into their prompt on the device), prefill and the sampling
        loop. Returns a handle whose resolve() copies the results to the
        host. The decode loop syncs on its termination check each step, so
        the handle's work is done when it is returned. With beam_size > 1
        at T = 0 the decode is the beam program."""
        b = audio.shape[0]
        _, cross_kv = self.prepare(audio)
        n_real = len(prompts)
        prompts = list(prompts) + [[self.spec.eot + 1]] * (b - n_real)
        sot_idx = np.asarray(list(sot_indices) + [0] * (b - n_real), np.int32)
        known = np.asarray(list(lang_known) + [True] * (b - n_real))
        temps = np.full((b,), options.temperatures[0], np.float32)
        prompt_arr, prompt_len = self._pad_prompts(prompts)
        with self._lock:
            prompts_t = self._tensor(prompt_arr)
            sot_t = self._tensor(sot_idx)
            if self.tokenizer.spec.multilingual:
                lang_probs = self._detect(cross_kv)
                detected = self._lang_ids[torch.argmax(lang_probs, dim=-1)].to(torch.int32)
                rows = torch.arange(b, device=self.device)
                lang_pos = (sot_t + 1).clamp(0, prompt_arr.shape[1] - 1).long()
                given = prompts_t[rows, lang_pos]
                prompts_t[rows, lang_pos] = torch.where(self._tensor(known), given, detected)
            else:
                lang_probs = torch.zeros((b, 1), dtype=torch.float32, device=self.device)
        tokens, gen_len, sum_lp, ns_prob = self._run_decode(
            options, cross_kv, prompts_t, self._tensor(prompt_len), sot_t, temps, seed)
        return _PendingBatch(
            self, tokens, gen_len, sum_lp, ns_prob, lang_probs, temps, n_real, cross_kv
        )

    def transcribe_batch(
        self,
        audio: np.ndarray,
        prompts: list[list[int]],
        sot_indices: Sequence[int],
        lang_known: Sequence[bool],
        options: TranscribeOptions,
        seed: int = 0,
    ) -> tuple[list[DecodeResult], list[tuple[str, float]], Any]:
        """Attempt-1 transcription of a window batch. Returns (results,
        [(language, prob)] per item, cross_kv); retry gate failures with
        decode_with_fallback at the next temperatures."""
        return self.transcribe_batch_async(
            audio, prompts, sot_indices, lang_known, options, seed=seed
        ).resolve()

    def align_words(
        self,
        cross_kv: dict,
        item_index: int,
        text_tokens: Sequence[int],
        num_frames: int,
        merge: bool = True,
        cross_len: int | None = None,
        prepend_punctuations: str = "\"'“¿([{-",
        append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
        language: str | None = None,
        task: str = "transcribe",
    ):
        """Word timings of one decoded window item (cross-attention DTW): one
        teacher-forced B = 1 pass over [sot sequence + text + eot] against
        the item's row of the cross-KV, then DTW on the host
        (engine/align.py). merge=False returns the raw timings.
        language/task condition the teacher-forcing sot sequence (its length
        is the same for every language)."""
        prep = self.align_prepare(text_tokens, language=language, task=task)
        if prep is None:
            return []
        arr, sot_len, text_tokens = prep
        if cross_len is None:  # the whole context of the given cross-KV
            kv = _kv_array(cross_kv)
            cross_len = kv.shape[3] if "kv" in cross_kv else kv.shape[4]
        logits, maps = self.align_maps(
            self.gather_cross(cross_kv, [item_index]), arr, cross_len,
            sot_len + len(text_tokens) + 1, num_frames,
        )
        return self.align_finish(
            logits, maps, text_tokens, sot_len, num_frames, merge=merge,
            prepend_punctuations=prepend_punctuations,
            append_punctuations=append_punctuations,
        )

    @torch.inference_mode()
    def align_maps(self, cross_kv: dict, arr: np.ndarray, cross_len: int, seq_len: int,
                   num_frames: int) -> tuple[np.ndarray, np.ndarray]:
        """The alignment pass of one item (cross_kv holds its row alone):
        decode_with_cross_attn over the token array [1, pmax], then the
        logits' first seq_len rows and the maps' first seq_len rows and
        num_frames // 2 positions, cut on the device before the copy
        (find_alignment_from_attn reads no more) and copied to the host as
        float32: (logits [1, seq_len, V], maps [L, 1, H, seq_len, frames])."""
        frames = max(num_frames // 2, 1)
        with self._lock:
            logits, maps = wmod.decode_with_cross_attn(
                self.params, self.cfg, self._tensor(arr), cross_kv,
                cross_len=torch.tensor([cross_len], dtype=torch.int32, device=self.device),
            )
            maps = self._gather_heads(maps[:, :, :, :seq_len, :frames].float())
            return logits[:, :seq_len].cpu().numpy(), maps.cpu().numpy()

    def _gather_heads(self, maps: torch.Tensor) -> torch.Tensor:
        """Cross-attention maps [L, B, H, ...] with every head: under tensor
        parallelism the model group's heads side by side, in rank order."""
        if self.cfg.tp == 1:
            return maps
        parts = [torch.empty_like(maps) for _ in range(self.cfg.tp)]
        dist.all_gather(parts, maps.contiguous(), group=self.shardings.model_group)
        return torch.cat(parts, dim=2)

    def align_prepare(self, text_tokens: Sequence[int], language: str | None = None,
                      task: str = "transcribe"):
        """Host half 1 of word alignment: the bucketed teacher-forcing token
        array for [sot sequence + text + eot]. Returns (arr [1, pmax],
        sot_len, text_tokens), or None when no text token remains."""
        tok = self.tokenizer
        text_tokens = [int(t) for t in text_tokens if t < tok.eot]
        if not text_tokens:
            return None
        seq_tok = tok
        if language is not None:
            seq_tok = WhisperTokenizer(tok.spec, tok.backend, language=language, task=task)
        seq = seq_tok.sot_sequence() + text_tokens + [tok.eot]
        sot_len = len(seq) - len(text_tokens) - 1
        pmax = _bucket(len(seq), self.prompt_buckets)
        arr = np.zeros((1, pmax), np.int32)
        arr[0, : len(seq)] = seq[:pmax]
        return arr, sot_len, text_tokens

    def align_finish(
        self,
        logits: np.ndarray,  # [1, T, V] (or [T, V])
        cross: np.ndarray,  # [L, 1, H, T, ctx] (or [L, H, T, ctx])
        text_tokens: list[int],
        sot_len: int,
        num_frames: int,
        merge: bool = True,
        prepend_punctuations: str = "\"'“¿([{-",
        append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    ):
        """Host half 2 of word alignment: token probabilities, DTW and the
        punctuation merge; numpy only, so it runs on any thread."""
        from whisperlive_tpu_torch.engine import align as align_mod

        tok = self.tokenizer
        if logits.ndim == 3:
            logits = logits[0]
        if cross.ndim == 5:
            cross = cross[:, 0]
        seq_len = sot_len + len(text_tokens) + 1
        # the token probability is a softmax over the text vocabulary only
        # (openai's find_alignment renormalizes logits[:, :eot])
        probs = []
        for i, t in enumerate(text_tokens):
            row = logits[sot_len - 1 + i][: tok.eot]
            row = row - row.max()
            p = np.exp(row)
            probs.append(float(p[t] / p.sum()))
        timings = align_mod.find_alignment_from_attn(
            cross[:, :, :seq_len, :], np.asarray(probs, np.float64), tok, text_tokens,
            sot_len, num_frames,
        )
        if not merge:
            return timings
        return align_mod.merge_punctuations(timings, prepend_punctuations, append_punctuations)

    def decode_with_fallback(
        self,
        cross_kv: dict,
        prompts: list[list[int]],
        sot_indices: Sequence[int],
        options: TranscribeOptions,
        seed: int = 0,
    ) -> list[DecodeResult]:
        """Temperature fallback: items failing the compression-ratio or
        avg-logprob gate are re-decoded, only that sub-batch, at the next
        temperature."""
        n = len(prompts)
        results: list[DecodeResult | None] = [None] * n
        history: list[list[DecodeResult]] = [[] for _ in range(n)]
        pending = list(range(n))
        sub_cross = cross_kv
        sub_prompts, sub_sot = list(prompts), list(sot_indices)

        for t_i, temp in enumerate(options.temperatures):
            decoded = self.decode_batch(
                sub_cross, sub_prompts, sub_sot, options,
                temperatures=[temp] * len(sub_prompts), seed=seed + t_i,
            )
            still_failed = []
            for j, item in enumerate(pending):
                r = decoded[j]
                results[item] = r
                history[item].append(r)
                if fails_quality_gates(options, r):
                    still_failed.append(item)
            pending = still_failed
            if not pending or t_i == len(options.temperatures) - 1:
                break
            # gather the failing sub-batch, padded to a batch bucket by
            # repeating the last index (padding rows decode and are dropped)
            bucket = _bucket(len(pending), self.batch_buckets)
            sub_cross = self.gather_cross(
                cross_kv, (pending + [pending[-1]] * bucket)[:bucket]
            )
            sub_prompts = [prompts[item] for item in pending]
            sub_sot = [sot_indices[item] for item in pending]

        for item in pending:
            results[item] = best_failed_attempt(options, history[item])
        return [r for r in results if r is not None]


class _PendingBatch:
    """A decoded window batch whose outputs are still device tensors;
    resolve() copies them to the host and builds DecodeResults."""

    def __init__(self, engine, tokens, gen_len, sum_lp, ns_prob, lang_probs,
                 temps, n_real, cross_kv):
        self._engine = engine
        self._outs = (tokens, gen_len, sum_lp, ns_prob)
        self._lang_probs = lang_probs
        self._temps = temps
        self._n_real = n_real
        self.cross_kv = cross_kv

    def resolve(self):
        """-> (results, [(language, prob)] per item, cross_kv)."""
        eng = self._engine
        results = eng._extract_results(*self._outs, self._temps, self._n_real)
        langs: list[tuple[str, float]] = []
        if eng.tokenizer.spec.multilingual:
            lang_probs = self._lang_probs.float().cpu().numpy()
            codes = eng.tokenizer.spec.language_codes
            for i in range(self._n_real):
                j = int(np.argmax(lang_probs[i]))
                langs.append((codes[j], float(lang_probs[i][j])))
        else:
            langs = [("en", 1.0)] * self._n_real
        return results, langs, self.cross_kv
