"""Decode-step-level continuous batching: windows join a running decode.

Port of whisperlive_tpu/engine/continuous.py for greedy slot pools. B fixed
slots decode together in lockstep on the card, and new windows are
inserted into free slots at chunk boundaries (every `steps_per_chunk`
steps) while other slots are mid-generation. The invariants of the JAX
design hold:

  * every self-KV write goes to one batch-uniform column: slots at
    different generation depths share one global step counter, and a
    slot's tokens live at ring offsets (join_step + i) % ring;
  * shapes are fixed per pool (slots, ring, cross cap) and per insert
    bucket (wave size, encoder context);
  * the slot state lives on the card between chunks (continuous_state.py);
    the host copies one packed status array per chunk.

Fallback-temperature retries are ordinary re-inserts, so a retry does not
stall the other streams.

ContinuousEngine is the slot pool (insert, step, release, harvest);
ContinuousScheduler drains a request queue into it from one worker thread
and is submit-compatible with BatchScheduler. Not ported yet, each raising
NotImplementedError naming its ROADMAP.md item: beam lanes and word
timestamps (6a) and speculative rounds (10); WhisperEngine itself refuses
shardings (15) and int4 cross-KV (K7).
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from whisperlive_tpu_torch.engine import continuous_state as cstate
from whisperlive_tpu_torch.engine.continuous_step import step_chunk
from whisperlive_tpu_torch.engine.engine import (
    NOT_PORTED_ALIGN,
    NOT_PORTED_BEAM,
    DecodeResult,
    TranscribeOptions,
    WhisperEngine,
    _bucket,
    compression_ratio,
    fails_quality_gates,
)
from whisperlive_tpu_torch.engine.scheduler import BatchRequest, assemble_result
from whisperlive_tpu_torch.ops import mel as mel_ops
from whisperlive_tpu_torch.utils import metrics as wl_metrics

logger = logging.getLogger(__name__)

INSERT_BUCKETS = (1, 2, 4, 8)
# overloaded() bound: sustained (resident + queued) load over slots
OVERLOAD_FACTOR = 3.0

NOT_PORTED_BEAM_LANES = (
    "continuous beam lanes (beam_width > 1) are not ported yet: ROADMAP.md open item 6a"
)
NOT_PORTED_SPEC = (
    "speculative continuous batching (draft_engine, spec_k) is not ported yet: "
    "ROADMAP.md open item 10"
)


@dataclasses.dataclass
class _SlotInfo:
    """Host-side mirror of one device slot."""

    req: BatchRequest
    options: TranscribeOptions
    join_step: int
    temp_index: int
    language: Optional[str]
    language_prob: float
    duration: float
    submitted_at: float
    # incremental partial decoding: the full carried hypothesis (the
    # decoder saw it as prompt); harvest prepends it
    prefix: tuple = ()


class ContinuousEngine:
    """The slot pool: device-resident state plus insert/step/release."""

    def __init__(
        self,
        engine: WhisperEngine,
        n_slots: int = 16,
        prompt_pad: int = 64,
        ring: int = 256,
        steps_per_chunk: int = 8,
        options: TranscribeOptions | None = None,
        cross_ctx: int | None = None,
        enc_buckets: tuple[int, ...] | None = None,
        beam_width: int = 1,
        draft_engine: Optional[WhisperEngine] = None,
        spec_k: int = 4,
    ):
        if max(int(beam_width), 1) != 1:
            raise NotImplementedError(NOT_PORTED_BEAM_LANES)
        if draft_engine is not None:
            raise NotImplementedError(NOT_PORTED_SPEC)
        self.eng = engine
        self.n_slots = n_slots
        self.beam_width = 1
        self.prompt_pad = prompt_pad
        self.ring = ring
        self.steps_per_chunk = steps_per_chunk
        self.cache_len = prompt_pad + ring
        cfg = engine.cfg
        # Content-capped cross-KV: streaming windows are a few seconds of
        # audio padded to 30 s, so slots keep only the first cross_ctx
        # encoder positions; every decode step reads all resident cross-KV.
        # Longer windows are routed to the window scheduler (max_window_s).
        if cross_ctx is None:
            cross_ctx = 640 if cfg.n_audio_ctx >= 1500 else cfg.n_audio_ctx
        self.cross_ctx = min(cross_ctx, cfg.n_audio_ctx)
        self.max_window_s = self.cross_ctx * (30.0 / cfg.n_audio_ctx)
        # Reduced-context encoder buckets: a short tail is encoded at the
        # smallest bucket that holds it (512 positions = 10.24 s), and the
        # slot's cross_len masks the stale tail of its cross region. Only
        # with a content cap; with the full context every window encodes
        # fully.
        if enc_buckets is None:
            enc_buckets = (512,) if self.cross_ctx < cfg.n_audio_ctx else ()
        self.enc_buckets = tuple(
            b for b in sorted(set(enc_buckets)) if 0 < b < cfg.n_audio_ctx
        ) + (cfg.n_audio_ctx,)
        base_options = options or TranscribeOptions()
        self.suppress_mask = engine.suppress_mask_for(base_options)
        # the step applies this one suppress mask; requests with another
        # suppress configuration are routed to the window scheduler
        self.suppress_key = (base_options.suppress_tokens, base_options.suppress_blank)
        self.state: Optional[cstate.State] = None
        self.gstep = 0
        # host record of each row's options: the step skips the sampler's
        # draw and the penalty's scatters when no row needs them
        self._row_temp = np.zeros(n_slots, np.float32)
        self._row_rep = np.ones(n_slots, np.float32)
        self._gen: Optional[torch.Generator] = None

    # ------------------------------------------------------------------

    def init_state(self, seed: int = 0) -> None:
        eng = self.eng
        self.state = cstate.init_state(
            eng.cfg, eng.spec, self.n_slots, self.prompt_pad, self.ring, self.cross_ctx,
            eng.cross_kv_bits, eng.device,
        )
        self.gstep = 0
        self._row_temp[:] = 0.0
        self._row_rep[:] = 1.0
        self._gen = torch.Generator(device=eng.device).manual_seed(seed)

    def insert(
        self,
        windows: np.ndarray,  # [j, N_SAMPLES] audio
        prompts: list[list[int]],
        sot_idx: list[int],
        lang_known: list[bool],
        slot_ids: list[int],
        temps: list[float],
        ts_en: list[bool],
        rep: list[float],
        max_new: list[int],
        need_langs: bool = True,
        last_ts: Optional[list[int]] = None,
        has_prefix: Optional[list[bool]] = None,
        pfx_last_ts: Optional[list[bool]] = None,
        pfx_penult_ts: Optional[list[bool]] = None,
        enc_ctx: Optional[int] = None,
        length_penalty: Optional[list[float]] = None,
    ) -> Optional[np.ndarray]:
        """Insert j requests into the given free slots. Returns the language
        probabilities, or None when need_langs=False (then nothing is copied
        back to the host). The wave is padded to an insert bucket by
        repeating its last request and slot. enc_ctx: encoder positions for
        the wave (an enc_buckets entry); every window must fit."""
        eng = self.eng
        j = len(slot_ids)
        bucket = _bucket(j, INSERT_BUCKETS)
        if enc_ctx is None:
            enc_ctx = eng.cfg.n_audio_ctx
        n_samples = min(enc_ctx * 2 * mel_ops.HOP_LENGTH, mel_ops.N_SAMPLES)
        audio = np.zeros((bucket, n_samples), np.float32)
        for i in range(bucket):
            src = windows[min(i, j - 1)][:n_samples]
            audio[i, : len(src)] = src

        def pad(xs):
            return list(xs) + [xs[-1]] * (bucket - j)

        # Boundary clamp: drop head tokens before the sot index first
        # (previous-text conditioning); if the steering tail alone still
        # overflows, truncate its end.
        prompts = list(prompts)
        sot_idx = list(sot_idx)
        for i, p in enumerate(prompts):
            if len(p) > self.prompt_pad:
                over = len(p) - self.prompt_pad
                drop = min(over, int(sot_idx[i]))
                logger.warning(
                    "insert prompt (%d) exceeds continuous prompt region (%d); dropping %d "
                    "conditioning tokens%s", len(p), self.prompt_pad, drop,
                    "" if drop == over else " and truncating the tail",
                )
                p = list(p)[drop:]
                sot_idx[i] = int(sot_idx[i]) - drop
                prompts[i] = p[: self.prompt_pad]

        parr, plen = eng._pad_prompts(pad(prompts))
        parr = parr[:, : self.prompt_pad]
        if parr.shape[1] < self.prompt_pad:
            parr = np.pad(parr, [(0, 0), (0, self.prompt_pad - parr.shape[1])])
        rows = {
            "last_ts": last_ts or [eng.spec.timestamp_begin - 1] * j,
            "has_prefix": has_prefix or [False] * j,
            "pfx_last_ts": pfx_last_ts or [False] * j,
            "pfx_penult_ts": pfx_penult_ts or [False] * j,
            "length_penalty": length_penalty or [1.0] * j,
            "temperature": temps, "ts_enabled": ts_en, "rep_penalty": rep, "max_new": max_new,
        }
        t = eng._tensor
        with eng._lock:
            lang_probs = cstate.insert(
                eng, self.state, self.gstep, self.cross_ctx, t(audio), t(parr), t(plen),
                t(np.asarray(pad(sot_idx), np.int32)), t(np.asarray(pad(lang_known), bool)),
                t(np.asarray(pad(slot_ids), np.int64)),
                {name: t(np.asarray(pad(list(v)))) for name, v in rows.items()},
            )
        self._row_temp[list(slot_ids)] = temps
        self._row_rep[list(slot_ids)] = rep
        if not need_langs:
            return None
        return lang_probs.float().cpu().numpy()[:j]

    def step(self) -> np.ndarray:
        """Run one chunk of decode steps; returns the packed per-row status
        and tokens [n_slots, 6 + ring] (continuous_state.pack_status), the
        chunk's one device-to-host copy."""
        eng = self.eng
        with eng._lock:
            step_chunk(
                eng, self.state, self.gstep, self.steps_per_chunk, self.ring,
                self.prompt_pad, self.suppress_mask,
                sampling=bool((self._row_temp > 0).any()),
                penalty=bool((self._row_rep != 1.0).any()),
                generator=self._gen,
            )
            self.gstep += self.steps_per_chunk
            return cstate.pack_status(self.state).cpu().numpy()

    def release(self, slot_ids: list[int]) -> None:
        mask = np.zeros((self.n_slots,), bool)
        mask[list(slot_ids)] = True
        with self.eng._lock:
            cstate.release(self.state, self.eng._tensor(mask))
        self._row_temp[mask] = 0.0
        self._row_rep[mask] = 1.0

    def harvest_all(self) -> np.ndarray:
        """The whole sampled ring in one copy: [B, ring] int32."""
        return self.state["sampled"].cpu().numpy()

    unroll = staticmethod(cstate.unroll)

    def unroll_row(self, status_row: np.ndarray, join_step: int, gen_len: int) -> np.ndarray:
        """One slot's hypothesis from its packed status row."""
        toks = status_row[6 : 6 + self.ring].astype(np.int32)
        return cstate.unroll(toks, join_step, gen_len, self.ring)

    def harvest(self, slot: int, join_step: int, gen_len: int) -> np.ndarray:
        """One finished slot's sampled tokens, ring-unrolled."""
        row = self.state["sampled"][slot].cpu().numpy()
        return cstate.unroll(row, join_step, gen_len, self.ring)


class ContinuousScheduler:
    """Slot scheduler: drains a request queue into free slots and keeps the
    chunked decode loop running. submit() is API-compatible with
    BatchScheduler so the serving backend can switch freely."""

    def __init__(
        self,
        engine: WhisperEngine,
        n_slots: int = 16,
        steps_per_chunk: int = 8,
        # room for the sot sequence plus an incremental prefix (~150 tokens
        # of carried hypothesis) in one prefill
        prompt_pad: int = 192,
        # one window samples at most ring - 1 tokens
        ring: int = 128,
        options: TranscribeOptions | None = None,
        cross_ctx: int | None = None,
        enc_buckets: tuple[int, ...] | None = None,
        beam_width: int = 1,
        draft_engine: Optional[WhisperEngine] = None,
        spec_k: int = 4,
    ):
        self.engine = engine
        self.cb = ContinuousEngine(
            engine, n_slots=n_slots, prompt_pad=prompt_pad, ring=ring,
            steps_per_chunk=steps_per_chunk, options=options, cross_ctx=cross_ctx,
            enc_buckets=enc_buckets, beam_width=beam_width, draft_engine=draft_engine,
            spec_k=spec_k,
        )
        self.beam_width = self.cb.beam_width
        # routing hints for TorchBackend: windows longer than the content
        # cap, or with another suppress configuration, go to the window path
        self.max_window_s = self.cb.max_window_s
        self.suppress_key = self.cb.suppress_key
        self._queue: "queue.Queue[Optional[BatchRequest]]" = queue.Queue()
        self._pending: list[tuple[BatchRequest, int]] = []  # (req, temp_idx)
        # fair grant: least-recently-served uid first, FIFO within a uid
        self._uid_seq: dict[str, int] = {}
        self._insert_seq = 0
        # backpressure: EMA of (resident + queued) / slots
        self._load_ema = 0.0
        self._service_ema = 1.0  # seconds per request, rough prior
        self._slots: dict[int, _SlotInfo] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.max_batch_size = self.cb.n_slots
        # host time of each worker-loop phase (insert dispatch, step chunk
        # including its status copy, harvest), summed over ticks
        self.tick_stats = {
            "ticks": 0, "insert_s": 0.0, "step_s": 0.0, "harvest_s": 0.0,
            "insert_calls": 0, "insert_windows": 0,
            # occupied slots summed over ticks (free slots' rows K5 skips)
            "step_rows": 0,
        }

    # ------------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        if self.cb.state is None:
            self.cb.init_state()
        self._thread = threading.Thread(
            target=self._worker_loop, name="gpu-continuous-scheduler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def submit(self, request: BatchRequest):
        if request.options.word_timestamps:
            request.future.set_exception(NotImplementedError(NOT_PORTED_ALIGN))
        elif request.options.beam_size > 1:
            request.future.set_exception(NotImplementedError(NOT_PORTED_BEAM))
        else:
            self._queue.put(request)
        return request.future

    def overloaded(self, bound: float | None = None) -> bool:
        """True when sustained (resident + queued) load exceeds `bound` x
        slots: the serving layer's signal to make new connections wait."""
        return self._load_ema > (OVERLOAD_FACTOR if bound is None else bound)

    def estimated_wait_s(self) -> float:
        """Rough head-of-queue wait at the observed service time."""
        return len(self._pending) * self._service_ema / max(self.cb.n_slots, 1)

    def load_factor(self) -> float:
        """Sustained (resident + queued) / slots; > 1 means requests queue."""
        return self._load_ema

    def warmup(self) -> None:
        """Run every insert bucket at every encoder bucket, a step chunk and
        a release once (on the card this also builds the kernels), then
        start from a fresh state."""
        eng = self.engine
        if self.cb.state is None:
            self.cb.init_state()
        prompt, sot = eng.build_prompt(TranscribeOptions(), language="en")
        max_bucket = _bucket(self.cb.n_slots, INSERT_BUCKETS)
        for enc_ctx in self.cb.enc_buckets:
            for j in INSERT_BUCKETS:
                if j > max_bucket:
                    continue
                slots = [min(i, self.cb.n_slots - 1) for i in range(j)]
                self.cb.insert(
                    np.zeros((j, mel_ops.N_SAMPLES), np.float32), [prompt] * j, [sot] * j,
                    [True] * j, slots, [0.0] * j, [True] * j, [1.0] * j, [8] * j,
                    enc_ctx=enc_ctx,
                )
        self.cb.step()
        self.cb.release([0])
        self.cb.init_state()
        logger.info("continuous scheduler warmup complete")

    # ------------------------------------------------------------------

    def _drain_queue(self, block: bool) -> bool:
        """Move queued requests into the pending list. A None sentinel from
        stop() ends the drain when the stop flag is set; a stale one from an
        earlier stop()/start() cycle is skipped."""
        got = False
        try:
            timeout = 0.05 if block else 0.0
            while True:
                req = self._queue.get(block=block and not got, timeout=timeout)
                if req is None:
                    if self._stop.is_set():
                        return got
                    continue
                self._pending.append((req, 0))
                got = True
                block = False
        except queue.Empty:
            return got

    def _do_inserts(self) -> None:
        free = [b for b in range(self.cb.n_slots) if b not in self._slots]
        if not free or not self._pending:
            return
        k = min(len(free), max(INSERT_BUCKETS))
        # least-recently-served uid first (stable: FIFO within a uid)
        order = sorted(
            range(len(self._pending)),
            key=lambda i: self._uid_seq.get(self._pending[i][0].uid, -1),
        )
        chosen = sorted(order[:k])  # the wave keeps arrival order
        take = [self._pending[i] for i in chosen]
        picked = set(chosen)
        self._pending = [p for i, p in enumerate(self._pending) if i not in picked]
        for req, _ in take:
            self._uid_seq[req.uid] = self._insert_seq
        self._insert_seq += 1
        self._rebind_audio(take)
        if len(self._uid_seq) > 4096:  # bound stale-uid growth
            cut = sorted(self._uid_seq.values())[len(self._uid_seq) // 2]
            self._uid_seq = {u: s for u, s in self._uid_seq.items() if s >= cut}
        # one insert per encoder-context bucket
        groups: dict[int, list] = {}
        for item in take:
            groups.setdefault(self._enc_bucket_for(item[0]), []).append(item)
        for enc_ctx, group in groups.items():
            g_free, free = free[: len(group)], free[len(group):]
            try:
                self._insert_take(group, g_free, enc_ctx=enc_ctx)
                self.tick_stats["insert_calls"] += 1
                self.tick_stats["insert_windows"] += len(group)
            except Exception as e:
                # the taken requests are in neither _pending nor _slots:
                # fail their futures here or their clients wait to timeout
                logger.exception("insert failed; failing %d requests", len(group))
                wl_metrics.track_error("continuous_insert")
                for req, _ in group:
                    if not req.future.done():
                        req.future.set_exception(e)

    def _rebind_audio(self, take) -> None:
        """Late-bind first attempts to their stream's current tail at slot
        grant (same anchor, more audio), clamped to the content cap. Retries
        keep the audio their earlier attempts decoded."""
        cap = int(self.max_window_s * mel_ops.SAMPLE_RATE)
        for req, temp_idx in take:
            if req.refresh_audio is None or temp_idx > 0 or req.audio_rebound:
                continue
            req.audio_rebound = True
            try:
                fresh = req.refresh_audio()
            except Exception:
                logger.exception("refresh_audio failed; keeping snapshot")
                continue
            if fresh is None or len(fresh) < len(req.audio):
                continue
            req.audio = np.asarray(fresh, np.float32)[:cap]
            req.audio_bound_at = time.monotonic()

    def _enc_bucket_for(self, req: BatchRequest) -> int:
        """Smallest encoder-context bucket holding the request's window."""
        need = -(-min(len(req.audio), mel_ops.N_SAMPLES) // (2 * mel_ops.HOP_LENGTH))
        for b in self.cb.enc_buckets:
            if need <= b:
                return b
        return self.cb.enc_buckets[-1]

    def _prompt_for(self, req: BatchRequest, opt: TranscribeOptions, lang: str):
        """(prompt, sot index, forced prefix) of one request within the
        prompt region. An incremental prefix gets the region's room first
        and is prefilled whole, so the continued tokens keep the positions
        of a from-scratch decode; a prefix that does not fit is dropped."""
        eng, pad = self.engine, self.cb.prompt_pad
        prefix = tuple(req.prefix_tokens) if not opt.prefix else ()
        if prefix:
            p, s = eng.build_prompt(opt, language=lang)
            room = pad - len(p)
            if len(prefix) > room:
                prefix = ()
            else:
                spare = room - len(prefix)
                if spare >= 8 and req.previous_tokens:
                    prev = tuple(req.previous_tokens)[-(spare - 1):]
                    p2, s2 = eng.build_prompt(opt, previous_tokens=prev, language=lang)
                    if len(p2) + len(prefix) <= pad:
                        p, s = p2, s2
                return p + [int(t) for t in prefix], s, prefix
        p, s = eng.build_prompt(opt, previous_tokens=req.previous_tokens, language=lang)
        if len(p) > pad:
            # trim the previous-text conditioning first; build_prompt re-adds
            # initial_prompt/hotwords, so then drop head tokens before the
            # sot index, and as a last resort truncate the steering tail
            keep = max(pad - (len(p) - len(req.previous_tokens)) - 1, 0)
            p, s = eng.build_prompt(
                opt, previous_tokens=tuple(req.previous_tokens)[-keep:] if keep else (),
                language=lang,
            )
            if len(p) > pad:
                drop = min(len(p) - pad, s)
                p, s = p[drop:][:pad], s - drop
        return p, s, ()

    def _insert_take(self, take, free, enc_ctx: int) -> None:
        eng = self.engine
        ts_begin = eng.spec.timestamp_begin
        windows, prompts, sots, lk, slot_ids = [], [], [], [], []
        temps, ts_en, rep, max_new, infos = [], [], [], [], []
        last_ts_init, has_prefix, pfx_last_ts, pfx_penult_ts, length_pen = [], [], [], [], []
        for (req, temp_idx), slot in zip(take, free):
            opt = req.options
            a = req.audio[: mel_ops.N_SAMPLES]
            buf = np.zeros(mel_ops.N_SAMPLES, np.float32)
            buf[: len(a)] = a
            lang = req.language or opt.language
            p, s, prefix = self._prompt_for(req, opt, lang or "en")
            windows.append(buf)
            prompts.append(p)
            sots.append(s)
            lk.append(lang is not None)
            slot_ids.append(slot)
            temps.append(opt.temperatures[min(temp_idx, len(opt.temperatures) - 1)])
            ts_en.append(not opt.without_timestamps)
            rep.append(opt.repetition_penalty)
            length_pen.append(opt.length_penalty)
            budget = self.cb.ring - 1
            if opt.max_new_tokens is not None:
                cap = opt.max_new_tokens
                if prefix:
                    # the prefix counts toward the window budget; keep a
                    # small sampling floor so the decode can extend it
                    cap = max(8, cap - len(prefix))
                budget = min(budget, cap)
            max_new.append(budget)
            lts = ts_begin - 1
            for t in reversed(prefix):
                if t >= ts_begin:
                    lts = int(t)
                    break
            last_ts_init.append(lts)
            has_prefix.append(bool(prefix))
            pfx_last_ts.append(bool(prefix) and prefix[-1] >= ts_begin)
            # a missing penultimate counts as a timestamp (the ring rules'
            # gen_len < 2 convention)
            pfx_penult_ts.append(bool(prefix) and (len(prefix) < 2 or prefix[-2] >= ts_begin))
            infos.append(_SlotInfo(
                req=req, options=opt, join_step=self.cb.gstep, temp_index=temp_idx,
                language=lang, language_prob=1.0, duration=len(a) / mel_ops.SAMPLE_RATE,
                submitted_at=req.submitted_at, prefix=prefix,
            ))
        need_langs = eng.tokenizer.spec.multilingual and any(
            info.language is None for info in infos
        )
        lang_probs = self.cb.insert(
            np.stack(windows), prompts, sots, lk, slot_ids, temps, ts_en, rep, max_new,
            need_langs=need_langs, last_ts=last_ts_init, has_prefix=has_prefix,
            pfx_last_ts=pfx_last_ts, pfx_penult_ts=pfx_penult_ts, enc_ctx=enc_ctx,
            length_penalty=length_pen,
        )
        codes = eng.tokenizer.spec.language_codes
        for i, (info, slot) in enumerate(zip(infos, slot_ids)):
            if info.language is None and lang_probs is not None:
                li = int(np.argmax(lang_probs[i]))
                info.language = codes[li]
                info.language_prob = float(lang_probs[i][li])
            elif info.language is None:
                info.language = "en"
            self._slots[slot] = info

    def _harvest(self, status: np.ndarray) -> None:
        """Resolve the finished slots from the chunk's status copy (no
        further device copy), queue gate failures for another insert, and
        release the finished slots."""
        eng = self.engine
        done_slots = [
            b for b in list(self._slots) if status[b, 0] > 0.5 and status[b, 1] > 0.5
        ]
        if not done_slots:
            return
        for b in done_slots:
            info = self._slots.pop(b)
            gen_len = int(status[b, 2])
            sum_lp = float(status[b, 3])
            ns_prob = float(status[b, 4])
            toks = self.cb.unroll_row(status[b], info.join_step, gen_len)
            if info.prefix:
                toks = np.concatenate([np.asarray(info.prefix, np.int32), toks])
            toks = toks[toks != eng.spec.eot]
            text = eng.tokenizer.decode([int(t) for t in toks])
            res = DecodeResult(
                tokens=toks,
                # for a prefix continuation this averages the newly sampled
                # tokens only (the prefix was prefilled, not scored)
                avg_logprob=sum_lp / max(gen_len, 1),
                no_speech_prob=ns_prob,
                compression_ratio=compression_ratio(text),
                temperature=info.options.temperatures[
                    min(info.temp_index, len(info.options.temperatures) - 1)
                ],
            )
            opt = info.options
            gate_opt = opt
            if info.prefix and gen_len < 12 and opt.log_prob_threshold is not None:
                # a tail-only average over a few tokens is too noisy for the
                # log-prob gate; the compression-ratio gate still applies
                gate_opt = dataclasses.replace(opt, log_prob_threshold=None)
            final_failed = fails_quality_gates(gate_opt, res)
            if final_failed:
                if info.prefix:
                    # the carried hypothesis may be what failed: retry from
                    # scratch at the same temperature first
                    info.req.prefix_tokens = ()
                    self._pending.append((info.req, info.temp_index))
                    continue
                if info.temp_index + 1 < len(opt.temperatures):
                    self._pending.append((info.req, info.temp_index + 1))
                    continue
            self._resolve(info, res, final_failed)
        self.cb.release(done_slots)

    def _resolve(self, info: _SlotInfo, res: DecodeResult, final_failed: bool) -> None:
        try:
            result = assemble_result(
                self.engine, info.req, res, info.duration,
                language=info.language or "en", language_prob=info.language_prob,
                prefix_ok=not final_failed,
            )
            if not info.req.future.done():
                info.req.future.set_result(result)
            service_s = time.monotonic() - info.submitted_at
            self._service_ema += 0.1 * (service_s - self._service_ema)
            wl_metrics.track_transcription_latency(service_s)
            wl_metrics.track_audio_seconds(info.duration)
        except Exception as e:
            if not info.req.future.done():
                info.req.future.set_exception(e)

    def _worker_loop(self) -> None:
        logger.info("continuous scheduler started (slots=%d chunk=%d)",
                    self.cb.n_slots, self.cb.steps_per_chunk)
        while not self._stop.is_set():
            try:
                idle = not self._slots and not self._pending
                self._drain_queue(block=idle)
                if self._stop.is_set():
                    break
                load = (len(self._slots) + len(self._pending)) / max(self.cb.n_slots, 1)
                self._load_ema += 0.05 * (load - self._load_ema)
                t0 = time.monotonic()
                self._do_inserts()
                t1 = time.monotonic()
                if not self._slots:
                    continue
                occupied = len(self._slots)
                status = self.cb.step()
                t2 = time.monotonic()
                self._harvest(status)
                t3 = time.monotonic()
                ts = self.tick_stats
                ts["ticks"] += 1
                ts["insert_s"] += t1 - t0
                ts["step_s"] += t2 - t1
                ts["harvest_s"] += t3 - t2
                ts["step_rows"] += occupied
            except Exception as e:
                logger.exception("continuous scheduler iteration failed")
                wl_metrics.track_error("continuous_scheduler")
                # fail every resident and queued request, free every slot
                for info in self._slots.values():
                    if not info.req.future.done():
                        info.req.future.set_exception(e)
                for req, _ in self._pending:
                    if not req.future.done():
                        req.future.set_exception(e)
                self._pending.clear()
                if self._slots:
                    try:
                        self.cb.release(list(self._slots))
                    except Exception:
                        logger.exception("slot release failed; resetting state")
                        self.cb.init_state()
                self._slots.clear()
        logger.info("continuous scheduler stopped")
