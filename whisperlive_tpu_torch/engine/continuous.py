"""Decode-step-level continuous batching: windows join a running decode.

Port of whisperlive_tpu/engine/continuous.py. B fixed
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

On the card, a plain greedy pool (one lane a slot, no draft, no row
sampling at T > 0 or with a repetition penalty, no tensor parallelism)
replays its decode step from a CUDA graph: the first such chunk runs
eagerly, then one step is captured with the global step in a device
tensor, and each later chunk sets that tensor and replays the graph
steps_per_chunk times. The same kernels do the same work without the
per-launch host dispatch. Every other chunk, and every chunk on the CPU,
runs eagerly.

Fallback-temperature retries are ordinary re-inserts, so a retry does not
stall the other streams.

Word timestamps ride this path: at harvest the slot's cross-KV is still on
the card, so the alignment pass runs against it (align_fetch) before the
slot is released, and the host DTW runs on the assemble thread.

Beam search rides it too: beam_width = K gives each slot K contiguous
lockstep lanes, with coupled beam expansion at T = 0 and independent
best_of sampling at T > 0 retries (continuous_step.py). Not routed here
(the window scheduler serves them): no_repeat_ngram, and beam widths other
than the pool's lane count.

With a draft engine (draft_engine, spec_k) every chunk iteration is a
speculative verify round (continuous_step.spec_chunk): the draft proposes
spec_k tokens per slot, the target scores [cur, d1..dk] in one windowed
pass and per-slot acceptance masks mark the rejected ring tail. Every slot
advances k+2 ring columns per round at a batch-uniform base column, so the
lockstep invariants hold; greedy output is token-exact against the plain
pool for any draft, and the ring budget becomes ring/(k+2) rounds per
window, so a low-acceptance draft shortens a window's token budget instead
of corrupting it.

ContinuousEngine is the slot pool (insert, step, release, harvest);
ContinuousScheduler drains a request queue into it from one worker thread
and is submit-compatible with BatchScheduler.

Over a [dp, tp] grid (an engine built with shardings, parallel/mesh.py;
one process per rank) the slots shard over the data group when dp divides
them (`dp_sharded`): a rank owns the slots [dp_index * n / dp, (dp_index +
1) * n / dp) and holds state for those alone, an insert encodes and
prefills only on the tp group that owns its slot (so the collectives stay
inside that group), and every rank steps its own rows. Every rank calls
every op with the same global arguments in the same order (the op log of
parallel/serve_multihost.py keeps followers in step with the leader's
scheduler); a read of the step status, of the sampled plane, of the
language probabilities or of an alignment pass is a gather or broadcast
over the data group that every rank enters at the same point.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from whisperlive_tpu_torch.engine import continuous_state as cstate
from whisperlive_tpu_torch.engine.continuous_step import spec_chunk, step_chunk
from whisperlive_tpu_torch.engine.engine import (
    DecodeResult,
    TranscribeOptions,
    WhisperEngine,
    _bucket,
    compression_ratio,
    fails_quality_gates,
)
from whisperlive_tpu_torch.engine.scheduler import BatchRequest, assemble_result
from whisperlive_tpu_torch.engine.speculative import check_draft
from whisperlive_tpu_torch.ops.attention import MAX_WINDOW
from whisperlive_tpu_torch.ops import _kernels
from whisperlive_tpu_torch.ops import mel as mel_ops
from whisperlive_tpu_torch.utils import metrics as wl_metrics
from whisperlive_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

INSERT_BUCKETS = (1, 2, 4, 8)
# overloaded() bound: sustained (resident + queued) load over slots
OVERLOAD_FACTOR = 3.0


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
    # valid encoder positions of the slot's cross-KV (the alignment at
    # harvest masks the same tail)
    cross_len: int = 0
    # the slot's harvest (time.monotonic_ns): the end of the request's
    # request.resident span and the start of its request.resolve
    harvested_ns: int = 0


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
        self.eng = engine
        self.n_slots = n_slots
        # each slot owns beam_width contiguous lane rows
        self.beam_width = max(int(beam_width), 1)
        self.n_rows = n_slots * self.beam_width
        # dp x tp serving: with a data group of dp replicas the slots shard
        # over it when dp divides them (a slot's lanes never straddle two
        # replicas); each replica decodes its own slots, and the step runs
        # no collective across replicas
        self.shardings = getattr(engine, "shardings", None)
        sh = self.shardings
        self.dp_sharded = sh is not None and sh.dp > 1 and n_slots % sh.dp == 0
        if sh is not None and sh.dp > 1 and not self.dp_sharded:
            logger.warning(
                "slot rows (%d = %d slots x %d lanes) do not divide dp=%d; slot state "
                "stays unsharded over the data axis (size the pool as a multiple of dp "
                "to use all replicas)", self.n_rows, n_slots, self.beam_width, sh.dp,
            )
        # the slots this rank holds state for: [slot_base, slot_base + local)
        self.local_slots = n_slots // sh.dp if self.dp_sharded else n_slots
        self.slot_base = sh.dp_index * self.local_slots if self.dp_sharded else 0
        self.prompt_pad = prompt_pad
        self.draft = draft_engine
        self.spec_k = int(spec_k) if draft_engine is not None else 0
        if draft_engine is not None:
            if self.beam_width != 1:
                raise ValueError("speculative continuous batching requires beam_width=1 "
                                 "(beam lanes and draft lanes both multiply slot rows)")
            if not 1 <= self.spec_k <= MAX_WINDOW - 1:
                # the k+1-token verify window must fit the Tq <= 8 window kernels
                raise ValueError(f"spec_k must be in [1, {MAX_WINDOW - 1}], got {spec_k}")
            check_draft(engine, draft_engine)
            # a verify round writes ring columns [gstep % ring, +k+1] as one
            # contiguous block, k+2 wide: column 0 holds cur's K/V, columns
            # 1..a+1 the committed tokens, so a fully accepted round still
            # stores its bonus at column k+1; (k+2) | ring keeps every block
            # inside the ring
            kp2 = self.spec_k + 2
            ring = -(-ring // kp2) * kp2
        self.ring = ring
        self.steps_per_chunk = steps_per_chunk
        # host-side gstep advance per step() call: a round takes k+2 steps
        self.gstep_per_chunk = steps_per_chunk * (self.spec_k + 2 if self.spec_k else 1)
        # a speculative pool's status also carries the committed-token mask
        self.status_width = 6 + (2 * ring if self.spec_k else ring)
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
        # host record of each slot's options: the step skips the sampler's
        # draw and the penalty's scatters when no slot needs them
        self._row_temp = np.zeros(n_slots, np.float32)
        self._row_rep = np.ones(n_slots, np.float32)
        self._gen: Optional[torch.Generator] = None
        # the captured greedy step: (graph, device gstep, the launches one
        # replay enqueues, the addresses it was captured over)
        self._graph: Optional[tuple] = None
        # decode steps replayed and run eagerly, and captures, since the
        # pool was built; last_graph: whether the last chunk was replayed
        self.graph_stats = {"graph_steps": 0, "eager_steps": 0, "graph_captures": 0}
        self.last_graph = False

    # ------------------------------------------------------------------

    # Multi-process serving hook (parallel/serve_multihost.py): True on the
    # engine whose ops are published to follower ranks. The scheduler
    # dispatches every device op (the alignment pass included) from its
    # worker thread in every mode, so no op needs gating here.
    multihost = False

    def _fetch(self, x: torch.Tensor, rows: bool = False) -> np.ndarray:
        """Device-to-host copy of a state value. rows: x is a plane of this
        rank's slot rows, gathered over the data group first (a collective
        every rank enters at the same op) into the whole pool's rows."""
        if rows and self.dp_sharded:
            parts = [torch.empty_like(x) for _ in range(self.shardings.dp)]
            dist.all_gather(parts, x.contiguous(), group=self.shardings.data_group)
            x = torch.cat(parts)
        return x.cpu().numpy()

    def _stage(self, x, dtype=None) -> torch.Tensor:
        """Host-to-device copy of an op argument (the same host bytes on
        every rank)."""
        return self.eng._tensor(np.asarray(x, dtype) if dtype is not None else np.asarray(x))

    def owner(self, slot: int) -> int:
        """The data replica (dp index) that holds slot's state."""
        return slot // self.local_slots if self.dp_sharded else 0

    def _mine(self, slot: int) -> bool:
        return not self.dp_sharded or self.owner(slot) == self.shardings.dp_index

    def init_state(self, seed: int = 0) -> None:
        """An empty pool: the state's tensors are emptied in place once they
        exist, so a captured step survives (warm-up, error recovery)."""
        eng = self.eng
        if self.state is not None:
            cstate.reset_state(self.state, eng.spec, self.ring, self.cross_ctx)
        else:
            self.state = cstate.init_state(
                eng.cfg, eng.spec, self.local_slots * self.beam_width, self.prompt_pad,
                self.ring, self.cross_ctx, eng.cross_kv_bits, eng.device, draft=self.draft,
                lanes=self.beam_width,
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
        the wave (an enc_buckets entry); every window must fit. A
        dp-sharded pool seats on each replica the part of the wave whose
        slots it owns (none: no device work there)."""
        n_wave = len(slot_ids)
        keep = [i for i, s in enumerate(slot_ids) if self._mine(s)]
        lang_probs = None
        if keep:
            def sub(xs):
                return None if xs is None else [xs[i] for i in keep]

            lang_probs = self._insert_local(
                np.asarray(windows)[keep], sub(prompts), sub(sot_idx), sub(lang_known),
                [slot_ids[i] - self.slot_base for i in keep], sub(temps), sub(ts_en),
                sub(rep), sub(max_new), sub(last_ts), sub(has_prefix), sub(pfx_last_ts),
                sub(pfx_penult_ts), enc_ctx, sub(length_penalty))
        self._row_temp[list(slot_ids)] = temps
        self._row_rep[list(slot_ids)] = rep
        if not need_langs:
            return None
        if not self.dp_sharded:
            return self._fetch(lang_probs.float())[:n_wave]
        # each replica fills the rows of its own part of the wave
        eng = self.eng
        n_lang = len(eng._lang_ids) if eng.tokenizer.spec.multilingual else 1
        wave = torch.zeros((n_wave, n_lang), dtype=torch.float32, device=eng.device)
        if keep:
            wave[torch.as_tensor(keep, device=eng.device)] = lang_probs.float()[: len(keep)]
        dist.all_reduce(wave, group=self.shardings.data_group)
        return self._fetch(wave)

    def _insert_local(self, windows, prompts, sot_idx, lang_known, slot_ids, temps, ts_en, rep,
                      max_new, last_ts, has_prefix, pfx_last_ts, pfx_penult_ts, enc_ctx,
                      length_penalty) -> torch.Tensor:
        """Seat a wave in this rank's slots (local indices); -> the language
        probabilities of the padded wave on the device."""
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
        t = self._stage
        with eng._lock:
            return cstate.insert(
                eng, self.state, self.gstep, self.cross_ctx, t(audio), t(parr), t(plen),
                t(pad(sot_idx), np.int32), t(pad(lang_known), bool), t(pad(slot_ids), np.int64),
                {name: t(pad(list(v))) for name, v in rows.items()},
                draft=self.draft, lanes=self.beam_width,
            )

    def step(self) -> np.ndarray:
        """Run one chunk of decode steps (verify rounds in a speculative
        pool); returns the packed per-row status and tokens [n_rows,
        status_width] (continuous_state.pack_status), the chunk's one
        device-to-host copy. Slot s's status is at row s * beam_width; its
        winning lane's tokens at row s * beam_width + status column 5."""
        eng = self.eng
        flags = dict(sampling=bool((self._row_temp > 0).any()),
                     penalty=bool((self._row_rep != 1.0).any()), generator=self._gen)
        with eng._lock:
            replayed = False
            if self.spec_k:
                spec_chunk(eng, self.draft, self.state, self.gstep, self.steps_per_chunk,
                           self.ring, self.prompt_pad, self.spec_k, self.suppress_mask, **flags)
            elif self.graphable(flags["sampling"], flags["penalty"]):
                replayed = self._graph_chunk()
            else:
                step_chunk(eng, self.state, self.gstep, self.steps_per_chunk, self.ring,
                           self.prompt_pad, self.suppress_mask, lanes=self.beam_width, **flags)
            self.last_graph = replayed
            self.graph_stats["graph_steps" if replayed else "eager_steps"] += (
                self.steps_per_chunk)
            self.gstep += self.gstep_per_chunk
            return self._fetch(cstate.pack_status(self.state, self.beam_width), rows=True)

    def graphable(self, sampling: bool, penalty: bool) -> bool:
        """Whether a chunk is the one fixed program a CUDA graph replays: on
        the card, one lane a slot, no draft, no tensor parallelism (its
        all-reduces), and no row sampling at T > 0 or with a repetition
        penalty (the host knows both for each chunk)."""
        return (self.eng.device.type == "cuda" and self.eng.cfg.tp == 1
                and self.beam_width == 1 and not self.spec_k and not sampling and not penalty)

    def _graph_key(self) -> tuple:
        """The device addresses a captured step reads and writes: the
        state's tensors, the suppress mask and the parameters."""
        leaves = []
        for x in self.state.values():
            leaves.extend(x.values() if isinstance(x, dict) else (x,))
        return (id(self.eng.params), self.suppress_mask.data_ptr(),
                *(x.data_ptr() for x in leaves if x is not None))

    def _graph_chunk(self) -> bool:
        """One chunk of the greedy step from its CUDA graph; True if it was
        replayed. Without a graph over the current state (the first such
        chunk, or a state allocated anew), the chunk runs eagerly on a side
        stream with the global step on the device (the capture's warm-up),
        and then one step is captured there, which runs nothing."""
        eng, st = self.eng, self.state
        args = (self.ring, self.prompt_pad, self.suppress_mask, False, False, self._gen)
        key = self._graph_key()
        if self._graph is not None and self._graph[3] == key:
            graph, g_dev, per_step, _ = self._graph
            g_dev.fill_(self.gstep)
            for _ in range(self.steps_per_chunk):
                graph.replay()
            _kernels.add_launches(per_step, self.steps_per_chunk)
            return True
        self._graph = None
        g_dev = torch.full((1,), self.gstep, dtype=torch.int64, device=eng.device)
        side = torch.cuda.Stream(eng.device)
        side.wait_stream(torch.cuda.current_stream(eng.device))
        with torch.cuda.stream(side):
            step_chunk(eng, st, g_dev, self.steps_per_chunk, *args)
        torch.cuda.current_stream(eng.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _kernels.capturing() as per_step, torch.cuda.graph(
                graph, stream=side, capture_error_mode="thread_local"):
            step_chunk(eng, st, g_dev, 1, *args)
        self._graph = (graph, g_dev, per_step, key)
        self.graph_stats["graph_captures"] += 1
        return False

    def release(self, slot_ids: list[int]) -> None:
        mask = np.zeros((self.n_slots,), bool)
        mask[list(slot_ids)] = True
        local = mask[self.slot_base : self.slot_base + self.local_slots]
        with self.eng._lock:  # all lanes of each slot
            cstate.release(self.state, self._stage(np.repeat(local, self.beam_width)))
        self._row_temp[mask] = 0.0
        self._row_rep[mask] = 1.0

    def harvest_all(self) -> np.ndarray:
        """The whole sampled ring in one copy: [B, ring] int32."""
        return self._fetch(self.state["sampled"], rows=True)

    unroll = staticmethod(cstate.unroll)
    unroll_masked = staticmethod(cstate.unroll_masked)

    def unroll_row(self, status_row: np.ndarray, join_step: int, gen_len: int) -> np.ndarray:
        """One slot's hypothesis from its packed status row (the plain
        contiguous ring, or a speculative pool's masked ring)."""
        toks = status_row[6 : 6 + self.ring].astype(np.int32)
        if self.spec_k:
            valid = status_row[6 + self.ring:] > 0.5
            return cstate.unroll_masked(toks, valid, join_step, self.ring)
        return cstate.unroll(toks, join_step, gen_len, self.ring)

    def harvest(self, slot: int, join_step: int, gen_len: int, lane: int = 0) -> np.ndarray:
        """One finished slot's sampled tokens, ring-unrolled; `lane` selects
        a beam pool's winner (status column 5)."""
        r = slot * self.beam_width + lane
        row = self._fetch(self.state["sampled"], rows=True)[r]
        if self.spec_k:
            valid = self._fetch(self.state["tok_valid"], rows=True)[r]
            return cstate.unroll_masked(row, valid, join_step, self.ring)
        return cstate.unroll(row, join_step, gen_len, self.ring)

    def align_fetch(self, slot: int, tokens_arr: np.ndarray, cross_len: int, seq_len: int,
                    num_frames: int) -> tuple[np.ndarray, np.ndarray]:
        """The alignment pass (WhisperEngine.align_maps) against this slot's
        resident, content-capped cross-KV (its lanes share one), copied to
        the host: (logits [1, seq_len, V], maps [L, 1, H, seq_len,
        frames]). In a dp-sharded pool the replica owning the slot runs
        the pass and broadcasts it over the data group."""
        eng = self.eng
        out = None
        if self._mine(slot):
            local = (slot - self.slot_base) * self.beam_width
            sub_cross = eng.gather_cross(self.state["cross_kv"], [local])
            out = eng.align_maps(sub_cross, tokens_arr, cross_len, seq_len, num_frames)
        if not self.dp_sharded:
            return out
        cfg = eng.cfg
        shapes = ((1, seq_len, cfg.n_vocab),
                  (cfg.n_text_layer, 1, cfg.n_text_head, seq_len, max(num_frames // 2, 1)))
        src = self.shardings.data_rank(self.owner(slot))
        sent = []
        for i, shape in enumerate(shapes):
            x = (torch.from_numpy(out[i]).to(eng.device) if out is not None
                 else torch.empty(shape, dtype=torch.float32, device=eng.device))
            dist.broadcast(x, src=src, group=self.shardings.data_group)
            sent.append(x.cpu().numpy())
        return sent[0], sent[1]


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
        cb: Optional[ContinuousEngine] = None,
        pool_factory=None,
    ):
        """cb: a slot pool built by the caller; the pool arguments are then
        unused. pool_factory: the pool's class, or a callable with its
        signature, built from the pool arguments (multi-process serving
        passes MultihostContinuousEngine bound to its op log)."""
        self.engine = engine
        self.cb = cb if cb is not None else (pool_factory or ContinuousEngine)(
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
        # word-timestamp assembly (the host DTW) runs here, off the decode
        # loop; created in start() so a stop()/start() cycle gets a fresh one
        self._assemble_pool: Optional[ThreadPoolExecutor] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.max_batch_size = self.cb.n_slots
        # host time of each worker-loop phase (insert: its dispatch, not its
        # device time, which a traced run reads; step chunk including its
        # status copy; harvest), summed over ticks
        self.tick_stats = {
            "ticks": 0, "insert_s": 0.0, "step_s": 0.0, "harvest_s": 0.0,
            "insert_calls": 0, "insert_windows": 0,
            # roofline inputs (utils/roofline.py continuous_step_cost), summed
            # over ticks at dispatch: occupied lane rows (free slots' rows K5
            # skips) and the cross positions K5 reads for them
            "step_rows": 0, "step_cross_pos": 0,
            # the pool's decode steps replayed from its CUDA graph and run
            # eagerly, and its captures (ContinuousEngine.graph_stats, warm-up
            # included)
            **self.cb.graph_stats,
        }
        # speculative pools: every harvested window's committed tokens and
        # verify rounds (a round commits 1 + accepted, so accepted =
        # committed - rounds of rounds * spec_k proposals), and the recent
        # acceptance as an EMA over windows, which the backend's hysteresis
        # reads (a cumulative rate cannot recover from a bad first minute)
        self.spec_stats = {"windows": 0, "rounds": 0, "committed": 0}
        self.acceptance_ema = 0.0
        self._acc_ema_n = 0

    def acceptance_rate(self) -> float:
        """Cumulative draft acceptance of a speculative pool (0.0 for a plain
        pool or before the first harvest)."""
        rounds = self.spec_stats["rounds"]
        if not self.cb.spec_k or rounds == 0:
            return 0.0
        accepted = self.spec_stats["committed"] - rounds
        return max(0.0, min(1.0, accepted / (rounds * self.cb.spec_k)))

    def _count_acceptance(self, status_row: np.ndarray, join_step: int) -> None:
        """A finished speculative window's rounds and committed tokens: each
        round writes a k+2-column block from the join base, so the oldest
        committed column's age names the last round."""
        ring, kp2 = self.cb.ring, self.cb.spec_k + 2
        valid = status_row[6 + ring:] > 0.5
        ages = (np.nonzero(valid)[0] - join_step) % ring
        if not ages.size:
            return
        rounds = int(ages.max()) // kp2 + 1
        committed = int(valid.sum())
        self.spec_stats["windows"] += 1
        self.spec_stats["rounds"] += rounds
        self.spec_stats["committed"] += committed
        win_acc = max(0.0, (committed - rounds) / (rounds * self.cb.spec_k))
        # seed the EMA with the first window, then track at 0.1
        self._acc_ema_n += 1
        if self._acc_ema_n == 1:
            self.acceptance_ema = win_acc
        else:
            self.acceptance_ema += 0.1 * (win_acc - self.acceptance_ema)
        wl_metrics.track_speculative_window(self.acceptance_rate())

    # ------------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        if self._assemble_pool is None:
            self._assemble_pool = ThreadPoolExecutor(max_workers=1,
                                                     thread_name_prefix="wl-assemble")
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
        if self._assemble_pool is not None:
            self._assemble_pool.shutdown(wait=True)
            self._assemble_pool = None

    def submit(self, request: BatchRequest):
        request.queued_ns = time.monotonic_ns()
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
        """Run every insert bucket at every encoder bucket, a step chunk, a
        release and the slot-resident alignment pass once (on the card this
        also builds the kernels), then start from a fresh state."""
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
        if self.cb.dp_sharded:
            # spread a wave over the data replicas: the slots in order of
            # their index within a replica, then of the replica
            free.sort(key=lambda b: (b % self.cb.local_slots, b // self.cb.local_slots))
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
        granted = time.monotonic_ns()
        self._rebind_audio(take, granted)
        for req, _ in take:
            profiling.record_span("request.queued", req.queued_ns, granted, rid=req.rid)
            req.granted_ns = granted
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

    def _rebind_audio(self, take, granted_ns: int) -> None:
        """Late-bind first attempts to their stream's current tail at slot
        grant (at granted_ns, time.monotonic_ns(); same anchor, more audio),
        clamped to the content cap. Retries keep the audio their earlier
        attempts decoded."""
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
            req.audio_bound_at = granted_ns / 1e9

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
                cross_len=min(enc_ctx, self.cb.cross_ctx),
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
        """Resolve the finished slots from the chunk's status copy (slot b's
        status at row b * K, its winning lane's tokens at row b * K +
        column 5), queue gate failures for another insert, run the
        alignment pass of word-timestamp requests against the slot's cross-KV
        (the DTW then runs on the assemble thread), and release the finished
        slots."""
        eng = self.engine
        k = self.cb.beam_width
        done_slots = [
            b for b in list(self._slots)
            if status[b * k, 0] > 0.5 and status[b * k, 1] > 0.5
        ]
        if not done_slots:
            return
        harvested = time.monotonic_ns()
        for b in done_slots:
            info = self._slots.pop(b)
            info.harvested_ns = harvested
            profiling.record_span("request.resident", info.req.granted_ns, harvested,
                                  rid=info.req.rid)
            gen_len = int(status[b * k, 2])
            sum_lp = float(status[b * k, 3])
            ns_prob = float(status[b * k, 4])
            row = b * k + int(status[b * k, 5])
            if self.cb.spec_k:
                self._count_acceptance(status[row], info.join_step)
            toks = self.cb.unroll_row(status[row], info.join_step, gen_len)
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
                    info.req.queued_ns = harvested
                    self._pending.append((info.req, info.temp_index))
                    continue
                if info.temp_index + 1 < len(opt.temperatures):
                    info.req.queued_ns = harvested
                    self._pending.append((info.req, info.temp_index + 1))
                    continue
            if opt.word_timestamps:
                fetched = None
                try:
                    fetched = self._align_fetch(b, info, res)
                except Exception:
                    logger.exception("word alignment pass failed")
                self._assemble_pool.submit(self._resolve, info, res, final_failed, fetched)
                continue
            self._resolve(info, res, final_failed)
        self.cb.release(done_slots)

    def _align_fetch(self, slot: int, info: _SlotInfo, res: DecodeResult):
        """The alignment pass of a finished word-timestamp slot against its
        resident cross-KV, before the slot is released: (logits, maps,
        text tokens, sot_len), or None for a hypothesis without text."""
        prep = self.engine.align_prepare(res.tokens, language=info.language,
                                         task=info.options.task)
        if prep is None:
            return None
        arr, sot_len, text = prep
        logits, maps = self.cb.align_fetch(
            slot, arr, info.cross_len or self.cb.cross_ctx, sot_len + len(text) + 1,
            int(info.duration * 100),
        )
        return logits, maps, text, sot_len

    def _resolve(self, info: _SlotInfo, res: DecodeResult, final_failed: bool,
                 fetched=None) -> None:
        """Assemble the result and resolve the future; for a word-timestamp
        request (on the assemble thread) after the DTW of the fetched
        alignment maps."""
        timings = None
        if fetched is not None:
            logits, maps, text, sot_len = fetched
            try:
                timings = self.engine.align_finish(logits, maps, text, sot_len,
                                                   num_frames=int(info.duration * 100))
            except Exception:
                logger.exception("word alignment DTW failed")
        try:
            result = assemble_result(
                self.engine, info.req, res, info.duration,
                language=info.language or "en", language_prob=info.language_prob,
                prefix_ok=not final_failed, timings=timings,
            )
            result.resolved_ns = time.monotonic_ns()
            profiling.record_span("request.resolve", info.harvested_ns, result.resolved_ns,
                                  rid=info.req.rid)
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
                with profiling.span("continuous.drain"):
                    self._drain_queue(block=idle)
                if self._stop.is_set():
                    break
                load = (len(self._slots) + len(self._pending)) / max(self.cb.n_slots, 1)
                self._load_ema += 0.05 * (load - self._load_ema)
                t0 = time.monotonic()
                with profiling.span("continuous.insert"):
                    self._do_inserts()
                t1 = time.monotonic()
                if not self._slots:
                    continue
                lanes = self.cb.beam_width
                occupied = len(self._slots) * lanes
                # K5 reads min(len, T) positions of an active row, exactly:
                # not the JAX count, which charges the whole slab (or whole
                # 128-position blocks under its WL_BLOCK_DMA kernel)
                ctx = self.cb.cross_ctx
                cross_pos = lanes * sum(min(info.cross_len or ctx, ctx)
                                        for info in self._slots.values())
                with profiling.span("continuous.step") as sp:
                    status = self.cb.step()
                    sp.attrs["graph"] = int(self.cb.last_graph)
                t2 = time.monotonic()
                with profiling.span("continuous.harvest"):
                    self._harvest(status)
                t3 = time.monotonic()
                ts = self.tick_stats
                ts["ticks"] += 1
                ts["insert_s"] += t1 - t0
                ts["step_s"] += t2 - t1
                ts["harvest_s"] += t3 - t2
                ts["step_rows"] += occupied
                ts["step_cross_pos"] += cross_pos
                ts.update(self.cb.graph_stats)
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
