"""Cross-stream batch scheduler: the one component that touches the GPU.

Port of whisperlive_tpu/engine/scheduler.py (the window scheduler): N
sessions submit 30 s windows; one worker thread drains the queue, groups
batch-compatible requests into a batch-size bucket and runs the engine's
window path, attempt 1 through WhisperEngine.transcribe_batch and the
temperature-fallback retries of gate failures on a gathered cross-KV
subset. Results resolve concurrent.futures.Futures, which the asyncio
serving layer awaits through asyncio.wrap_future.

Not ported yet: word-timestamp requests (their future fails with
NotImplementedError), beam search and the speculative route (ROADMAP.md
open items 6a and 10).
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np

from whisperlive_tpu_torch.utils import metrics as wl_metrics
from whisperlive_tpu_torch.engine.engine import (
    NOT_PORTED_ALIGN,
    NOT_PORTED_BEAM,
    TranscribeOptions,
    WhisperEngine,
    _bucket,
    fails_quality_gates,
)
from whisperlive_tpu_torch.engine.transcribe import Segment, split_segments_by_timestamps
from whisperlive_tpu_torch.ops import mel as mel_ops

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class BatchRequest:
    """One 30 s-window transcription request."""

    audio: np.ndarray  # float32 mono 16 kHz, <= 30 s (truncated if longer)
    options: TranscribeOptions
    previous_tokens: Sequence[int] = ()
    language: Optional[str] = None  # resolved language (None -> detect)
    uid: str = ""
    # streaming sessions keep the unfinished trailing slice as the rolling
    # partial; offline seek loops drop it
    include_unfinished: bool = True
    # continuous scheduler only: the previous window's hypothesis, forced
    # as a decode prefix so only the new tail is sampled (ignored when
    # options.prefix is set)
    prefix_tokens: Sequence[int] = ()
    # continuous scheduler only: called once at slot grant to swap in the
    # stream's current tail (same anchor); None keeps the snapshot
    refresh_audio: Optional[Callable[[], Optional[np.ndarray]]] = None
    audio_rebound: bool = False  # set by the scheduler after the one refresh
    # when the decoded audio was captured (a refresh updates it)
    audio_bound_at: float = dataclasses.field(default_factory=time.monotonic)
    future: Future = dataclasses.field(default_factory=Future)
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)

    def group_key(self):
        # the scalar decode knobs are batch-global inputs taken from
        # batch[0], so a batch must be homogeneous in them (word-timestamp
        # and beam requests never reach the queue)
        return (
            self.options.suppress_tokens,
            self.options.suppress_blank,
            self.options.repetition_penalty,
            self.options.no_repeat_ngram_size,
            self.options.temperatures,
        )


@dataclasses.dataclass
class BatchResult:
    segments: list[Segment]
    language: str
    language_prob: float
    duration: float  # seconds of audio covered by this result
    advance_s: float = 0.0  # seconds consumed (seek feedback)
    raw_tokens: tuple = ()  # full decoded stream, timestamps included
    audio_bound_at: float = 0.0  # when the decoded audio was captured


def assemble_result(
    eng: WhisperEngine,
    req: BatchRequest,
    res,  # DecodeResult
    duration: float,
    language: str,
    language_prob: float,
    prefix_ok: bool = True,
) -> BatchResult:
    """One decode result -> wire-ready BatchResult (no-speech skip and the
    timestamp split). prefix_ok=False (the final attempt still failed the
    quality gates) keeps the token stream from seeding the next window's
    forced prefix, as a no-speech skip does."""
    segments: list[Segment] = []
    advance_s = duration
    skip = (
        req.options.no_speech_threshold is not None
        and res.no_speech_prob > req.options.no_speech_threshold
        and (
            req.options.log_prob_threshold is None
            or res.avg_logprob < req.options.log_prob_threshold
        )
    )
    if not skip:
        segment_size = int(duration * 100)  # mel frames
        pieces, advance, _ = split_segments_by_timestamps(
            eng.spec, res.tokens, 0.0, duration, segment_size,
            include_unfinished=req.include_unfinished,
        )
        advance_s = min(advance / 100.0, duration)
        for j, (start, end, toks) in enumerate(pieces):
            text = eng.tokenizer.decode(toks)
            if not text.strip():
                continue
            segments.append(
                Segment(
                    id=j,
                    seek=0,
                    start=start,
                    end=end,
                    text=text,
                    tokens=toks,
                    temperature=res.temperature,
                    avg_logprob=res.avg_logprob,
                    compression_ratio=res.compression_ratio,
                    no_speech_prob=res.no_speech_prob,
                )
            )
    return BatchResult(
        segments=segments,
        language=language,
        language_prob=language_prob,
        duration=duration,
        advance_s=advance_s,
        # a no-speech skip is hallucination over silence: no token stream
        raw_tokens=() if (skip or not prefix_ok) else tuple(int(t) for t in res.tokens),
        audio_bound_at=req.audio_bound_at,
    )


class BatchScheduler:
    """Single worker thread owning the engine."""

    def __init__(
        self,
        engine: WhisperEngine,
        max_batch_size: int = 8,
        batch_window_ms: float = 50.0,
    ):
        self.engine = engine
        self.max_batch_size = max_batch_size
        self.batch_window_ms = batch_window_ms
        self._queue: "queue.Queue[Optional[BatchRequest]]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seed = 0

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._worker_loop, name="gpu-batch-scheduler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def submit(self, request: BatchRequest) -> Future:
        if request.options.word_timestamps:
            request.future.set_exception(NotImplementedError(NOT_PORTED_ALIGN))
        elif request.options.beam_size > 1:
            request.future.set_exception(NotImplementedError(NOT_PORTED_BEAM))
        else:
            self._queue.put(request)
        return request.future

    def _collect_batch(self) -> list[BatchRequest]:
        """Block for the first request, then drain compatible requests for
        up to batch_window_ms."""
        first = self._queue.get()
        if first is None or self._stop.is_set():
            return []
        batch = [first]
        deadline = time.monotonic() + self.batch_window_ms / 1000.0
        leftovers: list[BatchRequest] = []
        while len(batch) < self.max_batch_size:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                req = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if req is None:
                break
            if req.group_key() == first.group_key():
                batch.append(req)
            else:
                leftovers.append(req)
        for req in leftovers:
            self._queue.put(req)
        return batch

    def _worker_loop(self) -> None:
        logger.info("batch scheduler started (max_batch=%d window=%.0fms)",
                    self.max_batch_size, self.batch_window_ms)
        while not self._stop.is_set():
            batch = self._collect_batch()
            if not batch:
                continue
            try:
                self._process_batch(batch)
            except Exception as e:  # the worker must survive
                logger.exception("batch processing failed")
                wl_metrics.track_error("batch_processing")
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)
        logger.info("batch scheduler stopped")

    def _process_batch(self, batch: list[BatchRequest]) -> None:
        eng = self.engine
        t0 = time.monotonic()
        n = len(batch)

        durations = []
        audio = np.zeros((n, mel_ops.N_SAMPLES), np.float32)
        for i, req in enumerate(batch):
            a = req.audio[: mel_ops.N_SAMPLES]
            audio[i, : len(a)] = a
            durations.append(len(a) / mel_ops.SAMPLE_RATE)
        bucket = _bucket(n, eng.batch_buckets)
        if bucket > n:
            audio = np.concatenate(
                [audio, np.zeros((bucket - n, mel_ops.N_SAMPLES), np.float32)]
            )

        languages: list[Optional[str]] = [req.language or req.options.language for req in batch]
        lang_known = [lang is not None for lang in languages]
        language_probs = [1.0] * n
        prompts, sot_idx = [], []
        for i, req in enumerate(batch):
            # unknown language: a placeholder token, replaced on the device
            # by the detected one
            p, s = eng.build_prompt(
                req.options, previous_tokens=req.previous_tokens,
                language=languages[i] or "en",
            )
            prompts.append(p)
            sot_idx.append(s)

        self._seed += 1
        options = batch[0].options
        results, detected, cross_kv = eng.transcribe_batch(
            audio, prompts, sot_idx, lang_known, options, seed=self._seed
        )
        for i in range(n):
            if languages[i] is None:
                languages[i], language_probs[i] = detected[i]

        # temperature-fallback retries of gate failures on the gathered
        # cross-KV of the failing items only
        retry_temps = options.temperatures[1:]
        failed = [i for i in range(n) if fails_quality_gates(options, results[i])]
        if failed and retry_temps:
            retry_bucket = _bucket(len(failed), eng.batch_buckets)
            cross_sub = eng.gather_cross(
                cross_kv, (failed + [failed[-1]] * retry_bucket)[:retry_bucket]
            )
            retry_prompts, retry_sots = [], []
            for i in failed:
                p, s = eng.build_prompt(
                    batch[i].options, previous_tokens=batch[i].previous_tokens,
                    language=languages[i],
                )
                retry_prompts.append(p)
                retry_sots.append(s)
            retry_opts = dataclasses.replace(options, temperatures=retry_temps)
            retry_results = eng.decode_with_fallback(
                cross_sub, retry_prompts, retry_sots, retry_opts, seed=self._seed
            )
            for j, i in enumerate(failed):
                results[i] = retry_results[j]

        for i, (req, res) in enumerate(zip(batch, results)):
            try:
                req.future.set_result(
                    assemble_result(
                        eng, req, res, durations[i],
                        language=languages[i] or "en",
                        language_prob=language_probs[i],
                    )
                )
            except Exception as e:
                if not req.future.done():
                    req.future.set_exception(e)

        dt = time.monotonic() - t0
        wl_metrics.track_batch_occupancy(n)
        wl_metrics.track_transcription_latency(dt)
        wl_metrics.track_audio_seconds(sum(durations))
        logger.debug("batch of %d done in %.0f ms", n, dt * 1e3)
