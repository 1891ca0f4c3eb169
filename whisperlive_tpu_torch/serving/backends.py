"""TorchBackend: the serving layer's backend on the port.

Port of whisperlive_tpu/serving/backends.py TpuBackend for the continuous
and the window paths: the host-side VAD gate, then one BatchRequest into
the continuous slot scheduler (engine/continuous.py), or into the window
BatchScheduler for what the continuous step cannot honour (another
suppress set, no_repeat_ngram, another max_initial_timestamp, beam search,
windows longer than its content cap). On the continuous path it keeps the
incremental prefix cache (the previous window's hypothesis forced as a
decode prefix while the stream's tail anchor stays put), late-bound audio
and the adaptive submission cadence. Speculative and hybrid-beam routing
are not ported yet (ROADMAP.md open items 10 and 6a). The backend
interface TranscriptionServer expects:

    async def transcribe(chunk, options, *, language, previous_tokens, uid, ...)
        -> BatchResult | None
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Optional, Sequence

import numpy as np

from whisperlive_tpu_torch.engine.engine import TranscribeOptions
from whisperlive_tpu_torch.engine.scheduler import BatchRequest, BatchResult, BatchScheduler
from whisperlive_tpu_torch.serving.session import SessionOptions

logger = logging.getLogger(__name__)

# Generation budget per 30 s window (<= 224 keeps the decode on the
# 256-slot KV-cache bucket). Overridable for load tests with random
# weights, where decoding never hits EOT early.
STREAMING_MAX_NEW_TOKENS = int(os.environ.get("WL_STREAM_MAX_TOKENS", "224"))

# Load tests with random weights: the quality gates always fail and every
# window would cascade through all fallback temperatures. This switch
# emulates trained weights (the first attempt passes).
_DISABLE_GATES = os.environ.get("WL_DISABLE_FALLBACK_GATES") == "1"


def transcribe_options_from_session(
    options: SessionOptions, language: Optional[str] = None, beam_size: int = 1,
) -> TranscribeOptions:
    """Map per-connection handshake options onto engine decode options."""
    kw = {}
    if _DISABLE_GATES:
        kw = dict(
            temperatures=(0.0,),
            log_prob_threshold=None,
            compression_ratio_threshold=None,
            no_speech_threshold=None,
        )
    return TranscribeOptions(
        language=language or options.language,
        task=options.task,
        initial_prompt=options.initial_prompt,
        hotwords=options.hotwords,
        word_timestamps=options.word_timestamps,
        max_new_tokens=STREAMING_MAX_NEW_TOKENS,
        beam_size=beam_size,
        **kw,
    )


class TorchBackend:
    """Routes chunks through the shared schedulers, behind a host-side VAD
    gate."""

    VAD_THRESHOLD = 0.5  # a session's vad_parameters may override it

    def __init__(
        self,
        scheduler: BatchScheduler,
        model_name: str | None = None,
        continuous_scheduler=None,
    ):
        self.scheduler = scheduler
        self.continuous_scheduler = continuous_scheduler
        self.model_name = model_name
        self._vads: dict[str, object] = {}
        # per-request engine deadline
        self.request_timeout_s = 60.0
        # Incremental partial decoding (continuous path): per-stream cache
        # of the last window's tokens, keyed by the tail anchor. While the
        # anchor is unchanged the next window re-transcribes the same audio
        # plus a little more, so the previous hypothesis is forced as a
        # decode prefix and only the new tail is sampled; a commit moves
        # the anchor and evicts the entry. Every WL_PREFIX_REFRESH-th
        # consecutive prefix window decodes from scratch (0: never), which
        # bounds how long a wrong carried hypothesis can survive.
        self.incremental = os.environ.get("WL_INCREMENTAL", "1") != "0"
        self.prefix_refresh = int(os.environ.get("WL_PREFIX_REFRESH", "16"))
        self._prefix_cache: dict[str, tuple[float, tuple[int, ...]]] = {}
        self._prefix_streak: dict[str, int] = {}
        # Adaptive cadence: while the continuous pool stays oversubscribed,
        # each stream spaces its submissions by alpha x its own round-trip
        # EMA, so the wait is spent buffering audio in the session instead
        # of queueing in the scheduler.
        self.adaptive_cadence = os.environ.get("WL_ADAPTIVE_CADENCE", "1") != "0"
        self.cadence_alpha = float(os.environ.get("WL_CADENCE_ALPHA", "0.7"))
        self._rt_ema: dict[str, float] = {}

    def cadence_spacing_s(self, uid: str) -> float:
        """Seconds the session waits between submissions for `uid`: 0 unless
        adaptive cadence is on and the continuous pool's load EMA is > 1.2."""
        if not self.adaptive_cadence or self.continuous_scheduler is None:
            return 0.0
        if self.continuous_scheduler.load_factor() <= 1.2:
            return 0.0
        return self.cadence_alpha * self._rt_ema.get(uid, 0.0)

    def _pick_scheduler(self, options: TranscribeOptions, duration_s: float | None = None):
        """The continuous scheduler unless its step cannot honour the
        options; then the window scheduler."""
        continuous = self.continuous_scheduler
        if continuous is None:
            return self.scheduler
        if options.no_repeat_ngram_size > 0:
            return self.scheduler
        # the continuous step applies one suppress mask
        if continuous.suppress_key != (options.suppress_tokens, options.suppress_blank):
            return self.scheduler
        # and the 1.0 s max_initial_timestamp default
        if (
            options.max_initial_timestamp is not None
            and float(options.max_initial_timestamp) != 1.0
        ):
            return self.scheduler
        if max(options.beam_size, 1) != continuous.beam_width:
            return self.scheduler
        # windows longer than the content cap keep the full encoder context
        if duration_s is not None and duration_s > continuous.max_window_s:
            return self.scheduler
        return continuous

    def _vad_for(self, uid: str, options: SessionOptions):
        from whisperlive_tpu_torch.audio.vad import VoiceActivityDetector

        if uid not in self._vads:
            params = options.vad_parameters or {}
            self._vads[uid] = VoiceActivityDetector(
                threshold=params.get("threshold", self.VAD_THRESHOLD)
            )
        return self._vads[uid]

    def release(self, uid: str) -> None:
        self._vads.pop(uid, None)
        self._prefix_cache.pop(uid, None)
        self._prefix_streak.pop(uid, None)
        self._rt_ema.pop(uid, None)

    def _trim_prefix(self, tokens: Sequence[int]) -> tuple[int, ...]:
        """Stable part of a previous hypothesis: drop trailing specials and
        timestamps, then the last four text tokens (the unstable zone next
        to the new audio); shorter than 8 tokens is no prefix."""
        eot = self.scheduler.engine.spec.eot
        toks = [int(t) for t in tokens]
        while toks and toks[-1] >= eot:
            toks.pop()
        toks = toks[:-4]
        return tuple(toks) if len(toks) >= 8 else ()

    async def transcribe(
        self,
        chunk: np.ndarray,
        options: SessionOptions,
        *,
        language: Optional[str] = None,
        previous_tokens: Sequence[int] = (),
        uid: str = "",
        include_unfinished: bool = True,
        window_anchor_s: Optional[float] = None,
        refresh_audio=None,
    ) -> Optional[BatchResult]:
        """window_anchor_s (the stream's tail anchor) keys the incremental
        prefix; refresh_audio late-binds the window at slot grant. Both
        apply to the continuous path only."""
        if options.use_vad:
            vad = self._vad_for(uid, options)
            # the gate re-scores the whole un-committed tail every call, so
            # the stateful model starts fresh each time
            vad.reset()
            if not vad(chunk):
                return None  # silence: nothing decoded, cursor stays

        topts = transcribe_options_from_session(options, language)
        prefix_eligible = (
            self.incremental
            and window_anchor_s is not None
            # a non-default penalty would diverge from the from-scratch
            # decode the prefix continuation must reproduce
            and topts.repetition_penalty == 1.0
        )
        prefix_plan: tuple | None = None  # ("use", toks) | ("refresh",) | ("evict",)
        if prefix_eligible and uid in self._prefix_cache:
            anchor, toks = self._prefix_cache[uid]
            if abs(anchor - window_anchor_s) < 1e-6:
                streak = self._prefix_streak.get(uid, 0)
                if self.prefix_refresh and streak >= self.prefix_refresh:
                    prefix_plan = ("refresh",)
                else:
                    prefix_plan = ("use", self._trim_prefix(toks))
            else:
                prefix_plan = ("evict",)  # a commit moved the tail start
        req = BatchRequest(
            audio=chunk,
            options=topts,
            previous_tokens=tuple(previous_tokens),
            language=language,
            uid=uid,
            include_unfinished=include_unfinished,
        )
        scheduler = self._pick_scheduler(topts, len(chunk) / 16000.0)
        on_continuous = scheduler is self.continuous_scheduler
        if on_continuous:
            req.refresh_audio = refresh_audio
        use_prefix = prefix_eligible and on_continuous
        if use_prefix and prefix_plan is not None:
            kind = prefix_plan[0]
            if kind == "refresh":
                self._prefix_streak[uid] = 0
            elif kind == "use":
                req.prefix_tokens = prefix_plan[1]
                self._prefix_streak[uid] = (
                    self._prefix_streak.get(uid, 0) + 1 if req.prefix_tokens else 0
                )
            else:
                self._prefix_cache.pop(uid, None)
                self._prefix_streak.pop(uid, None)
        t_submit = time.monotonic()
        scheduler.submit(req)
        result = await asyncio.wait_for(
            asyncio.wrap_future(req.future), timeout=self.request_timeout_s
        )
        if on_continuous:
            rt = time.monotonic() - t_submit
            prev = self._rt_ema.get(uid, rt)
            self._rt_ema[uid] = prev + 0.3 * (rt - prev)
        if use_prefix and result is not None:
            if result.raw_tokens:
                self._prefix_cache[uid] = (window_anchor_s, result.raw_tokens)
            else:
                # a no-speech skip or a final gate failure: do not force the
                # implicated hypothesis again
                self._prefix_cache.pop(uid, None)
                self._prefix_streak.pop(uid, None)
        return result
