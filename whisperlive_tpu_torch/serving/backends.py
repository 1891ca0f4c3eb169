"""TorchBackend: the serving layer's backend on the port.

Port of whisperlive_tpu/serving/backends.py TpuBackend for the continuous
and the window paths: the host-side VAD gate, then one BatchRequest into
the continuous slot scheduler (engine/continuous.py), or into the window
BatchScheduler for what the continuous step cannot honour (another
suppress set, no_repeat_ngram, another max_initial_timestamp, beam search,
windows longer than its content cap). On the continuous path it keeps the
incremental prefix cache (the previous window's hypothesis forced as a
decode prefix while the stream's tail anchor stays put), late-bound audio,
the adaptive submission cadence, mixed speculative routing (full
re-decodes to a second, speculative continuous pool, with hysteresis on its
acceptance) and hybrid beam serving (beam_mode="refresh": greedy
incremental partials on the continuous pool, beamed full re-decodes on the
window scheduler in preemptible segments). FakeBackend, one word a second
of audio, serves the protocol tests and --fake_transcriber. The backend
interface TranscriptionServer and the REST endpoint expect:

    async def transcribe(chunk, options, *, language, previous_tokens, uid, ...)
        -> BatchResult | None
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
import time
from types import SimpleNamespace
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
    """Map per-connection handshake options onto engine decode options.
    beam_size is a server-side policy (the handshake has no such field)."""
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
        spec_scheduler=None,
        beam_size: int = 1,
        beam_mode: str = "full",
        continuous_only: bool = False,
    ):
        self.scheduler = scheduler
        self.continuous_scheduler = continuous_scheduler
        # A world across hosts (parallel/serve_multihost.py; the CLI sets
        # this only then, as the reference's multi-host mode): ONLY the
        # continuous pool's ops are replayed on the other hosts' ranks, so
        # every request must ride the continuous path. Options the window
        # scheduler would otherwise absorb are coerced to the continuous
        # step's fixed ones (warned once per uid) and over-cap windows are
        # clamped. On one host the window route rides the op log too and
        # routing is _pick_scheduler's.
        self.continuous_only = continuous_only
        self._coerce_warned: set[str] = set()
        self.model_name = model_name
        # Beamed requests ride the continuous pool when it was built with
        # matching lanes, else the window scheduler. Hybrid beam serving
        # (beam_mode="refresh"): incremental partials decode greedy on a
        # greedy continuous pool, while the full re-decodes (the periodic
        # refresh windows and the post-commit windows) keep the beam and
        # go to the window scheduler; the beamed hypothesis re-seeds the
        # prefix cache the greedy partials extend.
        self.beam_size = beam_size
        self.hybrid_beam = (
            beam_mode == "refresh"
            and beam_size > 1
            and continuous_scheduler is not None
            and continuous_scheduler.beam_width == 1
        )
        self.hybrid_stats = {"greedy_partials": 0, "beamed_fulls": 0}
        if self.hybrid_beam:
            # the beamed decodes share the card with the continuous chunks:
            # run them in preemptible segments
            scheduler.engine.enable_beam_chunk()
        # Mixed speculative routing: a second continuous pool with a draft
        # serves the full re-decodes (the periodic refresh windows and the
        # post-commit from-scratch windows, ~100 steps each), where a verify
        # round pays for itself, while short incremental tails stay on the
        # plain pool. Greedy output is token-exact on either pool, so the
        # routing changes latency only. Hybrid beam re-routes the same full
        # re-decodes, so the two exclude each other.
        self.spec_scheduler = spec_scheduler
        if spec_scheduler is not None and self.hybrid_beam:
            raise ValueError("mixed speculative routing and hybrid beam both re-route full "
                             "re-decodes; use one or the other")
        # Acceptance hysteresis: below the breakeven a verify round costs
        # more than the plain steps it replaces, so the route turns off,
        # probes one window every probe interval, and turns on again above
        # the upper band. The EMA must have seen spec_warm_windows windows
        # before the breaker acts (cold-start windows accept less).
        self.spec_breakeven = float(os.environ.get("WL_SPEC_BREAKEVEN", "0.25"))
        self.spec_reenable = float(os.environ.get("WL_SPEC_REENABLE", "0.35"))
        self.spec_probe_s = float(os.environ.get("WL_SPEC_PROBE_S", "30"))
        self.spec_warm_windows = int(os.environ.get("WL_SPEC_WARM_WINDOWS", "16"))
        self._spec_enabled = True
        self._spec_last_probe = 0.0
        self.spec_route_stats = {
            "spec_fulls": 0, "plain_fulls": 0, "probes": 0, "disables": 0, "reenables": 0,
        }
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

    def _pick_scheduler(self, options: TranscribeOptions, duration_s: float | None = None,
                        continuous=None):
        """`continuous` (by default the main continuous pool; mixed routing
        passes the speculative pool) unless its step cannot honour the
        options; then the window scheduler."""
        if continuous is None:
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

    def _spec_route(self) -> bool:
        """Hysteresis decision for routing a full re-decode to the
        speculative pool. While the route is off, one probe window every
        spec_probe_s keeps the acceptance EMA live, so a recovery can turn
        it on again."""
        sched = self.spec_scheduler
        if sched is None:
            return False
        acc = sched.acceptance_ema
        warm = sched._acc_ema_n >= self.spec_warm_windows
        if self._spec_enabled:
            if warm and acc < self.spec_breakeven:
                self._spec_enabled = False
                self._spec_last_probe = time.monotonic()
                self.spec_route_stats["disables"] += 1
                logger.warning(
                    "speculative routing disabled: acceptance EMA %.2f < breakeven %.2f "
                    "(full re-decodes go to the plain pool; probing every %.0f s)",
                    acc, self.spec_breakeven, self.spec_probe_s,
                )
                return False
            return True
        if warm and acc > self.spec_reenable:
            self._spec_enabled = True
            self.spec_route_stats["reenables"] += 1
            logger.info("speculative routing re-enabled: acceptance EMA %.2f > %.2f",
                        acc, self.spec_reenable)
            return True
        now = time.monotonic()
        if now - self._spec_last_probe >= self.spec_probe_s:
            self._spec_last_probe = now
            self.spec_route_stats["probes"] += 1
            return True
        return False

    def _coerce_to_continuous(self, topts: TranscribeOptions, chunk: np.ndarray,
                              uid: str) -> tuple[TranscribeOptions, np.ndarray]:
        """Force a request onto the continuous path (continuous_only
        serving: a world across hosts replays no window scheduler). Options
        the continuous step cannot honour are replaced by its fixed values;
        windows over the content cap are clamped."""
        cs = self.continuous_scheduler
        changed = []
        if topts.no_repeat_ngram_size > 0:
            topts = dataclasses.replace(topts, no_repeat_ngram_size=0)
            changed.append("no_repeat_ngram_size")
        key = getattr(cs, "suppress_key", None)
        if key is not None and key != (topts.suppress_tokens, topts.suppress_blank):
            topts = dataclasses.replace(topts, suppress_tokens=key[0], suppress_blank=key[1])
            changed.append("suppress config")
        if (
            topts.max_initial_timestamp is not None
            and float(topts.max_initial_timestamp) != 1.0
        ):
            topts = dataclasses.replace(topts, max_initial_timestamp=1.0)
            changed.append("max_initial_timestamp")
        pool_beam = getattr(cs, "beam_width", 1)
        if max(topts.beam_size, 1) != pool_beam:
            topts = dataclasses.replace(topts, beam_size=pool_beam)
            changed.append("beam_size")
        max_s = getattr(cs, "max_window_s", None)
        if max_s is not None and len(chunk) / 16000.0 > max_s:
            chunk = chunk[: int(max_s * 16000)]
            changed.append("window length (clamped)")
        if changed and uid not in self._coerce_warned:
            self._coerce_warned.add(uid)
            logger.warning(
                "continuous-only serving coerced %s for uid=%s (multi-host "
                "mode serves the continuous path only)",
                ", ".join(changed), uid,
            )
        return topts, chunk

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

    def _adjust_options(self, topts: TranscribeOptions, chunk: np.ndarray) -> TranscribeOptions:
        """Per-request option hook, the identity here (benchmarks override
        it, e.g. to emulate trained weights' decode lengths)."""
        return topts

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

        topts = transcribe_options_from_session(options, language, beam_size=self.beam_size)
        topts = self._adjust_options(topts, chunk)
        # the prefix plan is resolved before routing: hybrid beam splits on
        # it; its mutations apply after routing
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
        is_tail = prefix_plan is not None and prefix_plan[0] == "use" and bool(prefix_plan[1])
        hybrid = self.hybrid_beam and topts.beam_size > 1
        if hybrid and is_tail:  # a greedy incremental partial
            topts = dataclasses.replace(topts, beam_size=1)
        # mixed speculative routing: full re-decodes ride the speculative
        # pool's verify rounds, incremental tails stay plain
        target_continuous = None
        if self.spec_scheduler is not None and not is_tail and topts.beam_size <= 1:
            if self._spec_route():
                target_continuous = self.spec_scheduler
                self.spec_route_stats["spec_fulls"] += 1
            else:
                self.spec_route_stats["plain_fulls"] += 1
        if self.continuous_only and self.continuous_scheduler is not None:
            topts, chunk = self._coerce_to_continuous(topts, chunk, uid)
        req = BatchRequest(
            audio=chunk,
            options=topts,
            previous_tokens=tuple(previous_tokens),
            language=language,
            uid=uid,
            include_unfinished=include_unfinished,
        )
        scheduler = self._pick_scheduler(topts, len(chunk) / 16000.0,
                                         continuous=target_continuous)
        on_continuous = scheduler is not self.scheduler
        if hybrid:
            self.hybrid_stats["greedy_partials" if topts.beam_size == 1 else "beamed_fulls"] += 1
        if on_continuous:
            req.refresh_audio = refresh_audio
        # a hybrid full re-decode runs on the window scheduler but still
        # seeds the prefix cache: its beamed hypothesis is what the greedy
        # partials extend
        use_prefix = prefix_eligible and (on_continuous or hybrid)
        if use_prefix and prefix_plan is not None:
            kind = prefix_plan[0]
            if kind == "refresh":
                self._prefix_streak[uid] = 0
            elif kind == "use":
                if on_continuous:
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


class FakeBackend:
    """Deterministic streaming transcriber: one word per second of audio.

    Used by the hermetic server/client tests and by `--fake_transcriber`
    (handy for protocol debugging without a model, and the analogue of the
    reference's mocked-transcriber test seam)."""

    def __init__(self, latency_s: float = 0.0):
        self.latency_s = latency_s

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
    ) -> BatchResult:
        if self.latency_s:
            await asyncio.sleep(self.latency_s)
        duration = len(chunk) / 16000.0
        segments = []
        whole = int(duration)
        for i in range(whole):
            segments.append(
                SimpleNamespace(
                    start=float(i),
                    end=float(i + 1),
                    text=f" word{i}",
                    tokens=[],
                    no_speech_prob=0.0,
                    words=None,
                )
            )
        if duration > whole:
            segments.append(
                SimpleNamespace(
                    start=float(whole),
                    end=duration,
                    text=" partial",
                    tokens=[],
                    no_speech_prob=0.0,
                    words=None,
                )
            )
        return BatchResult(
            segments=segments,
            language=language or options.language or "en",
            language_prob=0.99,
            duration=duration,
            advance_s=duration,
        )
