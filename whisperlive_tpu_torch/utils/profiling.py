"""Tracing of the port: the span log, the device timer, and torch.profiler
traces of the host and the card.

**The span log** is always on. `span(name, rid=None, **attrs)` is a context
manager; `record_span(name, start_ns, end_ns, rid=None, **attrs)` records a
span whose ends were taken on different threads. A span records its name,
its start and end on time.monotonic_ns() (the clock of the serving layer's
timestamps, BatchRequest.audio_bound_at among them), its thread, its parent
(the innermost span open on that thread when it opened; 0 for none and for
a recorded span), the request id `rid` that every span of one request
shares (BatchRequest.rid, from new_rid()), and a few numeric attributes.
Spans go into one bounded ring for the process (`LOG`, the last 65,536);
the ring counts what it drops and never writes to disk. `LOG.clock_pair`,
(time.time_ns(), time.monotonic_ns()) taken together when the log was made,
places a span on torch.profiler's timeline, whose events carry epoch
times (`LOG.to_epoch_ns`). While torch.profiler records, and only then, a
span also opens a record_function of its name, so that it stands on the
trace beside the kernels it launched.

**The device timer** (`DeviceTimer`, one an engine) gives a prepare's
encoder and cross-KV, which the card paces, their device seconds by a CUDA
event pair, read after a sync the caller makes anyway.

**Traces**: pass --profile_dir to the server (its default is WL_PROFILE_DIR)
to trace the whole serving session; the trace is written when the server
shuts down (or at process exit) as a Chrome trace JSON, viewable in
Perfetto or chrome://tracing. `trace_scope` captures a scoped trace.

The port's counterpart of whisperlive_tpu/utils/profiling.py (JAX's xprof
traces there). Activities: the CPU, and CUDA when the device traced is a
card.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import itertools
import logging
import os
import threading
import time
from typing import Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger(__name__)

# (profiler, directory) of the running long trace, or None
_active: Optional[tuple] = None

_now = time.monotonic_ns

# process-wide request ids: every span of one request carries its rid
new_rid = itertools.count(1).__next__


class Span:
    """One span of the log; a context manager while it is open. `attrs`
    may be filled in until (and, for device seconds, after) it closes."""

    __slots__ = ("log", "name", "start_ns", "end_ns", "thread", "parent", "rid", "attrs",
                 "sid", "_rf")

    def __init__(self, log, name, rid, attrs, start_ns=0, end_ns=0, parent=0):
        self.log = log
        self.name = name
        self.rid = rid
        self.attrs = attrs
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.parent = parent
        self.thread = threading.get_ident()
        self.sid = next(log._sids)
        self._rf = None

    def __enter__(self) -> "Span":
        stack = self.log._stack()
        self.parent = stack[-1] if stack else 0
        stack.append(self.sid)
        self.start_ns = _now()
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.end_ns = _now()
        stack = self.log._stack()
        if stack and stack[-1] == self.sid:
            stack.pop()
        elif self.sid in stack:  # closed out of order
            stack.remove(self.sid)
        self.log._append(self)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, rid={self.rid}, {self.seconds * 1e3:.3f} ms, "
                f"parent={self.parent}, attrs={self.attrs})")


class SpanLog:
    """A bounded ring of spans (see the module's docstring)."""

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self._ring: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._sids = itertools.count(1)
        self.dropped = 0
        # the latest end of a dropped span: a window that starts after it
        # is whole in the ring
        self.dropped_end_ns = 0
        self.thread_names: dict[int, str] = {}
        self.clock_pair = (time.time_ns(), time.monotonic_ns())

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            self.thread_names[threading.get_ident()] = threading.current_thread().name
        return stack

    def _append(self, s: Span) -> None:
        with self._lock:
            if len(self._ring) >= self.capacity:
                old = self._ring.popleft()
                self.dropped += 1
                self.dropped_end_ns = max(self.dropped_end_ns, old.end_ns)
            self._ring.append(s)

    def span(self, name: str, rid: Optional[int] = None, **attrs) -> Span:
        """with log.span("engine.prepare") as s: ... (s.attrs may be set inside)."""
        return Span(self, name, rid, attrs)

    def record_span(self, name: str, start_ns: int, end_ns: int, rid: Optional[int] = None,
                    **attrs) -> Span:
        """A closed span whose ends were taken elsewhere (on other threads)."""
        s = Span(self, name, rid, attrs, start_ns, end_ns)
        self._stack()  # names this thread
        self._append(s)
        return s

    def spans(self, name: Optional[str] = None) -> list[Span]:
        """The ring's spans in the order they closed (of one name, if given)."""
        with self._lock:
            items = list(self._ring)
        return items if name is None else [s for s in items if s.name == name]

    def whole_since(self, start_ns: int) -> bool:
        """True when no span that ended at or after start_ns was dropped."""
        return self.dropped_end_ns < start_ns

    def to_epoch_ns(self, monotonic_ns: int) -> int:
        """A time of this log's clock on time.time_ns()'s (the profiler's)."""
        wall0, mono0 = self.clock_pair
        return wall0 + (monotonic_ns - mono0)


LOG = SpanLog()
span = LOG.span
record_span = LOG.record_span


# ---------------------------------------------------------------------------
# Device time
# ---------------------------------------------------------------------------


class DeviceTimer:
    """Device seconds of stretches of work that the card paces, one CUDA
    event pair a stretch.

    An event pair times the card from the stretch's first kernel to its
    last, waits for the host between them included: around work that the
    host dispatches slower than the card runs it, it times the host. So a
    pair goes only around a prepare's encoder and cross-KV, which the card
    paces; the device time of host-bound work (a decode step, a pool's
    insert) is read from a traced run's kernels (benchmark/metrics).

    `with timer.time(span):` records the pair; settle() reads the pairs
    whose end has completed into their span's `device_s`, after a sync the
    caller makes anyway (no sync is added). A stretch that raises records
    nothing. On a CPU device nothing is recorded."""

    def __init__(self, device):
        self.enabled = torch.device(device).type == "cuda"
        self._pending: list[tuple] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def time(self, span: Span) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        self.settle()  # bounds the pairs a caller that never syncs leaves
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        with self._lock:
            self._pending.append((start, end, span))

    def settle(self) -> None:
        """Read every pair whose end has completed."""
        if not self._pending:
            return
        with self._lock:
            pending, self._pending = self._pending, []
        keep = []
        for start, end, span in pending:
            if end.query():
                span.attrs["device_s"] = start.elapsed_time(end) / 1e3
            else:
                keep.append((start, end, span))
        if keep:
            with self._lock:
                self._pending[:0] = keep


# ---------------------------------------------------------------------------
# torch.profiler traces
# ---------------------------------------------------------------------------


def start_profiler(log_dir: str, device: str | torch.device | None = None) -> bool:
    """Begin a long-running trace (stopped by stop_profiler, on the
    server's shutdown path, or at process exit). `device`: the device the
    traced work runs on; CUDA activity is recorded when it is a card
    (default: when one is available)."""
    global _active
    if _active is not None:
        logger.warning("profiler already tracing to %s", _active[1])
        return False
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    on_card = (torch.cuda.is_available() if device is None
               else torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    try:
        os.makedirs(log_dir, exist_ok=True)
        # every thread's ops and spans: the schedulers' workers run the
        # device work (by default only the starting thread is recorded)
        prof = profile(activities=activities,
                       experimental_config=_ExperimentalConfig(profile_all_threads=True))
        prof.start()
    except (OSError, RuntimeError):
        logger.exception("failed to start profiler")
        return False
    _active = (prof, log_dir)
    atexit.register(stop_profiler)
    logger.info("torch profiler tracing to %s (%s)", log_dir,
                ", ".join(a.name for a in activities))
    return True


def stop_profiler() -> Optional[str]:
    """End the long trace and write it under its directory as
    trace_<pid>_<time>.json; returns the file's path (None when nothing
    was tracing)."""
    global _active
    if _active is None:
        return None
    prof, log_dir = _active
    _active = None
    atexit.unregister(stop_profiler)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    try:
        prof.stop()
        prof.export_chrome_trace(path)
    except (OSError, RuntimeError):
        logger.exception("failed to stop profiler")
        return None
    logger.info("torch profiler trace written to %s", path)
    return path


@contextlib.contextmanager
def trace_scope(log_dir: str, device: str | torch.device | None = None) -> Iterator[None]:
    """Capture one scoped trace: with trace_scope('/tmp/prof'): ..."""
    start_profiler(log_dir, device)
    try:
        yield
    finally:
        stop_profiler()
