"""The traced stretch of a `--trace 1` run: torch.profiler over a bounded
stretch of the window, every thread recorded, reduced in memory once the
window has closed (nothing is written to disk).

The harness names its own spans around calls into the program
(`bench.<what>#<n>`, see kinds/); the reduction gives:

  busy_s, window_s   the union of the card's kernels and copies inside the
                     stretch, and the stretch's length;
  device_ops         device seconds by kernel name;
  idle_gaps          the longest stretches with nothing on the card, each
                     named by the host span and op running at its middle;
  spans              per harness span wholly inside the stretch, the device
                     seconds by kernel name of the kernels launched in it
                     (a kernel is placed by the host time of the op that
                     launched it, or by its own start where the profiler
                     links none).
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict

import torch


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


class Profile:
    """torch.profiler over every thread, started and stopped by the caller
    (from the main thread: CUPTI registers its callbacks there). result()
    reduces the stretch between the two calls; it takes seconds of host
    time for a few hundred thousand events, so callers ask for it once the
    measured window has closed."""

    def __init__(self, cuda: bool):
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._prof = profile(activities=acts,
                             experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self._prof.start()
        self.t0 = time.time_ns()

    def stop(self) -> None:
        self.t1 = time.time_ns()
        self._prof.stop()

    def result(self) -> dict:
        return reduce(self._prof.profiler.kineto_results.events(), self.t0, self.t1)


def profile_stretch(start: float, length_s: float, cuda: bool) -> Profile:
    """Sleep until `start` (time.monotonic()) and profile `length_s` seconds
    from the profiler's start (which itself takes seconds) while the
    program's threads go on; returns the stopped profile."""
    time.sleep(max(0.0, start - time.monotonic()))
    prof = Profile(cuda)
    time.sleep(length_s)
    prof.stop()
    return prof


_SPAN = re.compile(r"^bench\.(\w+)#(\d+)$")
_ANNOTATIONS = ("bench.", "continuous.", "window.")


def _annotation(e) -> bool:
    """A span the host named (the profiler also draws each on the card's
    timeline, over the kernels it launched): not device work."""
    kind = getattr(e, "activity_type", None)
    if kind is not None and "annotation" in str(kind()):
        return True
    return e.is_user_annotation() or e.name().startswith(_ANNOTATIONS)


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events, t0: int, t1: int) -> dict:
    """Reduce kineto events of the stretch [t0, t1] (epoch ns)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu = [], []
    for e in events:
        if e.device_type() != cuda:
            cpu.append(e)
        elif not _annotation(e):  # the card's kernels, copies and sets
            dev.append(e)
    cpu_start = {}
    ann, ops = [], []
    spans = {}
    for e in cpu:
        s = _ns(e, "start")
        end = s + _ns(e, "duration")
        cpu_start[e.correlation_id()] = s
        name = e.name()
        m = _SPAN.match(name)
        if m:
            spans[name] = (s, end, m.group(1), int(m.group(2)))
        (ann if _annotation(e) else ops).append((s, end, name))

    by_name: dict[str, float] = defaultdict(float)
    intervals = []
    launched = []  # (launch time, duration s, name)
    for e in dev:
        s = _ns(e, "start")
        d = _ns(e, "duration")
        a, b = max(s, t0), min(s + d, t1)
        if b <= a:
            continue
        name = e.name()
        by_name[name] += (b - a) / 1e9
        intervals.append((a, b))
        link = e.linked_correlation_id()
        launched.append((cpu_start.get(link, s) if link else s, d / 1e9, name))

    busy = _union(intervals)
    busy_s = sum(b - a for a, b in busy) / 1e9
    gaps = []
    prev = t0
    for a, b in busy + [(t1, t1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)

    def host_at(t: int) -> str:
        inner_ann = max((x for x in ann if x[0] <= t <= x[1]), key=lambda x: x[0], default=None)
        inner_op = max((x for x in ops if x[0] <= t <= x[1]), key=lambda x: x[0], default=None)
        parts = [x[2] for x in (inner_ann, inner_op) if x is not None]
        return " / ".join(parts) if parts else "host: no op recorded"

    idle = [[host_at((a + b) // 2), (b - a) / 1e9] for a, b in gaps[:10]]

    inside = sorted((s, e, kind, n) for s, e, kind, n in spans.values() if s >= t0 and e <= t1)
    starts = [x[0] for x in inside]
    per_span: dict[tuple[str, int], dict[str, float]] = {}
    for t, d, name in launched:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= inside[i][1]:
            key = (inside[i][2], inside[i][3])
            per_span.setdefault(key, defaultdict(float))[name] += d
    for s, e, kind, n in inside:
        per_span.setdefault((kind, n), defaultdict(float))
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {
        "busy_s": busy_s,
        "window_s": (t1 - t0) / 1e9,
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": idle,
        "spans": {k: dict(v) for k, v in per_span.items()},
        "n_device_events": len(dev),
        "events": {"cpu": len(cpu), "device": len(dev), "device_in_stretch": len(intervals),
                   "first_ms": _edge(cpu + dev, t0, min), "last_ms": _edge(cpu + dev, t1, max)},
    }


def _edge(events, t: int, pick) -> float | None:
    """The earliest (latest) event start relative to t, in ms."""
    if not events:
        return None
    return (pick(_ns(e, "start") for e in events) - t) / 1e6


def kernel_seconds(spans: dict, kind: str, pattern: str) -> tuple[float, list[int]]:
    """Device seconds of the kernels whose name matches `pattern` launched
    in the harness spans of `kind`, and those spans' numbers."""
    rx = re.compile(pattern)
    total, ids = 0.0, []
    for (k, n), kernels in spans.items():
        if k != kind:
            continue
        ids.append(n)
        total += sum(v for name, v in kernels.items() if rx.search(name))
    return total, ids
