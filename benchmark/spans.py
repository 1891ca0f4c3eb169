"""The program's span log (whisperlive_tpu_torch.utils.profiling) as the
metric readers see it: the spans of one name that ended inside a run's
window (time.monotonic, the log's clock), or that lie between two times.

spans() gives None where there is nothing to read: a program without the
log, a run without a window, or a ring that dropped a span which ended
inside the window. A reader of a program without a span gets no spans of
its name, and reads nothing."""

from __future__ import annotations


def window(run) -> tuple[float, float] | None:
    """The measured window of a run: the stream kind records it, the files
    kind its start."""
    if "window" in run.data:
        return run.data["window"]
    if "t0" in run.data:
        return run.data["t0"], run.data["t0"] + run.seconds
    return None


def spans(run, name: str, between: tuple[float, float] | None = None) -> list | None:
    """The spans named `name` that ended inside the run's window, or that
    lie wholly `between` two times (time.monotonic seconds)."""
    try:
        from whisperlive_tpu_torch.utils import profiling
    except ImportError:
        return None
    log = getattr(profiling, "LOG", None)
    w = between or window(run)
    if log is None or w is None:
        return None
    lo, hi = int(w[0] * 1e9), int(w[1] * 1e9)
    if not log.whole_since(lo):
        return None
    return [s for s in log.spans(name)
            if lo <= s.end_ns < hi and (between is None or s.start_ns >= lo)]
