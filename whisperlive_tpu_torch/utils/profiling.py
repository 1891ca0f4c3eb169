"""torch.profiler integration: traces of the host and the card.

Pass --profile_dir to the server or set WL_PROFILE_DIR to trace the whole
serving session; the trace is written when the server shuts down (or at
process exit) as a Chrome trace JSON, viewable in Perfetto or
chrome://tracing. `trace_scope` captures a scoped trace, and `annotate`
names a region of the timeline.

The port's counterpart of whisperlive_tpu/utils/profiling.py (JAX's xprof
traces there). Activities: the CPU, and CUDA when the device traced is a
card.
"""

from __future__ import annotations

import atexit
import contextlib
import logging
import os
import time
from typing import Iterator, Optional

import torch

logger = logging.getLogger(__name__)

# (profiler, directory) of the running long trace, or None
_active: Optional[tuple] = None


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


def annotate(name: str):
    """Named region visible in the trace timeline (a record_function span;
    its CUDA kernels nest under it)."""
    return torch.profiler.record_function(name)


def maybe_start_from_env(device: str | torch.device | None = None) -> None:
    log_dir = os.environ.get("WL_PROFILE_DIR")
    if log_dir:
        start_profiler(log_dir, device)
