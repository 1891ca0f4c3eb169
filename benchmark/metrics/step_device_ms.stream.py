"""Device time of one continuous decode step: the seconds of the kernels
and copies launched in the pool's step chunks wholly inside the traced
stretch (the harness's step spans), over the decode steps of those chunks.
step_ms.stream over it is the step's host overhead factor. The pool's
steps are host-bound, so no event pair in the program times them (an
event pair around a step times its dispatch); None without a traced
stretch."""

from benchmark.trace import kernel_seconds

LAYER = "model step"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "updates_per_s"


def read(run):
    if run.kind != "stream" or not run.trace:
        return None
    secs, ids = kernel_seconds(run.trace["spans"], "step", "")
    if not ids or secs <= 0:
        return None
    return 1e3 * secs / (len(ids) * run.data["steps_per_chunk"])
