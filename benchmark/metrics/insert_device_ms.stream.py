"""Device time of one insert (the encoder, cross-KV, language ID, prefill
and slot writes of a wave of windows): the seconds of the kernels and
copies launched in the pool's inserts wholly inside the traced stretch
(the harness's insert spans), over those inserts. An insert is dispatched
slower than the card runs it, so no event pair in the program times it
(tick_stats insert_s holds its dispatch); None without a traced insert."""

from benchmark.trace import kernel_seconds

LAYER = "model step"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "update_p95_s"


def read(run):
    if run.kind != "stream" or not run.trace:
        return None
    secs, ids = kernel_seconds(run.trace["spans"], "insert", "")
    return 1e3 * secs / len(ids) if ids and secs > 0 else None
