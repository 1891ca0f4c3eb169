"""Device time of one step of a window batch's decode: for each batch
wholly inside the traced stretch, the seconds of the kernels and copies
launched in it (the harness's batch span) less its prepare's device
seconds (the program's engine.prepare span, an event pair), over the steps
of its decodes (the program's engine.decode spans); summed over those
batches. The log-mel and language detection, a few ms a batch, fall to the
decode. decode_step_ms.files over it is the decode's host overhead factor.
None without a traced stretch or without the program's spans."""

from benchmark.spans import spans

LAYER = "model step"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "rtfx"


def read(run):
    if run.kind != "files" or not run.trace:
        return None
    batches = {b["n"]: b for b in run.data.get("batches", ()) if "t1" in b}
    secs, steps = 0.0, 0
    for (kind, n), kernels in run.trace["spans"].items():
        b = batches.get(n)
        if kind != "batch" or b is None:
            continue
        prepares = spans(run, "engine.prepare", (b["t0"], b["t1"]))
        decodes = spans(run, "engine.decode", (b["t0"], b["t1"]))
        if not prepares or not decodes or any(s.attrs.get("device_s") is None
                                              for s in prepares):
            continue
        secs += sum(kernels.values()) - sum(s.attrs["device_s"] for s in prepares)
        steps += sum(s.attrs.get("steps", 0) for s in decodes)
    return 1e3 * secs / steps if steps and secs > 0 else None
