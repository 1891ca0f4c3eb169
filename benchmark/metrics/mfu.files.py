"""Model operations of the window batches completed in the window (each
window: encode at its real audio positions, cross-KV, language detection
where it ran, the prompt's prefill and the tokens generated, counted by the
frozen cost model from the traffic's own counts), over the window's
seconds at the card's bf16 peak."""

from benchmark import costmodel as cm

LAYER = "model step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "rtfx"


def read(run):
    done = run.data.get("done") if run.kind == "files" else None
    if not done:
        return None
    flops = 0.0
    for b in done:
        for j in range(b["rows"]):
            flops += cm.window_flops(run.dims, b["real_s"][j], len(b["prompts"][j]),
                                     len(b["served"][j]), detect=b["languages"] is not None)
    return 100.0 * flops / (run.seconds * cm.PEAK_FLOPS)
