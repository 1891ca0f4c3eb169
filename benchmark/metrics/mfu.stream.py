"""Model operations of the windows finished in the window (encode at the
real audio positions, cross-KV, the prompt's prefill and the tokens
generated, counted by the frozen cost model from the traffic's own
counts), over the window's seconds at the card's bf16 peak."""

from benchmark import costmodel as cm

LAYER = "model step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "updates_per_s"


def read(run):
    done = run.data.get("finished") if run.kind == "stream" else None
    if not done:
        return None
    flops = sum(cm.window_flops(run.dims, r["audio_s"], len(r["prompt"]), len(r["served"]))
                for r in done)
    return 100.0 * flops / (run.seconds * cm.PEAK_FLOPS)
