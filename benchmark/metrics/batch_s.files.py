"""Host time of a window batch, from the engine's prepare to the decode's
results (which sync), averaged over the batches completed in the window."""

LAYER = "offline engine"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "rtfx"


def read(run):
    done = run.data.get("done") if run.kind == "files" else None
    if not done:
        return None
    return sum(b["t1"] - b["t0"] for b in done) / len(done)
