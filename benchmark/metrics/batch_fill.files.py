"""Real windows over the rows of their batch buckets, over the batches
completed in the window."""

LAYER = "offline engine"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "rtfx"


def read(run):
    done = run.data.get("done") if run.kind == "files" else None
    if not done:
        return None
    return 100.0 * sum(b["rows"] for b in done) / sum(b["bucket"] for b in done)
