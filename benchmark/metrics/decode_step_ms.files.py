"""Host time of one step of a window batch's decode: the program's
engine.decode spans (prefill and loop) over their steps, summed over the
decodes that ended in the window."""

from benchmark.spans import spans

LAYER = "offline engine"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "rtfx"


def read(run):
    got = spans(run, "engine.decode")
    steps = sum(s.attrs.get("steps", 0) for s in got or ())
    return 1e3 * sum(s.seconds for s in got) / steps if steps else None
