"""Device time of one window batch's encoder and cross-KV, which the card
paces: the device_s (an event pair) of the program's engine.prepare spans
that ended in the window, averaged."""

from benchmark.spans import spans

LAYER = "model step"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "rtfx"


def read(run):
    got = [s.attrs["device_s"] for s in spans(run, "engine.prepare") or ()
           if s.attrs.get("device_s") is not None]
    return 1e3 * sum(got) / len(got) if got else None
