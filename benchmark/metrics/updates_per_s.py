"""Partial-transcript updates pushed to all streams in the window, over the
window's seconds. Below the pool's knee every stream asks again as soon as
its last answer is back and a second of new audio has come, so the count is
the streams times the refresh rate each sees: the faster the round trip,
the more updates. Read from any run that recorded its pushes, whatever its
traffic kind."""

LAYER = "end to end"
UNIT = "updates/s"
SOURCE = "host_clock"
MOVES = None


def read(run):
    if "pushes" not in run.data:
        return None
    return len(run.data["pushes"]) / run.seconds
