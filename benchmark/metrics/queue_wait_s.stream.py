"""The median wait of a stream's request for a decode slot: the program's
request.queued span, from its submit (or a retry's re-queue) to its slot
grant, over the grants in the window."""

import numpy as np

from benchmark.spans import spans

LAYER = "continuous scheduler"
UNIT = "s"
SOURCE = "program_counter"
MOVES = "updates_per_s"


def read(run):
    got = spans(run, "request.queued")
    return float(np.median([s.seconds for s in got])) if got else None
