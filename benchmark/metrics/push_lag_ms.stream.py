"""The median hand-back of an update: the program's request.push span,
from the scheduler thread's resolve of the request to the segments' push
returning on the streams' event loop, over the pushes in the window."""

import numpy as np

from benchmark.spans import spans

LAYER = "serving"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "update_p95_s"


def read(run):
    got = spans(run, "request.push")
    return 1e3 * float(np.median([s.seconds for s in got])) if got else None
