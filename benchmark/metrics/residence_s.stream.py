"""The median time a request holds its decode slot: the program's
request.resident span, from its slot grant (when a first attempt's audio
is bound) through its insert and every chunk it rides to its harvest, over
the harvests in the window."""

import numpy as np

from benchmark.spans import spans

LAYER = "continuous scheduler"
UNIT = "s"
SOURCE = "program_counter"
MOVES = "update_p95_s"


def read(run):
    got = spans(run, "request.resident")
    return float(np.median([s.seconds for s in got])) if got else None
