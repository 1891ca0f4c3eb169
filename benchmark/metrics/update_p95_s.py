"""The 95th percentile of the content age of every update pushed in the
window (push time minus the capture time of the newest audio it decoded),
over all updates of all streams: how stale the slowest captions are."""

import numpy as np

LAYER = "end to end"
UNIT = "s"
SOURCE = "host_clock"
MOVES = None


def read(run):
    ages = [age for _, _, age in run.data.get("pushes", [])]
    return float(np.percentile(ages, 95)) if ages else None
