"""The 50th percentile of the content age of every update pushed in the
window (push time minus the capture time of the newest audio it decoded),
over all updates of all streams."""

import numpy as np

LAYER = "serving"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "update_p95_s"


def read(run):
    ages = [age for _, _, age in run.data.get("pushes", [])]
    return float(np.percentile(ages, 50)) if ages else None
