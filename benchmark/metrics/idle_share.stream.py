"""The share of the traced stretch with no kernel or copy on the card."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "updates_per_s"


def read(run):
    tr = run.trace
    if run.kind != "stream" or not tr or not tr["window_s"] or not tr["n_device_events"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
