"""Host time of one continuous decode step: the scheduler's step seconds
over its ticks times the steps a chunk, deltas over the window (the status
copy syncs each chunk)."""

LAYER = "continuous scheduler"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "updates_per_s"


def read(run):
    t = run.data.get("ticks")
    if not t or not t["ticks"]:
        return None
    return 1e3 * t["step_s"] / (t["ticks"] * run.data["steps_per_chunk"])
