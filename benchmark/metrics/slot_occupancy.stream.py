"""Occupied slot rows over the pool's rows, summed over the window's ticks."""

LAYER = "continuous scheduler"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "updates_per_s"


def read(run):
    t = run.data.get("ticks")
    if not t or not t["ticks"]:
        return None
    return 100.0 * t["step_rows"] / (t["ticks"] * run.data["slots"])
