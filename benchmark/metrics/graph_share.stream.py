"""The share of the continuous pool's decode steps in the window that were
replayed from its CUDA graph: the scheduler's tick_stats `graph_steps` over
`graph_steps` + `eager_steps`, deltas over the window. None where the
program keeps no such counter."""

LAYER = "model step"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "updates_per_s"


def read(run):
    t = run.data.get("ticks")
    if not t or "graph_steps" not in t:
        return None
    steps = t["graph_steps"] + t["eager_steps"]
    return 100.0 * t["graph_steps"] / steps if steps > 0 else None
