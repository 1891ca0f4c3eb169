"""The metric arithmetic on recorded toy events: a tail over all updates, a
rate as all the work over all the time, and which metrics a cell reports."""

import numpy as np
import pytest

from benchmark.harness import Run, load_spec, metrics_for, reader
from benchmark.weights import dims

from .test_bench_costmodel import LARGE_V3


def _stream(pushes, ticks=None):
    run = Run(kind="stream", dims=dims(LARGE_V3), mix={}, seconds=10.0, setup_s=3.5)
    run.data = {"pushes": pushes, "ticks": ticks or {}, "slots": 16, "steps_per_chunk": 8,
                "steps": [{"t1": 0.5, "tokens": 40}, {"t1": 5.0, "tokens": 60},
                          {"t1": 12.0, "tokens": 99}], "finished": [], "window": (0.0, 10.0)}
    return run


def test_the_tail_is_over_all_updates_of_all_streams():
    # one stream with many fast updates, one with few slow ones: the tail of
    # all updates, not a median of per-stream tails
    pushes = [(i * 0.1, "a", 0.5) for i in range(90)] + [(i, "b", 5.0) for i in range(10)]
    run = _stream(pushes)
    ages = [p[2] for p in pushes]
    assert reader("update_p95_s").read(run) == pytest.approx(np.percentile(ages, 95))
    assert reader("update_p50_s.stream").read(run) == 0.5
    # every update of every stream, over the window's seconds
    assert reader("updates_per_s").read(run) == 10.0
    assert reader("setup_s").read(run) == 3.5


def test_scheduler_counters_are_window_deltas():
    run = _stream([], {"ticks": 10, "step_s": 4.0, "step_rows": 120})
    assert reader("step_ms.stream").read(run) == pytest.approx(1e3 * 4.0 / 80)
    assert reader("slot_occupancy.stream").read(run) == pytest.approx(75.0)
    assert reader("update_p95_s").read(run) is None


def test_rtfx_is_all_the_audio_over_all_the_time():
    run = Run(kind="files", dims=dims(LARGE_V3), mix={}, seconds=10.0, setup_s=1.0)
    done = [{"t0": 0.0, "t1": 2.0, "rows": 3, "bucket": 4, "real_s": [30.0, 30.0, 10.0, 0.0]},
            {"t0": 2.0, "t1": 5.0, "rows": 1, "bucket": 1, "real_s": [12.5]}]
    run.data = {"done": done, "t0": 0.0}
    assert reader("rtfx").read(run) == pytest.approx(82.5 / 5.0)
    assert reader("batch_s.files").read(run) == pytest.approx(2.5)
    assert reader("batch_fill.files").read(run) == pytest.approx(80.0)
    assert reader("updates_per_s").read(run) is None


def test_each_cell_reports_its_metrics():
    spec = load_spec()
    for cell in spec["workloads"]:
        e2e = {m["name"] for m in metrics_for(spec, cell["name"], "end_to_end")}
        per = metrics_for(spec, cell["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert per and all(m["moves"] in e2e for m in per)
        for m in per + [x for x in spec["end_to_end"] if x["name"] in e2e]:
            mod = reader(m["name"])
            assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
            if "layer" in m:
                assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
