"""The reader of the continuous pool's graph counters: the share of the
window's decode steps that were replayed, and nothing for a program that
keeps no such counter."""

import pytest

from benchmark.harness import Run, reader
from benchmark.weights import dims

from .test_bench_costmodel import LARGE_V3


def _stream(ticks):
    run = Run(kind="stream", dims=dims(LARGE_V3), mix={}, seconds=10.0, setup_s=3.5)
    run.data = {"pushes": [], "ticks": ticks, "slots": 16, "steps_per_chunk": 8,
                "steps": [], "finished": [], "window": (0.0, 10.0)}
    return run


def test_graph_share_is_replayed_steps_over_all_steps_of_the_window():
    run = _stream({"ticks": 10, "graph_steps": 72, "eager_steps": 8, "graph_captures": 0})
    assert reader("graph_share.stream").read(run) == pytest.approx(90.0)


@pytest.mark.parametrize("ticks", [
    {"ticks": 10, "step_s": 4.0},
    {"ticks": 0, "graph_steps": 0, "eager_steps": 0, "graph_captures": 0},
], ids=["no-counter", "no-step"])
def test_graph_share_reads_nothing_without_a_replayable_count(ticks):
    assert reader("graph_share.stream").read(_stream(ticks)) is None
