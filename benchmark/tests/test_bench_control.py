"""The control, put in the program's place, is judged by the harness's own
check and comes out not correct, while the program's run of the same seed
comes out correct: at a tiny width on the CPU, for each traffic kind. (The
card test does the same at each cell's own size.)"""

import pytest

from benchmark import control

from .conftest import CELLS, WIDE


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_control_is_judged_not_correct(kind):
    cell, over, seconds = CELLS[kind]
    r = control.readings(cell, 2 ** 32 + 101, seconds, device="cpu", config=dict(WIDE),
                         mix_override=dict(over, drain_s=60.0))
    assert r["program"]["correct"], r
    assert not r["control"]["correct"], r
    assert r["control"]["widest_gap"] > r["program"]["widest_gap"]
