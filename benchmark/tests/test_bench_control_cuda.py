"""On the card: at each cell's own size and load, the program's run comes
out correct and the control put in its place (the reference one precision
step below the configuration's int8) not correct, both judged by the
harness's own check, on one seed. Skipped without a card.

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_control_cuda.py -q
"""

import pytest
import torch

from benchmark import control, harness

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in harness.load_spec()["workloads"]])
def test_control_fails_and_program_passes(card, cell):
    r = control.readings(cell, 2 ** 32 + 7, 8.0)
    assert r["program"]["correct"], r
    assert not r["control"]["correct"], r
