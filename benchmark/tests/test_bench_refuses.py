"""A run without a card refuses (exit code 2, no result line) rather than
falling back to the CPU, and a checkout without the program fails."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CMD = ["benchmark/run.py", "--workload", "large-v3.stream20", "--seed", "4294967311",
       "--seconds", "1", "--trace", "0"]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")


def test_refuses_without_a_card(no_card):
    p = subprocess.run([sys.executable, *CMD], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "refused" in p.stderr


def test_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, *CMD], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
