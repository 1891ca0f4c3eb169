"""K2's CUDA source run on the CPU, against int8_matmul_ref.

The kernel itself runs only on a card (tests/test_torch_cuda.py). Here g++
(C++17) compiles csrc/int8_matmul.cu against tests/cuda_emu/common.cuh,
which stands in for csrc/common.cuh and the CUDA headers (a coroutine per
CUDA thread; ldmatrix, mma.sync and the byte permutes with their lane and
byte layouts; cp.async copies landing at their wait_group; the CTAs of a
thread-block cluster run together, each with its own shared memory), so
that the kernel's index arithmetic is held here: the int8 tile read
through ldmatrix .trans as b16 column pairs and turned into bf16 k-pairs
in registers, A's rows g and g + 8 as columns 2g and 2g + 1, the swizzles
(no ldmatrix bank conflict), the cp.async ring and its barriers (copies
landing at their wait or at once, warps in step or one running ahead),
the ragged n8 tiles and 64-row M tiles, and the split over K across a
cluster: slices of unequal length, the partial sums read from the other
CTAs' shared memory after the cluster barrier, and the same bits whichever
order the clusters run in. Inputs are bf16 x and int8 w8 over the full
range [-128, 127] from a numpy seed; the tolerance is the card tests' 2^-7
of max|ref|. Skips where no g++ is installed.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from whisperlive_tpu_torch.ops import _kernels
from whisperlive_tpu_torch.ops import quant_matmul as tqmm

EMU_DIR = Path(__file__).resolve().parent / "cuda_emu"


@pytest.fixture(scope="module")
def k2_binary(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("k2_emu")
    src = (_kernels.CSRC_DIR / "int8_matmul.cu").read_text()
    src, n_smem = re.subn(r"extern __shared__ __align__\(\d+\) unsigned char (\w+)\[\];",
                          r"unsigned char* \1 = emu_smem;", src)
    assert n_smem == 1 and "<<<" not in src  # cudaLaunchKernelEx runs as it is
    (d / "int8_matmul.cu").write_text(src)
    for name in ("common.cuh", "k2_harness.cpp"):
        shutil.copy(EMU_DIR / name, d / name)
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(d / "k2"), str(d / "k2_harness.cpp")],
                   check=True, capture_output=True, text=True)
    return d / "k2"


# (M, K, N, splits, copies land at once, schedule). M covers one row, the
# ragged n8 tiles (7, 9, 17: NT = 1, 2, 4 with a partial tile), a full
# tile (8, 16), the verify window (40: NT = 8, 24 rows zero) and a second,
# ragged 64-row M tile (65). K = 640 is 10 chunks of 64: the 8-stage ring
# wraps at NT = 4 and 8 (6 and 4 stages), and 3 or 4 slices of 4 or 3
# chunks leave a short last slice (2 or 1 chunks); 4 slices are the
# largest cluster. splits 0 takes the launcher's own choice (one chunk a
# slice at these small shapes). Copies that land late catch a missing
# wait; copies that land at once with one warp run ahead (schedule 1: the
# first, 2: the last; 0 keeps the warps in step) catch a missing barrier.
CASES = [
    (1, 640, 128, 3, False, 0),
    (7, 640, 64, 1, False, 1),
    (8, 256, 128, 0, True, 2),
    (9, 640, 64, 4, False, 2),
    (16, 512, 128, 4, True, 1),
    (17, 640, 64, 3, False, 0),
    (40, 320, 128, 0, False, 1),
    (65, 640, 64, 4, True, 2),
]


@pytest.mark.parametrize("m, k, n, splits, eager, schedule", CASES)
def test_int8_matmul_source_emulated(k2_binary, tmp_path, m, k, n, splits, eager, schedule):
    rng = np.random.default_rng(m * 1000 + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    w8 = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    s = torch.from_numpy(np.abs(rng.standard_normal(n)).astype(np.float32) * 0.01).to(
        torch.bfloat16)
    (tmp_path / "in.bin").write_bytes(x.view(torch.int16).numpy().tobytes()
                                      + w8.numpy().tobytes() + s.view(torch.int16).numpy().tobytes())
    run = subprocess.run(
        [str(k2_binary), *map(str, (m, k, n, splits, int(eager), schedule)),
         str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
        capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    assert run.stdout.startswith("rc=0 ") and " bank_conflicts=0 " in run.stdout, run.stdout
    assert "identical=1" in run.stdout, run.stdout
    out = torch.frombuffer(bytearray((tmp_path / "out.bin").read_bytes()), dtype=torch.bfloat16)
    out = out.reshape(m, n).float()
    ref = tqmm.int8_matmul_ref(x, w8, s).float()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 2.0**-7 * ref.abs().max().item()
