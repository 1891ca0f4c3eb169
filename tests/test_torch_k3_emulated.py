"""K3's CUDA source run on the CPU, against int8_matmul_t_ref.

The kernel itself runs only on a card (tests/test_torch_cuda.py). Here g++
(C++17) compiles csrc/int8_matmul_t.cu against tests/cuda_emu/common.cuh,
which stands in for csrc/common.cuh and the CUDA headers (a coroutine per
CUDA thread; ldmatrix, mma.sync and the byte permutes with their lane and
byte layouts; bulk copies landing when their mbarrier is waited on, or at
once; mbarriers, named barriers and a blocked wait that can never complete
aborting as a deadlock), so that the kernel's index arithmetic is held
here: the int8 [N, K] tile read through a plain ldmatrix as b16 and its
bytes 4t .. 4t + 3 taken as the k pairs (2t, 2t + 1) and (2t + 8, 2t + 9)
in A and in x's B fragments alike, the padded stage rows (no ldmatrix bank
conflict), the hand-overs between the copying, multiplying and summing
warps (copies landing late or at once, warps in step or one running ahead),
1-3 persistent CTAs each walking many 16-row tiles through a ring of 2 to 8
stages and 4 partial buffers, the ragged last tile (rows >= N neither
copied, since only the N real rows are device memory, nor stored), the n8
tiles and 40-row launches (rows >= M are not stored: the output's guard
rows keep their fill), 16-byte stores only where a row of out is 16-byte
aligned, and the same bits whichever order the CTAs run in.
Inputs are bf16 x and int8 w8 over the full range [-128, 127] from a numpy
seed; the tolerance is the card tests' 1e-5 of max|ref|. Skips where no g++
is installed.
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
def k3_binary(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("k3_emu")
    src = (_kernels.CSRC_DIR / "int8_matmul_t.cu").read_text()
    src, n_smem = re.subn(r"extern __shared__ __align__\(\d+\) unsigned char (\w+)\[\];",
                          r"unsigned char* \1 = emu_smem;", src)
    assert n_smem == 1 and "<<<" not in src  # cudaLaunchKernelEx runs as it is
    (d / "int8_matmul_t.cu").write_text(src)
    for name in ("common.cuh", "k3_harness.cpp"):
        shutil.copy(EMU_DIR / name, d / name)
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(d / "k3"), str(d / "k3_harness.cpp")],
                   check=True, capture_output=True, text=True)
    return d / "k3"


# (M, K, N, persistent CTAs, ring depth, copies land at once, schedule). M
# covers one row, the ragged n8 tiles (7, 9, 17: NT = 1, 2, 4 with a
# partial n8 tile), full tiles (8, 16), the verify window (40: NT = 5) and
# a second launch (64 = 40 + 24, 65 = 40 + 25). N covers one row, a partial
# tile (63, 65: 16-row tiles) and many tiles with a ragged last one (333,
# 330, 1000: 21, 21 and 63 tiles); N modulo 4 is 0, 1, 2 and 3 among them,
# so rows of out start 16-byte aligned in every row, one in two, one in
# four, or only the first (a misaligned 16-byte store aborts). K = 64 gives
# six of the eight multiplying warps no k step pair; 640 and 1280 are 20
# and 40 pairs. 1-3 CTAs each walk up to 63 tiles through a ring of 2 to 8
# stages and 4 partial buffers, so both wrap many times; ctas 0 and stages
# 0 take the launcher's own plan, made on the first run and read from its
# table on the second. Copies that land late catch a missing wait; copies
# that land at once with one warp run ahead (schedule 1: the first, 2: the
# last; 0 keeps the warps in step) catch a missing hand-over.
CASES = [
    (1, 640, 1000, 3, 3, False, 0),
    (7, 64, 333, 2, 4, True, 1),
    (8, 1280, 65, 1, 3, False, 2),
    (9, 640, 63, 1, 5, True, 0),
    (17, 64, 1000, 3, 8, False, 1),
    (40, 640, 333, 2, 3, False, 2),
    (64, 1280, 64, 1, 3, True, 1),
    (65, 640, 1, 2, 0, False, 0),
    (8, 640, 1000, 0, 0, False, 0),
    (16, 1280, 333, 3, 6, True, 2),
    (1, 1280, 65, 2, 7, True, 0),
    (9, 640, 330, 2, 4, False, 1),
    (17, 640, 333, 3, 2, False, 2),
]


@pytest.mark.parametrize("m, k, n, ctas, stages, eager, schedule", CASES)
def test_int8_matmul_t_source_emulated(k3_binary, tmp_path, m, k, n, ctas, stages, eager,
                                       schedule):
    rng = np.random.default_rng(m * 1000 + k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    w8 = torch.from_numpy(rng.integers(-128, 128, (n, k)).astype(np.int8))
    s = torch.from_numpy(np.abs(rng.standard_normal(n)).astype(np.float32) * 0.01).to(
        torch.bfloat16)
    (tmp_path / "in.bin").write_bytes(x.view(torch.int16).numpy().tobytes()
                                      + w8.numpy().tobytes() + s.view(torch.int16).numpy().tobytes())
    run = subprocess.run(
        [str(k3_binary), *map(str, (m, k, n, ctas, stages, int(eager), schedule)),
         str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
        capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    assert run.stdout.startswith("rc=0 ") and " bank_conflicts=0 " in run.stdout, run.stdout
    assert " guard=1 " in run.stdout and "identical=1" in run.stdout, run.stdout
    out = torch.frombuffer(bytearray((tmp_path / "out.bin").read_bytes()), dtype=torch.float32)
    out = out.reshape(m, n)
    ref = tqmm.int8_matmul_t_ref(x, w8, s)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
