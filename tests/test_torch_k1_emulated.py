"""K1's CUDA source run on the CPU, against fused_attention_ref.

The kernel itself runs only on a card (tests/test_torch_cuda.py). Here g++
(C++17) compiles csrc/fused_attention.cu against tests/cuda_emu/common.cuh,
which stands in for csrc/common.cuh and the CUDA headers (a coroutine per
CUDA thread; shuffles, ldmatrix and mma.sync as exchanges between warp
barriers; cp.async copies landing at their wait_group), so that the
kernel's index arithmetic is held here: the mma.sync fragment layouts and
the bf16x2 reuse of the scores as the PV product's A operand, the swizzle
(no ldmatrix bank conflict), the cp.async ring and its barriers (copies
landing at their wait or at once, warps in step or one running ahead),
the ragged key and query tiles, strided q/k/v and a peaked softmax.
Inputs are bf16 from a numpy seed; the tolerance is the card tests' 2^-6
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
from whisperlive_tpu_torch.ops import attention as tattn

EMU_DIR = Path(__file__).resolve().parent / "cuda_emu"


@pytest.fixture(scope="module")
def k1_binary(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("k1_emu")
    src = (_kernels.CSRC_DIR / "fused_attention.cu").read_text()
    src = re.sub(r"extern __shared__ __align__\(\d+\) unsigned char (\w+)\[\];",
                 r"unsigned char* \1 = emu_smem;", src)
    src, n_launch = re.subn(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", src, flags=re.S)
    assert n_launch == 1
    (d / "fused_attention.cu").write_text(src)
    for name in ("common.cuh", "k1_harness.cpp"):
        shutil.copy(EMU_DIR / name, d / name)
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(d / "k1"), str(d / "k1_harness.cpp")],
                   check=True, capture_output=True, text=True)
    return d / "k1"


# (B, T, H, q scale, strided, copies land at once, schedule): a single key;
# ragged key tiles (28, 65, 129, 300, and 540 = 8*64 + 28 like 1500 = 23*64
# + 28); ragged query tiles (128 queries a CTA: 129, 200, 300, 540); a
# peaked softmax (q 4x); q, k, v as head slices of one [B, T, 3H, 64]
# tensor. Copies that land late catch a missing wait; copies that land at
# once with one warp run ahead (schedule 1: the first, 2: the last; 0 keeps
# the warps in step) catch a missing barrier.
CASES = [
    (1, 1, 2, 1.0, False, False, 0),
    (1, 28, 2, 1.0, False, True, 1),
    (2, 65, 2, 1.0, True, False, 2),
    (1, 129, 1, 4.0, False, False, 0),
    (2, 200, 2, 4.0, True, True, 1),
    (1, 300, 1, 1.0, False, True, 2),
    (1, 540, 1, 1.0, True, False, 1),
]


@pytest.mark.parametrize("b, t, h, q_scale, strided, eager, schedule", CASES)
def test_fused_attention_source_emulated(k1_binary, tmp_path, b, t, h, q_scale, strided, eager,
                                         schedule):
    rng = np.random.default_rng(t * 16 + b)
    width = 3 * h if strided else h
    parts = [rng.standard_normal((b, t, width, 64)).astype(np.float32)
             for _ in range(1 if strided else 3)]
    if strided:
        parts[0][:, :, :h] *= q_scale
    else:
        parts[0] *= q_scale
    bufs = [torch.from_numpy(p).to(torch.bfloat16) for p in parts]
    flat = torch.cat([x.flatten() for x in bufs])
    (tmp_path / "in.bin").write_bytes(flat.view(torch.int16).numpy().tobytes())
    strides = (t * width * 64, width * 64, 64)
    if strided:
        q, k, v = bufs[0][:, :, :h], bufs[0][:, :, h:2 * h], bufs[0][:, :, 2 * h:]
        offsets = (0, h * 64, 2 * h * 64)
    else:
        q, k, v = bufs
        offsets = tuple(i * bufs[0].numel() for i in range(3))
    run = subprocess.run(
        [str(k1_binary), *map(str, (b, t, h, *strides, *offsets, int(eager), schedule)),
         str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
        capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    assert "rc=0 bank_conflicts=0 " in run.stdout, run.stdout
    out = torch.frombuffer(bytearray((tmp_path / "out.bin").read_bytes()), dtype=torch.bfloat16)
    out = out.reshape(b, t, h, 64).float()
    ref = tattn.fused_attention_ref(q, k, v).float()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 2.0**-6 * ref.abs().max().item()
