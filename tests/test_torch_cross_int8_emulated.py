"""The CUDA source of K4, K5, K6 and K5's window form run on the CPU,
against their plain versions.

The kernels themselves run only on a card (tests/test_torch_cuda.py). Here
g++ (C++17) compiles csrc/cross_attention.cu (every Int8Packed
instantiation, Tq = 1 for K4 and K5 and 2..8 for the windows) against
tests/cuda_emu/common.cuh, which stands in for csrc/common.cuh and the CUDA
headers (a coroutine per CUDA thread; shuffles as exchanges between warp
barriers; cp.async copies landing at their wait_group or at once; the CTAs
of a thread-block cluster run together, each with its own shared memory,
poisoned with NaN when the CTA exits), so that the split over T is held
here: chunks taken from each row's own extent n (len clipped to T, or T
where len <= 0), ranks whose chunk is empty, the softmax statistics and the
PV partials (a query at a time, the output split between the ranks) read
through distributed shared memory between cluster barriers, inactive rows
written as zeros without a barrier, the swapped halves of odd rows, the
copy wave's commit groups and their waits, and the same bits whichever
order the clusters run in, with copies landing late or at once and warps
in step or one running ahead. The harness forces the
split S; the Python wrappers take none. Inputs are q at scale 0.05 (as on
the card) and int8 K|V from a numpy seed; the tolerance is K4's card
tolerance, 1e-3 of each computed row's own max|ref|, for every query of a
window. Skips where no g++ is installed.
"""

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
def cross_binary(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("cross_int8_emu")
    return build_emulated(gxx, d, "cross_int8_harness.cpp")


def build_emulated(gxx, d, harness):
    """g++ builds `harness` (tests/cuda_emu) over csrc/cross_attention.cu,
    its dynamic shared memory taken from the emulator, into d/cross."""
    src = (_kernels.CSRC_DIR / "cross_attention.cu").read_text()
    old = "extern __shared__ __align__(16) unsigned char smem[];"
    assert src.count(old) == 1 and "<<<" not in src  # cudaLaunchKernelEx runs as it is
    (d / "cross_attention.cu").write_text(src.replace(old, "unsigned char* smem = emu_smem;"))
    for name in ("common.cuh", harness):
        shutil.copy(EMU_DIR / name, d / name)
    subprocess.run([gxx, "-std=c++17", "-O1", "-o", str(d / "cross"), str(d / harness)],
                   check=True, capture_output=True, text=True)
    return d / "cross"


def make_inputs(seed, q_shape, t, lengths, active):
    """q at scale 0.05 and int8 K|V from a numpy seed; lengths None is the
    entry without lengths (masks 0), active None the one without an active
    mask (masks 1), else masks 2."""
    rng = np.random.default_rng(seed)
    b, h = q_shape[:2]
    q = torch.from_numpy(rng.standard_normal(q_shape).astype(np.float32) * 0.05).to(
        torch.bfloat16)
    kvp = torch.from_numpy(rng.integers(-127, 128, (b, h, t, 128)).astype(np.int8))
    ln = torch.tensor(lengths or [t] * b, dtype=torch.int32)
    act = torch.tensor(active or [True] * b)
    masks = 0 if lengths is None else 1 if active is None else 2
    return q, kvp, ln, act, masks


def run_source(binary, tmp_path, q, kvp, ln, act, masks, s, eager, schedule):
    """The source's launch at split s (twice, across schedules: the bits
    must agree) -> the f32 output, shaped as q."""
    b, h, t = kvp.shape[:3]
    tq = 1 if q.dim() == 3 else q.shape[2]
    (tmp_path / "in.bin").write_bytes(q.view(torch.int16).numpy().tobytes()
                                      + kvp.numpy().tobytes() + ln.numpy().tobytes()
                                      + act.numpy().astype(np.uint8).tobytes())
    run = subprocess.run(
        [str(binary), *map(str, (b, h, t, tq, s, masks, int(eager), schedule)),
         str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
        capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == f"rc=0 splits={s} identical=1", run.stdout
    out = torch.frombuffer(bytearray((tmp_path / "out.bin").read_bytes()), dtype=torch.float32)
    return out.reshape(q.shape)


def assert_rows_close(out, ref, act):
    """Finite everywhere, zero on the inactive rows, and on each active
    batch row within 1e-3 of that row's own max|ref|."""
    assert torch.isfinite(out).all()
    assert not out[~act].any(), "inactive rows must be zero"
    out, ref = out[act], ref[act]
    err = (out - ref).abs().flatten(1).amax(1)
    tol = 1e-3 * ref.abs().flatten(1).amax(1)
    assert bool((err <= tol).all()), (err, tol)


# (S, B, H, T, lengths, active, copies land at once, schedule). lengths None
# is K4 without lengths; active None is K4 with lengths, else K5. The
# lengths cover 0 (a uniform softmax over all T), 1, T, above T, and the
# chunk boundaries of n = len: a multiple of S (equal chunks) and one past
# it (a short last chunk), and n < S (empty ranks). T covers one position,
# a single score pass (64), one row past it (65), K5's cap (640) and the
# encoder context (1500, the largest chunk at S = 1). Schedule 0 keeps the
# warps in step, 1 runs the first ahead, 2 the last; the harness reruns each
# case with the other copy timing, the next schedule and the clusters in
# reverse, and the bits must not change.
CASES = [
    (1, 2, 2, 1, None, None, False, 0),
    (8, 2, 1, 1, None, None, True, 1),
    (8, 2, 1, 1, [0, 1], [True, True], False, 2),
    (2, 2, 2, 64, [64, 0], None, False, 1),
    (4, 2, 2, 64, [3, 4], [True, True], True, 0),
    (4, 2, 1, 65, [1, 65], [True, False], False, 2),
    (2, 4, 1, 65, [33, 34, 32, 66], [True, True, False, True], True, 1),
    (1, 2, 1, 640, [640, 700], None, True, 2),
    (2, 4, 1, 640, [320, 321, 640, 0], [True] * 4, False, 0),
    (8, 4, 1, 640, [160, 161, 159, 640], [True, False, True, True], False, 1),
    (2, 4, 1, 640, [640, 640, 1, 0], [False] * 4, False, 2),
    (4, 1, 2, 1500, None, None, True, 2),
    (8, 1, 1, 1500, [1500], [True], False, 0),
    (1, 1, 1, 1500, [1501], None, False, 1),
]


@pytest.mark.parametrize("s, b, h, t, lengths, active, eager, schedule", CASES)
def test_cross_attention_int8_source_emulated(cross_binary, tmp_path, s, b, h, t, lengths,
                                              active, eager, schedule):
    q, kvp, ln, act, masks = make_inputs(1000 * s + 10 * t + b, (b, h, 64), t, lengths, active)
    out = run_source(cross_binary, tmp_path, q, kvp, ln, act, masks, s, eager, schedule)
    if masks == 2:
        ref = tattn.cross_attention_int8_skip_ref(q, kvp, ln, act)
    else:
        ref = tattn.cross_attention_int8_ref(q, kvp, None if masks == 0 else ln)
    assert_rows_close(out, ref, act)


# (B, H, T, S): the launcher's split at the serving shapes (the window
# path's buckets at large-v3's 20 heads over 1500 positions; the
# continuous pool's 8 slots at its 640 cap), and where a chunk of T must
# fit in shared memory (T = 8192 at many rows) or stay >= 64 rows (T = 65).
SPLITS = [(1, 20, 1500, 8), (2, 20, 1500, 8), (4, 20, 1500, 4), (8, 20, 640, 2),
          (16, 20, 1500, 1), (16, 20, 8192, 8), (1, 1, 65, 1), (1, 1, 128, 2)]


@pytest.mark.parametrize("b, h, t, s", SPLITS)
def test_cross_attention_int8_split_choice(cross_binary, b, h, t, s):
    assert split_choice(cross_binary, b, h, t, 1) == s


def split_choice(binary, b, h, t, tq):
    run = subprocess.run([str(binary), "splits", str(b), str(h), str(t), str(tq)],
                         capture_output=True, text=True, timeout=60, check=True)
    return int(run.stdout)


# The windows, Tq > 1: (S, B, H, T, Tq, lengths, active, copies land at
# once, schedule), as CASES. lengths None is K6 without lengths; active
# None is K6 with lengths, else K5's window form. Tq covers 2, 5 (the
# verify window at k = 4) and 8 (the most); S 1, 2, 4 and 8; lengths 0 (a
# uniform softmax over all T for every query), 1 (ranks with empty chunks),
# T, above T and on and one past the chunk boundaries; inactive rows, and a
# call with none active. T covers one score pass (64) and one row past it
# (65), K5's cap (640), the encoder context (1500: K6's shape at S = 8 and
# the largest chunk at Tq = 3, S = 1) and 2048 at Tq = 8 and S = 2, the
# 1024-row chunk that fills the shared memory at Tq = 8.
WINDOW_CASES = [
    (1, 2, 1, 64, 2, None, None, False, 0),
    (2, 2, 2, 65, 5, [0, 65], None, True, 1),
    (4, 2, 1, 65, 8, [1, 66], None, False, 2),
    (8, 4, 1, 640, 5, [160, 161, 0, 1], [True, True, True, False], False, 0),
    (2, 4, 1, 640, 8, [320, 321, 640, 0], [True] * 4, True, 1),
    (4, 4, 1, 640, 2, [640, 2, 3, 700], [False, True, True, True], False, 2),
    (2, 4, 1, 640, 5, [640] * 4, [False] * 4, True, 0),
    (8, 1, 2, 1500, 5, [1500], None, False, 1),
    (8, 1, 1, 1500, 8, None, None, True, 2),
    (1, 1, 1, 1500, 3, [1501], None, False, 0),
    (2, 1, 1, 2048, 8, [2048], [True], False, 1),
]


@pytest.mark.parametrize("s, b, h, t, tq, lengths, active, eager, schedule", WINDOW_CASES)
def test_cross_attention_int8_window_source_emulated(cross_binary, tmp_path, s, b, h, t, tq,
                                                     lengths, active, eager, schedule):
    q, kvp, ln, act, masks = make_inputs(100 * tq + 10 * s + t, (b, h, tq, 64), t, lengths,
                                         active)
    out = run_source(cross_binary, tmp_path, q, kvp, ln, act, masks, s, eager, schedule)
    if masks == 2:
        ref = tattn.cross_attention_int8_skip_window_ref(q, kvp, ln, act)
    else:
        ref = tattn.cross_attention_int8_window_ref(q, kvp, None if masks == 0 else ln)
    assert_rows_close(out, ref, act)


# (B, H, T, Tq, S): the launcher's split for the windows at the verify
# shapes (K6: one request over the encoder context; K5's window form: the
# 8-slot pool at its 640 cap), T = 8192 at Tq = 8 (1024 rows a CTA), and
# where the rows a CTA can hold at Tq = 8 (1024) force a split that Tq = 1
# (1536) does not.
WINDOW_SPLITS = [(1, 20, 1500, 5, 8), (1, 20, 1500, 8, 8), (8, 20, 640, 5, 2),
                 (1, 20, 8192, 8, 8), (264, 1, 1500, 1, 1), (264, 1, 1500, 8, 2)]


@pytest.mark.parametrize("b, h, t, tq, s", WINDOW_SPLITS)
def test_cross_attention_int8_window_split_choice(cross_binary, b, h, t, tq, s):
    assert split_choice(cross_binary, b, h, t, tq) == s
