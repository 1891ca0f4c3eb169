"""The CUDA source of K7 and K8 run on the CPU, against their plain
versions.

The kernels themselves run only on a card (tests/test_torch_cuda.py). Here
g++ (C++17) compiles csrc/cross_attention.cu (every Int4Halves
instantiation: Tq = 1 for K7, 2..8 for K8) against tests/cuda_emu/common.cuh,
the CPU stand-in for csrc/common.cuh and the CUDA headers that
tests/test_torch_cross_int8_emulated.py describes, so that the split over T
is held for the int4 rows too: the copy wave from two arrays (k4 and v4)
into one swizzled row, chunks of each row's own extent n (len clipped to
T, or T where len <= 0), ranks whose chunk is empty, the nibble decoding of
the scores and of PV with its channel map, and the same bits whichever
order the clusters run in, with copies landing late or at once and warps
in step or one running ahead. The harness forces the split S; the Python
wrappers take none. Inputs are int4 K and V from a numpy seed and q at
16 x the int8 checks' scale (0.05), as chip_smoke.py draws it, so that the
scores spread as they do at int8 and a wrongly decoded nibble moves the
softmax; the tolerance is K4's, 1e-3 of each batch row's own max|ref|, for
every query of a window. One more case decodes all 256 byte values through
the codec against unpack_int4. Skips where no g++ is installed.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from whisperlive_tpu_torch.ops import attention as tattn

from test_torch_cross_int8_emulated import build_emulated, split_choice

Q_SCALE = 0.05 * 16


@pytest.fixture(scope="module")
def cross_binary(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    return build_emulated(gxx, tmp_path_factory.mktemp("cross_int4_emu"),
                          "cross_int4_harness.cpp")


def make_inputs(seed, q_shape, t, lengths):
    """q at Q_SCALE and int4 K and V (random bytes: every nibble pair) from
    a numpy seed; lengths None is the entry without lengths (masks 0)."""
    rng = np.random.default_rng(seed)
    b, h = q_shape[:2]
    q = torch.from_numpy(rng.standard_normal(q_shape).astype(np.float32) * Q_SCALE).to(
        torch.bfloat16)
    k4, v4 = (torch.from_numpy(rng.integers(-128, 128, (b, h, t, 32)).astype(np.int8))
              for _ in range(2))
    ln = torch.tensor(lengths or [t] * b, dtype=torch.int32)
    return q, k4, v4, ln, 0 if lengths is None else 1


def run_source(binary, tmp_path, q, k4, v4, ln, masks, s, eager, schedule):
    """The source's launch at split s (twice, across schedules: the bits
    must agree) -> the f32 output, shaped as q."""
    b, h, t = k4.shape[:3]
    tq = 1 if q.dim() == 3 else q.shape[2]
    (tmp_path / "in.bin").write_bytes(q.view(torch.int16).numpy().tobytes()
                                      + k4.numpy().tobytes() + v4.numpy().tobytes()
                                      + ln.numpy().tobytes())
    run = subprocess.run(
        [str(binary), *map(str, (b, h, t, tq, s, masks, int(eager), schedule)),
         str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
        capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == f"rc=0 splits={s} identical=1", run.stdout
    out = torch.frombuffer(bytearray((tmp_path / "out.bin").read_bytes()), dtype=torch.float32)
    return out.reshape(q.shape)


# (S, B, H, T, Tq, lengths, copies land at once, schedule). lengths None is
# the entry without lengths. Tq covers 1 (K7), 2, 5 (the verify window at k
# = 4) and 8 (the most); S 1, 2, 4 and 8 at each of Tq 1, 5 and 8; lengths
# 0 (a uniform softmax over all T for every query), 1 (ranks with empty
# chunks), T, above T and on and one past the chunk boundaries. T covers
# one position, one score pass (64) and one row past it (65), the
# continuous pool's cap (640), the encoder context (1500: K7's window-path
# shape at S = 4 and K8's at S = 8) and, at Tq = 8 and S = 1, the 1536-row
# chunk that fills a CTA at int4. Schedule 0 keeps the warps in step, 1
# runs the first ahead, 2 the last; the harness reruns each case with the
# other copy timing, the next schedule and the clusters in reverse, and the
# bits must not change.
CASES = [
    (1, 2, 2, 1, 1, None, False, 0),
    (8, 2, 1, 1, 1, [0, 1], True, 1),
    (2, 2, 2, 64, 1, [64, 0], False, 2),
    (4, 2, 1, 65, 1, [1, 66], True, 0),
    (8, 4, 1, 640, 1, [160, 161, 0, 700], False, 1),
    (4, 1, 2, 1500, 1, None, True, 2),
    (1, 1, 1, 1500, 1, [1501], False, 0),
    (1, 2, 1, 64, 2, None, False, 1),
    (4, 2, 2, 65, 2, [3, 4], True, 2),
    (2, 4, 1, 640, 2, [320, 321, 1, 0], False, 0),
    (1, 2, 1, 65, 5, [65, 2], True, 2),
    (2, 2, 2, 65, 5, [0, 65], True, 1),
    (4, 4, 1, 640, 5, [160, 161, 640, 700], False, 0),
    (8, 4, 1, 640, 5, [160, 161, 0, 1], False, 2),
    (8, 1, 2, 1500, 5, [1500], False, 1),
    (4, 2, 1, 65, 8, [1, 66], False, 2),
    (2, 4, 1, 640, 8, [320, 321, 640, 0], True, 0),
    (8, 1, 1, 1500, 8, None, True, 1),
    (1, 1, 1, 1536, 8, [1536], False, 2),
]


@pytest.mark.parametrize("s, b, h, t, tq, lengths, eager, schedule", CASES)
def test_cross_attention_int4_source_emulated(cross_binary, tmp_path, s, b, h, t, tq, lengths,
                                              eager, schedule):
    q_shape = (b, h, 64) if tq == 1 else (b, h, tq, 64)
    q, k4, v4, ln, masks = make_inputs(100 * tq + 10 * s + t, q_shape, t, lengths)
    out = run_source(cross_binary, tmp_path, q, k4, v4, ln, masks, s, eager, schedule)
    lens = None if masks == 0 else ln
    if tq == 1:
        ref = tattn.cross_attention_int4_ref(q, k4, v4, lens)
    else:
        ref = tattn.cross_attention_int4_window_ref(q, k4, v4, lens)
    assert torch.isfinite(out).all()
    err = (out - ref).abs().flatten(1).amax(1)
    tol = 1e-3 * ref.abs().flatten(1).amax(1)
    assert bool((err <= tol).all()), (err, tol)


# (B, H, T, Tq, S): the launcher's split at the int4 serving shapes (K7 at
# the window path's 4 requests of 20 heads over 1500 positions and the
# continuous pool's 8 slots at its 640 cap, K8 at the pool's verify), T =
# 8192 at Tq = 8 (1024 rows a CTA), and where the 1536 rows a CTA holds at
# int4 at every Tq leave a window of 8 unsplit that int8 (1024) splits.
SPLITS = [(4, 20, 1500, 1, 4), (8, 20, 640, 1, 2), (8, 20, 640, 5, 2), (1, 20, 1500, 8, 8),
          (16, 20, 8192, 8, 8), (264, 1, 1500, 8, 1), (1, 1, 65, 1, 1)]


@pytest.mark.parametrize("b, h, t, tq, s", SPLITS)
def test_cross_attention_int4_split_choice(cross_binary, b, h, t, tq, s):
    assert split_choice(cross_binary, b, h, t, tq) == s


def test_int4_codec_decodes_every_byte(cross_binary, tmp_path):
    """Every byte value 0..255 as K and as V, through the codec's shared
    memory layout, decoding and channel maps, against unpack_int4."""
    rng = np.random.default_rng(0)
    k4 = torch.from_numpy(np.arange(256, dtype=np.uint8).view(np.int8).reshape(8, 32))
    v4 = torch.from_numpy(rng.permutation(256).astype(np.uint8).view(np.int8).reshape(8, 32))
    (tmp_path / "in.bin").write_bytes(k4.numpy().tobytes() + v4.numpy().tobytes())
    subprocess.run([str(cross_binary), "decode", str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True, capture_output=True, timeout=60)
    out = torch.frombuffer(bytearray((tmp_path / "out.bin").read_bytes()), dtype=torch.float32)
    k, v = out.reshape(2, 8, 64)
    assert torch.equal(k, tattn.unpack_int4(k4).float())
    assert torch.equal(v, tattn.unpack_int4(v4).float())
