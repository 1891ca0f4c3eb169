"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; every test skips when torch.cuda.is_available() is False.
This file imports no JAX, so it also runs on a machine without it, where
tests/conftest.py (which imports jax) must be left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Inputs are bf16 (int8 weights and K|V) made with numpy. Tolerances against
max|ref|: K1 2^-6 (flash normalises after the bf16 PV product, the plain
version before it), K2 2^-7 (bf16 output, f32 sums in another order), K3
1e-5 (f32 output), K4 1e-3 (a probability may round to the other bf16
neighbour), K5 2^-6 on the active rows (K4's arithmetic; the loop stops
at each row's length, so sums run in another order), K6, K5's window
form (K4's source over a window of queries), K7 and K8 2^-6 (the same
arithmetic over int4 nibbles). The cross-attention kernels (K4-K8) are held per batch row,
against that row's own max|ref|: a length-1 row copies one V row and would
otherwise set the tolerance of rows that average many. q is drawn at
scale 0.05 against random int8 codes and 16x larger against int4 nibbles
(whose std is 1/16 of theirs), so the scores spread alike.
"""

import time

import numpy as np
import pytest
import torch

from whisperlive_tpu_torch.ops import _kernels
from whisperlive_tpu_torch.ops import attention as tattn
from whisperlive_tpu_torch.ops import quant_matmul as tqmm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _gpu(rng, shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) * scale).to(
        "cuda", dtype)


Q_SCALE_INT8, Q_SCALE_INT4 = 0.05, 0.05 * 16


def _err(out, ref):
    return (out.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()


def _rows_close(out, ref, rel_tol):
    """Every batch row's max abs error within rel_tol of its own max|ref|."""
    err = (out.float() - ref.float()).abs().flatten(1).amax(1)
    scale = ref.float().abs().flatten(1).amax(1)
    return bool((err <= rel_tol * scale).all())


# K1 cases: (B, T, q scale, strided). T covers a single key, the ragged
# key tile (64 keys a tile: 28, 63, 65, 127, 129, 1500 = 23*64 + 28) and the
# ragged query tile (128 queries a CTA: 127, 129, 512 full, 1500); q drawn
# 4x larger peaks the softmax, so a wrong rescale of the running max shows;
# strided q/k/v are the head slices of one [B, T, 3H, 64] tensor. Heads:
# large-v3's 20, and the other published widths' 6, 8, 12 and 16 (tiny,
# base, small, medium; every width has 64-channel heads) at T = 1500 and
# the ragged 129.
K1_CASES = [
    *[(2, t, 1.0, False) for t in (1, 28, 63, 64, 65, 127, 128, 129, 512, 1500)],
    (1, 1500, 1.0, False), (8, 512, 1.0, False), (8, 129, 1.0, False),
    (4, 1500, 4.0, False), (1, 65, 4.0, False),
    (2, 129, 1.0, True), (8, 512, 1.0, True), (2, 1500, 4.0, True),
]
WIDTH_HEADS = (6, 8, 12, 16)
K1_CASES = [(*case, 20) for case in K1_CASES] + [
    (b, t, 1.0, False, h) for h in WIDTH_HEADS for b, t in ((4, 1500), (2, 129))]


@pytest.mark.cuda
@pytest.mark.parametrize("b, t, q_scale, strided, h", K1_CASES)
def test_fused_attention_kernel_on_card(cuda_device, b, t, q_scale, strided, h):
    rng = np.random.default_rng(t * 16 + b + h)
    if strided:
        qkv = _gpu(rng, (b, t, 3 * h, 64))
        qkv[:, :, :h] *= q_scale
        q, k, v = qkv[:, :, :h], qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]
    else:
        q = _gpu(rng, (b, t, h, 64), q_scale)
        k, v = (_gpu(rng, (b, t, h, 64)) for _ in range(2))
    n = _kernels.launches["fused_attention"]
    err, scale = _err(tattn.fused_attention(q, k, v), tattn.fused_attention_ref(q, k, v))
    assert _kernels.launches["fused_attention"] == n + 1
    assert err <= 2.0**-6 * scale


@pytest.mark.cuda
def test_fused_attention_raises_for_inputs_that_require_grad(cuda_device):
    """K1 has no backward pass: under grad mode, with inputs that require
    grad, the wrapper raises and launches nothing (a result written through
    raw pointers would carry no grad_fn); under torch.no_grad it launches."""
    rng = np.random.default_rng(5)
    q, k, v = (_gpu(rng, (1, 64, 20, 64)).requires_grad_(True) for _ in range(3))
    n = _kernels.launches["fused_attention"]
    with pytest.raises(RuntimeError, match="no backward pass"):
        tattn.fused_attention(q, k, v)
    assert _kernels.launches["fused_attention"] == n
    with torch.no_grad():
        out = tattn.fused_attention(q, k, v)
    assert _kernels.launches["fused_attention"] == n + 1 and not out.requires_grad


def _k2_inputs(m, k, n):
    rng = np.random.default_rng(m * 7 + k + n)
    x = _gpu(rng, (m, k))
    w8 = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).cuda()
    return x, w8, _gpu(rng, (n,), 0.01).abs()


# K2 at large-v3's three decode shapes (the d x d linears, fc1 d x 4d, fc2
# 4d x d) and M over the decode batches (1, 4, 8, 16), the verify window
# (40), prefill (64, 300, 512) and the ragged n8 and 64-row tiles (7, 9,
# 17, 65). Below 264 CTAs K is split across the CTAs of a cluster. Then
# the other published widths' decode shapes (d = 384, 512, 768, 1024: 6,
# 8, 12 and 16 chunks of 64 split over a cluster) at the decode batches 1
# and 8 and the verify window's 40.
K2_SHAPES = [(1280, 1280), (1280, 5120), (5120, 1280)]
K2_ROWS = [1, 4, 7, 8, 9, 16, 17, 40, 64, 65, 300, 512]
WIDTHS = (384, 512, 768, 1024)
K2_CASES = [(m, k, n) for m in K2_ROWS for k, n in K2_SHAPES] + [
    (m, k, n) for d in WIDTHS for k, n in ((d, d), (d, 4 * d), (4 * d, d)) for m in (1, 8, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n", K2_CASES)
def test_int8_matmul_kernel_on_card(cuda_device, m, k, n):
    x, w8, s = _k2_inputs(m, k, n)
    launched = _kernels.launches["int8_matmul"]
    err, scale = _err(tqmm.int8_matmul(x, w8, s), tqmm.int8_matmul_ref(x, w8, s))
    assert _kernels.launches["int8_matmul"] == launched + 1
    assert err <= 2.0**-7 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("k, n", K2_SHAPES)
@pytest.mark.parametrize("m", [1, 8, 40])
def test_int8_matmul_kernel_same_bits_twice(cuda_device, m, k, n):
    """The split over K sums its slices in a fixed order: two calls agree
    bit for bit."""
    x, w8, s = _k2_inputs(m, k, n)
    first = tqmm.int8_matmul(x, w8, s)
    assert torch.equal(first.view(torch.int16), tqmm.int8_matmul(x, w8, s).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("k, n", [(1280 + 32, 1280), (1280, 1280 + 16), (32, 64)])
def test_int8_matmul_kernel_refuses_untiled_shapes(cuda_device, k, n):
    x, w8, s = _k2_inputs(8, k, n)
    with pytest.raises(ValueError, match="multiples of 64"):
        tqmm.int8_matmul(x, w8, s)


def _k3_inputs(m, n, k=1280):
    rng = np.random.default_rng(m * 7 + n)
    x = _gpu(rng, (m, k))
    w8 = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8)).cuda()
    return x, w8, _gpu(rng, (n,), 0.01).abs()


# K3 over M on the paths (decode B 1, 4, 8, 16; the verify window 40 in the
# 8-slot pool, one full 40-row launch), the ragged n8 tiles (7, 9, 17) and
# two launches (64 = 40 + 24, 65 = 40 + 25), at each vocab: 51866 (large-v3; even rows of out
# 16-byte aligned, odd rows 8-byte), 51865 (odd rows only 4-byte aligned)
# and 51864 (every row 16-byte aligned), at K = 1280; then K = 384, 512,
# 768 and 1024 (the other published widths: 12-32 k16 pairs over the 8
# summing warps) at their vocabularies (tiny.en's 51864 at 384). 1e-5 of
# max|ref|: f32 output over exact products.
K3_ROWS = [1, 4, 7, 8, 9, 16, 17, 40, 64, 65]
K3_VOCABS = [51866, 51865, 51864]
K3_CASES = [(m, n, 1280) for m in K3_ROWS for n in K3_VOCABS] + [
    (m, 51864 if d == 384 else 51865, d) for d in WIDTHS for m in (1, 8, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("m, n, k", K3_CASES)
def test_int8_matmul_t_kernel_on_card(cuda_device, m, n, k):
    x, w8, s = _k3_inputs(m, n, k)
    launched = _kernels.launches["int8_matmul_t"]
    err, scale = _err(tqmm.int8_matmul_t(x, w8, s), tqmm.int8_matmul_t_ref(x, w8, s))
    assert _kernels.launches["int8_matmul_t"] == launched + 1
    assert err <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 40, 65])
def test_int8_matmul_t_kernel_same_bits_twice(cuda_device, m):
    """Every output is one thread's sum in a fixed order: two calls agree
    bit for bit."""
    x, w8, s = _k3_inputs(m, 51866)
    first = tqmm.int8_matmul_t(x, w8, s)
    assert torch.equal(first.view(torch.int32), tqmm.int8_matmul_t(x, w8, s).view(torch.int32))


@pytest.mark.cuda
def test_int8_matmul_t_kernel_refuses_untiled_shapes(cuda_device):
    x, w8, s = _k3_inputs(8, 51866, k=1280 + 16)
    with pytest.raises(ValueError, match="multiple of 64"):
        tqmm.int8_matmul_t(x, w8, s)


# K4 at the window path's batch buckets over the encoder context and the
# reduced 512-position one (a split over T of 8, 8, 4 CTAs at T = 1500; 8,
# 8, 4 at T = 512), unmasked and with lengths [T, 700, 1, 0] repeated and
# cut to B; and at B = 16, whose 320 (b, h) rows take no split (one CTA a
# row holding all 1500 positions, ~200 KB of shared memory). At 20 heads
# (large-v3), then at tiny's 6 and small's 12 (fewer (b, h) rows: wider
# splits over T) at the window batches 1 and 4 over 1500 positions.
K4_CASES = [(b, t, masked) for b in (1, 2, 4) for t in (1500, 512) for masked in (False, True)]
K4_CASES += [(16, 1500, False), (16, 1500, True)]
K4_CASES = [(*case, 20) for case in K4_CASES] + [
    (b, 1500, masked, h) for h in (6, 12) for b in (1, 4) for masked in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("b, t, masked, h", K4_CASES)
def test_cross_attention_int8_kernel_on_card(cuda_device, b, t, masked, h):
    rng = np.random.default_rng(1)
    q = _gpu(rng, (b, h, 64), Q_SCALE_INT8)
    kvp = torch.from_numpy(rng.integers(-127, 128, (b, h, t, 128)).astype(np.int8)).cuda()
    ln = (torch.tensor(([t, 700, 1, 0] * 4)[:b], dtype=torch.int32, device="cuda") if masked
          else None)
    assert _rows_close(tattn.cross_attention_int8(q, kvp, ln),
                       tattn.cross_attention_int8_ref(q, kvp, ln), 1e-3)


def _k5_inputs(rng, b=8, t=640, h=20):
    q = _gpu(rng, (b, h, 64), Q_SCALE_INT8)
    kvp = torch.from_numpy(rng.integers(-127, 128, (b, h, t, 128)).astype(np.int8)).cuda()
    return q, kvp


@pytest.mark.cuda
@pytest.mark.parametrize("h", [20, 6, 12])
@pytest.mark.parametrize("case", ["mixed_lengths", "half_active", "len0_active",
                                  "chunk_boundaries", "chunk_boundaries_len0"])
def test_cross_attention_int8_skip_kernel_on_card(cuda_device, case, h):
    """K5 on the active rows. At 8 slots of 20 heads over 640 positions the
    split over T is 2 CTAs a row, each chunk ceil(n / 2) rows of n =
    min(len, T): the boundary cases take lengths that split evenly, one
    past (a short last chunk), n < 2 (an empty rank) and 0 (a uniform
    softmax over all T) next to each other. At 6 and 12 heads (tiny's and
    small's pools) the rows are fewer and the split wider."""
    rng = np.random.default_rng(3)
    q, kvp = _k5_inputs(rng, h=h)
    lengths = [640, 300, 1, 640, 512, 17, 640, 100]
    active = [True] * 8
    if case == "half_active":
        active = [i % 2 == 0 for i in range(8)]
    elif case == "len0_active":
        lengths[3] = 0
    elif case.startswith("chunk_boundaries"):
        lengths = [320, 321, 160, 161, 2, 3, 1, 639]
        if case.endswith("len0"):
            lengths[2], active[5] = 0, False
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    act = torch.tensor(active, device="cuda")
    n = _kernels.launches["cross_attention_int8_skip"]
    out = tattn.cross_attention_int8_skip(q, kvp, ln, act)
    ref = tattn.cross_attention_int8_skip_ref(q, kvp, ln, act)
    assert _kernels.launches["cross_attention_int8_skip"] == n + 1
    assert _rows_close(out[act], ref[act], 2.0**-6)
    assert torch.isfinite(out).all()
    assert not out[~act].any()


@pytest.mark.cuda
def test_cross_attention_int8_skip_all_inactive_writes_zeros(cuda_device):
    """Every row inactive: no K/V is read and every output row is zero (the
    port's contract; the TPU kernel left such rows unwritten)."""
    rng = np.random.default_rng(4)
    q, kvp = _k5_inputs(rng)
    ln = torch.full((8,), 640, dtype=torch.int32, device="cuda")
    act = torch.zeros(8, dtype=torch.bool, device="cuda")
    out = tattn.cross_attention_int8_skip(q, kvp, ln, act)
    torch.cuda.synchronize()
    assert out.shape == (8, 20, 64) and out.dtype == torch.float32
    assert not out.any()


@pytest.mark.cuda
@pytest.mark.parametrize("b, t", [(1, 1500), (4, 1500), (8, 640)])
def test_cross_attention_int8_kernels_same_bits_twice(cuda_device, b, t):
    """K4 and K5 sum the cluster's partials in rank order, without atomics:
    two calls on the same inputs give the same bits."""
    rng = np.random.default_rng(5)
    q, kvp = _k5_inputs(rng, b, t)
    ln = torch.tensor([t, 700, 1, 0, 320, 321, 2, 640][:b], dtype=torch.int32, device="cuda")
    act = torch.tensor([True, False, True, True, True, False, True, True][:b], device="cuda")
    for call in (lambda: tattn.cross_attention_int8(q, kvp),
                 lambda: tattn.cross_attention_int8(q, kvp, ln),
                 lambda: tattn.cross_attention_int8_skip(q, kvp, ln, act)):
        assert torch.equal(call(), call())


# ---------------------------------------------------------------------------
# K6, K5's window form, K7 and K8. Tolerances as K4's family on the card:
# 2^-6 of max|ref| (K4's bf16 probability rounding, sums in another order).
# K6 and K5's window form are K4's source at Tq > 1 (split over T across a
# cluster); K7 and K8 keep one shared-memory score row per query.
# ---------------------------------------------------------------------------


def _int8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("tq", range(1, 9))
@pytest.mark.parametrize("lengths", [None, [1500]], ids=["unmasked", "lengths"])
def test_cross_attention_int8_window_kernel_on_card(cuda_device, tq, lengths):
    """K6 at the window route's shape: one request over the full 1500-position
    context (a split over T of 8 CTAs of 188 rows), at every Tq."""
    rng = np.random.default_rng(tq)
    q, kvp = _gpu(rng, (1, 20, tq, 64), Q_SCALE_INT8), _int8(rng, (1, 20, 1500, 128))
    ln = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    n = _kernels.launches["cross_attention_int8_window"]
    out = tattn.cross_attention_int8_window(q, kvp, ln)
    assert _kernels.launches["cross_attention_int8_window"] == n + 1
    assert _rows_close(out, tattn.cross_attention_int8_window_ref(q, kvp, ln), 2.0**-6)


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [2, 8])
def test_cross_attention_int8_window_kernel_at_8192_positions(cuda_device, tq):
    """K6 at the wrappers' largest T: 8 CTAs a row of 1024 rows each, the
    most a CTA holds at Tq = 8 (beside its 8 score rows), with lengths
    past the chunk boundaries and 0."""
    rng = np.random.default_rng(20 + tq)
    q, kvp = _gpu(rng, (2, 4, tq, 64), Q_SCALE_INT8), _int8(rng, (2, 4, 8192, 128))
    for ln in (None, torch.tensor([8192 - 1023, 0], dtype=torch.int32, device="cuda")):
        assert _rows_close(tattn.cross_attention_int8_window(q, kvp, ln),
                           tattn.cross_attention_int8_window_ref(q, kvp, ln), 2.0**-6)


@pytest.mark.cuda
@pytest.mark.parametrize("tq", range(2, 9))
def test_cross_attention_int8_skip_window_kernel_at_every_tq(cuda_device, tq):
    """K5's window form at the 8-slot pool's shape (2 CTAs a row of 320
    rows), mixed lengths with a 0 and half the rows active, at every Tq."""
    rng = np.random.default_rng(30 + tq)
    q, kvp = _gpu(rng, (8, 20, tq, 64), Q_SCALE_INT8), _int8(rng, (8, 20, 640, 128))
    ln = torch.tensor([640, 300, 1, 0, 512, 17, 321, 100], dtype=torch.int32, device="cuda")
    act = torch.tensor([i % 2 == 0 or i == 3 for i in range(8)], device="cuda")
    n = _kernels.launches["cross_attention_int8_skip_window"]
    out = tattn.cross_attention_int8_window(q, kvp, ln, act)
    ref = tattn.cross_attention_int8_skip_window_ref(q, kvp, ln, act)
    assert _kernels.launches["cross_attention_int8_skip_window"] == n + 1
    assert torch.isfinite(out).all() and not out[~act].any()
    assert _rows_close(out[act], ref[act], 2.0**-6)


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [2, 5, 8])
def test_cross_attention_int8_window_kernels_same_bits_twice(cuda_device, tq):
    """K6 and K5's window form sum the cluster's partials in rank order,
    without atomics: two calls on the same inputs give the same bits."""
    rng = np.random.default_rng(40 + tq)
    q1, kv1 = _gpu(rng, (1, 20, tq, 64), Q_SCALE_INT8), _int8(rng, (1, 20, 1500, 128))
    q8, kv8 = _gpu(rng, (8, 20, tq, 64), Q_SCALE_INT8), _int8(rng, (8, 20, 640, 128))
    ln = torch.tensor([640, 300, 1, 0, 320, 321, 2, 640], dtype=torch.int32, device="cuda")
    act = torch.tensor([True, False, True, True, True, False, True, True], device="cuda")
    for call in (lambda: tattn.cross_attention_int8_window(q1, kv1),
                 lambda: tattn.cross_attention_int8_window(q1, kv1, ln[:1]),
                 lambda: tattn.cross_attention_int8_window(q8, kv8, ln, act)):
        assert torch.equal(call(), call())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed_lengths", "half_active", "len0_active", "none_active"])
def test_cross_attention_int8_skip_window_kernel_on_card(cuda_device, case):
    rng = np.random.default_rng(6)
    q, kvp = _gpu(rng, (8, 20, 5, 64), Q_SCALE_INT8), _int8(rng, (8, 20, 640, 128))
    lengths = [640, 300, 1, 640, 512, 17, 640, 100]
    active = [True] * 8
    if case == "half_active":
        active = [i % 2 == 0 for i in range(8)]
    elif case == "len0_active":
        lengths[3] = 0
    elif case == "none_active":
        active = [False] * 8
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    act = torch.tensor(active, device="cuda")
    n = _kernels.launches["cross_attention_int8_skip_window"]
    out = tattn.cross_attention_int8_window(q, kvp, ln, act)
    ref = tattn.cross_attention_int8_skip_window_ref(q, kvp, ln, act)
    assert _kernels.launches["cross_attention_int8_skip_window"] == n + 1
    assert torch.isfinite(out).all() and not out[~act].any()
    if act.any():
        assert _rows_close(out[act], ref[act], 2.0**-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1500), (8, 640)])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_attention_int4_kernel_on_card(cuda_device, shape, masked):
    b, t = shape
    rng = np.random.default_rng(b)
    q = _gpu(rng, (b, 20, 64), Q_SCALE_INT4)
    k4, v4 = _int8(rng, (b, 20, t, 32)), _int8(rng, (b, 20, t, 32))
    ln = (torch.tensor(([t, 700, 1, 0] * 2)[:b], dtype=torch.int32, device="cuda")
          if masked else None)
    n = _kernels.launches["cross_attention_int4"]
    out = tattn.cross_attention_int4(q, k4, v4, ln)
    assert _kernels.launches["cross_attention_int4"] == n + 1
    assert _rows_close(out, tattn.cross_attention_int4_ref(q, k4, v4, ln), 2.0**-6)


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [2, 5, 8])
def test_cross_attention_int4_window_kernel_on_card(cuda_device, tq):
    rng = np.random.default_rng(10 + tq)
    q = _gpu(rng, (8, 20, tq, 64), Q_SCALE_INT4)
    k4, v4 = _int8(rng, (8, 20, 640, 32)), _int8(rng, (8, 20, 640, 32))
    ln = torch.tensor([640, 300, 1, 640, 512, 0, 640, 100], dtype=torch.int32, device="cuda")
    for lengths in (None, ln):
        assert _rows_close(tattn.cross_attention_int4_window(q, k4, v4, lengths),
                           tattn.cross_attention_int4_window_ref(q, k4, v4, lengths), 2.0**-6)


def _int4_call(q, k4, v4, ln):
    """K7 for a [B, H, 64] q, else K8; -> (output, plain version, kernel name)."""
    if q.dim() == 3:
        return (tattn.cross_attention_int4(q, k4, v4, ln),
                tattn.cross_attention_int4_ref(q, k4, v4, ln), "cross_attention_int4")
    return (tattn.cross_attention_int4_window(q, k4, v4, ln),
            tattn.cross_attention_int4_window_ref(q, k4, v4, ln), "cross_attention_int4_window")


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [1, 5, 8])
def test_cross_attention_int4_kernels_at_8192_positions(cuda_device, tq):
    """K7 and K8 at the wrappers' largest T: 8 CTAs a row of 1024 rows
    each, at every Tq (a CTA holds 1536 int4 rows beside 8 score rows),
    unmasked and with lengths past the chunk boundaries and 0; each call
    is one launch of its kernel."""
    rng = np.random.default_rng(50 + tq)
    q = _gpu(rng, (2, 4, 64) if tq == 1 else (2, 4, tq, 64), Q_SCALE_INT4)
    k4, v4 = _int8(rng, (2, 4, 8192, 32)), _int8(rng, (2, 4, 8192, 32))
    for ln in (None, torch.tensor([8192 - 1023, 0], dtype=torch.int32, device="cuda")):
        before = dict(_kernels.launches)
        out, ref, name = _int4_call(q, k4, v4, ln)
        assert {k: n - before[k] for k, n in _kernels.launches.items() if n != before[k]} == {
            name: 1}
        assert _rows_close(out, ref, 2.0**-6)


@pytest.mark.cuda
@pytest.mark.parametrize("tq", [1, 5, 8])
def test_cross_attention_int4_kernels_same_bits_twice(cuda_device, tq):
    """K7 and K8 sum the cluster's partials in rank order, without atomics:
    two calls on the same inputs give the same bits, at the window path's
    [4,20,1500] (4 CTAs a row) and the pool's [8,20,640] (2 a row)."""
    rng = np.random.default_rng(60 + tq)
    for b, t, lengths in ((4, 1500, [1500, 700, 1, 0]), (8, 640, [640, 300, 1, 0, 320, 321, 2,
                                                                  640])):
        q = _gpu(rng, (b, 20, 64) if tq == 1 else (b, 20, tq, 64), Q_SCALE_INT4)
        k4, v4 = _int8(rng, (b, 20, t, 32)), _int8(rng, (b, 20, t, 32))
        for ln in (None, torch.tensor(lengths, dtype=torch.int32, device="cuda")):
            assert torch.equal(_int4_call(q, k4, v4, ln)[0], _int4_call(q, k4, v4, ln)[0])


@pytest.mark.cuda
def test_cuda_tensors_never_reach_the_plain_versions(cuda_device, monkeypatch):
    """Each new wrapper launches its kernel for CUDA tensors: its plain
    version, made to raise here, is never called."""
    for name in ("cross_attention_int8_window_ref", "cross_attention_int8_skip_window_ref",
                 "cross_attention_int4_ref", "cross_attention_int4_window_ref",
                 "window_attention_ref"):
        monkeypatch.setattr(tattn, name, lambda *a, _n=name: pytest.fail(f"{_n} was called"))
    rng = np.random.default_rng(0)
    q, qw = _gpu(rng, (2, 4, 64)), _gpu(rng, (2, 4, 3, 64))
    kvp, k4, v4 = _int8(rng, (2, 4, 96, 128)), _int8(rng, (2, 4, 96, 32)), _int8(rng, (2, 4, 96, 32))
    ln = torch.tensor([96, 40], dtype=torch.int32, device="cuda")
    act = torch.tensor([True, False], device="cuda")
    before = dict(_kernels.launches)
    tattn.cross_attention_int8_window(qw, kvp, ln)
    tattn.cross_attention_int8_window(qw, kvp, ln, act)
    tattn.cross_attention_int4(q, k4, v4, ln)
    tattn.cross_attention_int4_window(qw, k4, v4)
    torch.cuda.synchronize()
    for name in ("cross_attention_int8_window", "cross_attention_int8_skip_window",
                 "cross_attention_int4", "cross_attention_int4_window"):
        assert _kernels.launches[name] == before[name] + 1, name


@pytest.mark.cuda
def test_device_timer_times_device_bound_work_as_synchronize_brackets(cuda_device):
    """The device timer's event pair around work the card paces (bf16 GEMMs
    of 8192^3, some 15 ms in all against a dispatch of microseconds) agrees
    within 15% with the same work timed between two synchronize calls."""
    from whisperlive_tpu_torch.utils import profiling

    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)

    def work():
        for _ in range(10):
            a @ a

    timer = profiling.DeviceTimer("cuda")
    timed, bracketed = [], []
    for _ in range(7):
        with profiling.span("probe", device_s=None) as s, timer.time(s):
            work()
        torch.cuda.synchronize()
        timer.settle()
        timed.append(s.attrs["device_s"])
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        bracketed.append(time.perf_counter() - t0)
    assert np.median(timed[1:]) == pytest.approx(np.median(bracketed[1:]), rel=0.15)


def _kernel_seconds(call) -> float:
    """Seconds of the kernels, copies and sets torch.profiler records on the
    card for one call (the program's spans, drawn on the card's timeline
    too, left out)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA

    def annotation(e):
        kind = getattr(e, "activity_type", None)
        return (e.is_user_annotation() or e.name().startswith("engine.")
                or (kind is not None and "annotation" in str(kind())))

    return sum(e.duration_ns() if hasattr(e, "duration_ns") else 1e3 * e.duration_us()
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and not annotation(e)) / 1e9


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4, 16])
def test_a_timed_prepare_agrees_with_the_profiler(cuda_device, rows):
    """large-v3 at full width and depth on random bf16 weights (int8 cross-KV,
    as the benchmark serves it): the event pair of a prepare of 4 and of 16
    windows (engine.prepare's device_s; the encoder and cross-KV, which the
    card paces) within 15% of the kernel and copy seconds torch.profiler
    records on the card for the same call (the log-mel before the pair
    included), from both sides."""
    from whisperlive_tpu_torch.engine.engine import WhisperEngine
    from whisperlive_tpu_torch.models import whisper as tw
    from whisperlive_tpu_torch.ops import mel as mel_ops
    from whisperlive_tpu_torch.utils import profiling

    cfg = tw.WHISPER_CONFIGS["large-v3"]
    eng = WhisperEngine(cfg, tw.init_params(cfg, 0, torch.bfloat16, "cuda"), device="cuda",
                        batch_buckets=(rows,), decoder_int8=True, cross_kv_bits=8)
    audio = (np.random.default_rng(0).standard_normal((rows, mel_ops.N_SAMPLES))
             * 0.1).astype(np.float32)
    eng.prepare(audio)  # warm
    paired = []
    for _ in range(5):
        eng.prepare(audio)
        torch.cuda.synchronize()
        eng.device_timer.settle()
        (s,) = profiling.LOG.spans("engine.prepare")[-1:]
        paired.append(s.attrs["device_s"])
    kernels = [_kernel_seconds(lambda: eng.prepare(audio)) for _ in range(3)]
    got = (float(np.median(paired)), float(np.median(kernels)))
    print(f"prepare of {rows} rows, event pair against the profiler's kernels (s):", got)
    assert got[0] == pytest.approx(got[1], rel=0.15), got


# ---------------------------------------------------------------------------
# The continuous pool's decode step replayed from its CUDA graph
# ---------------------------------------------------------------------------

POOL = dict(n_slots=4, prompt_pad=32, ring=32, steps_per_chunk=4)


def _tiny_engine():
    """tiny's widths on random bf16 weights, int8 decoder and cross-KV (K2,
    K3 and K5 on the step), as the card serves it."""
    from whisperlive_tpu_torch.engine.engine import WhisperEngine
    from whisperlive_tpu_torch.models import whisper as tw

    cfg = tw.WHISPER_CONFIGS["tiny"]
    return WhisperEngine(cfg, tw.init_params(cfg, 0, torch.bfloat16, "cuda"), device="cuda",
                         decoder_int8=True, cross_kv_bits=8)


def _pool_history(cb) -> dict:
    """A warm chunk, an init_state, two windows stepped three chunks, a third
    window inserted mid-flight, two more chunks. Per chunk after the warm
    one: logits, sampled and self_kv, the launches it counted, and whether
    it was replayed."""
    from whisperlive_tpu_torch.engine.engine import TranscribeOptions

    prompt, sot = cb.eng.build_prompt(TranscribeOptions(), language="en")
    rng = np.random.default_rng(5)

    def insert(slots):
        audio = (rng.standard_normal((len(slots), 16000 * 3)) * 0.1).astype(np.float32)
        n = len(slots)
        cb.insert(audio, [prompt] * n, [sot] * n, [True] * n, slots, [0.0] * n, [True] * n,
                  [1.0] * n, [24] * n, enc_ctx=512)

    out = {"state": [], "launches": [], "replayed": []}

    def chunk():
        before = dict(_kernels.launches)
        cb.step()
        out["launches"].append({k: n - before[k] for k, n in _kernels.launches.items()})
        out["replayed"].append(cb.last_graph)
        out["state"].append({k: cb.state[k].clone() for k in ("logits", "sampled", "self_kv")})

    cb.init_state()
    insert([0])
    cb.step()  # warm: a graph pool runs it eagerly, then captures
    cb.init_state()
    insert([0, 1])
    for _ in range(3):
        chunk()
    insert([3])
    for _ in range(2):
        chunk()
    out["stats"] = dict(cb.graph_stats)
    return out


def _graph_and_eager_histories():
    from whisperlive_tpu_torch.engine.continuous import ContinuousEngine

    eng = _tiny_engine()
    graph = ContinuousEngine(eng, **POOL)
    eager = ContinuousEngine(eng, **POOL)
    eager.graphable = lambda sampling, penalty: False
    return _pool_history(graph), _pool_history(eager)


@pytest.mark.cuda
def test_replayed_pool_chunks_equal_eager_chunks_bit_for_bit(cuda_device):
    """Five chunks replayed from the captured step, after an init_state and
    with an insert between them, leave the logits, the sampled ring and the
    self-KV bit-equal to the same chunks run eagerly."""
    g, e = _graph_and_eager_histories()
    assert g["replayed"] == [True] * 5 and e["replayed"] == [False] * 5
    spc = POOL["steps_per_chunk"]
    assert g["stats"] == {"graph_steps": 5 * spc, "eager_steps": spc, "graph_captures": 1}
    assert e["stats"] == {"graph_steps": 0, "eager_steps": 6 * spc, "graph_captures": 0}
    for i, (a, b) in enumerate(zip(g["state"], e["state"])):
        for name in a:
            assert torch.equal(a[name], b[name]), (i, name)
    assert int((g["state"][-1]["sampled"] != 0).sum()) > 0


@pytest.mark.cuda
def test_a_replayed_chunk_counts_the_launches_of_an_eager_one(cuda_device):
    """_kernels.launches counts a replay as the launches its capture
    recorded: each replayed chunk counts what the same chunk run eagerly
    launched (K2, K3 and K5 among them)."""
    g, e = _graph_and_eager_histories()
    assert g["launches"] == e["launches"]
    for counts in g["launches"]:
        assert counts["int8_matmul"] > 0 and counts["int8_matmul_t"] > 0
        assert counts["cross_attention_int8_skip"] == 4 * POOL["steps_per_chunk"]


@pytest.mark.cuda
def test_no_capture_after_warmup(cuda_device):
    """warmup() captures the greedy step once; a served churn of insert
    buckets (1, then 3, then 4 concurrent windows, one with word
    timestamps: the alignment pass at harvest) replays it and captures
    nothing more."""
    import dataclasses

    from whisperlive_tpu_torch.engine.continuous import ContinuousScheduler
    from whisperlive_tpu_torch.engine.engine import TranscribeOptions
    from whisperlive_tpu_torch.engine.scheduler import BatchRequest

    eng = _tiny_engine()
    sched = ContinuousScheduler(eng, n_slots=4, steps_per_chunk=2, prompt_pad=64, ring=64)
    sched.warmup()
    warm = dict(sched.cb.graph_stats)
    assert warm["graph_captures"] == 1
    opts = TranscribeOptions(language="en", temperatures=(0.0,), log_prob_threshold=None,
                             no_speech_threshold=None, compression_ratio_threshold=None,
                             max_new_tokens=12)
    rng = np.random.default_rng(6)
    sched.start()
    try:
        for wave in ([2.0], [1.5, 2.0, 2.5], [1.0, 1.5, 2.0, 2.5]):
            futs = []
            for i, sec in enumerate(wave):
                o = opts if i else dataclasses.replace(opts, word_timestamps=True)
                audio = (rng.standard_normal(int(16000 * sec)) * 0.1).astype(np.float32)
                futs.append(sched.submit(BatchRequest(audio=audio, options=o,
                                                      uid=f"w{len(wave)}-{i}")))
            for f in futs:
                f.result(timeout=180)
    finally:
        sched.stop()
    stats = sched.cb.graph_stats
    assert stats["graph_captures"] == 1 and sched.tick_stats["graph_captures"] == 1
    assert stats["graph_steps"] > warm["graph_steps"]
    assert stats["eager_steps"] == warm["eager_steps"]
