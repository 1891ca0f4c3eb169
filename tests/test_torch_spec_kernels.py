"""The plain versions of K6, K5's window form, K7 and K8 against the JAX
package's Pallas kernels, and the int4 packing against the JAX package's.

Each `*_ref` (what a kernel wrapper runs for CPU tensors) is held against
the TPU kernel it stands for, run in Pallas interpret mode on the CPU as
tests/test_attention.py runs it, on the same float32 inputs made with
numpy. Tolerance: on each batch row, max abs error <= 1e-5 x that row's
max|ref| (float32 sums in another order), on the active rows only for K5's
window form (the TPU kernel leaves the other rows unspecified; the port's
are zero). q is drawn at scale 0.05 against random int8 codes and 16x
larger against int4 nibbles (whose std is 1/16 of theirs), so the scores
spread alike and the softmax is far from uniform in both. pack_int4 and
unpack_int4 are bit-exact. The CUDA kernels are checked against these refs in
tests/test_torch_cuda.py, which skips without a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisperlive_tpu.ops import attention as jattn
from whisperlive_tpu_torch.ops import _kernels
from whisperlive_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

REL_TOL = 1e-5
Q_SCALE_INT8, Q_SCALE_INT4 = 0.05, 0.05 * 16


def assert_close(out, ref, rel_tol=REL_TOL):
    """Per batch row: a length-1 row copies one V row and would set a
    single tolerance for rows that average many."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = np.abs(out - ref).reshape(len(out), -1).max(axis=1)
    scale = np.abs(ref).reshape(len(ref), -1).max(axis=1)
    assert (err <= rel_tol * scale).all(), (err, scale)


def window_inputs(seed, b=4, h=2, tq=5, t=96):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, h, tq, 64)) * Q_SCALE_INT8).astype(np.float32)
    kvp = rng.integers(-127, 128, (b, h, t, 128)).astype(np.int8)
    return q, kvp


@pytest.mark.parametrize("lengths", [None, [96, 40, 1, 0]], ids=["unmasked", "lengths"])
@pytest.mark.parametrize("tq", [2, 5, 8])
def test_k6_plain_version_matches_pallas(lengths, tq):
    q, kvp = window_inputs(tq, tq=tq)
    jlen = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    ref = jattn.cross_attention_int8_window(jnp.asarray(q), jnp.asarray(kvp), lengths=jlen,
                                            interpret=True)
    tlen = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    out = tattn.cross_attention_int8_window(torch.from_numpy(q), torch.from_numpy(kvp), tlen)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert_close(out, ref)
    if lengths is not None:  # every position masked (len 0): a uniform softmax
        v = kvp[3, :, :, 64:].astype(np.float32).mean(axis=1)
        np.testing.assert_allclose(out[3].numpy(), np.broadcast_to(v[:, None], (2, tq, 64)),
                                   atol=1e-4, rtol=1e-5)


def test_k6_plain_version_matches_pallas_full_window_over_the_encoder_context():
    """Tq = 8 (the largest window) over T = 1500 positions, one row of
    full length and one of length 0 (every query a uniform softmax)."""
    q, kvp = window_inputs(8, b=2, h=2, tq=8, t=1500)
    lengths = [1500, 0]
    ref = jattn.cross_attention_int8_window(jnp.asarray(q), jnp.asarray(kvp),
                                            lengths=jnp.asarray(lengths, jnp.int32),
                                            interpret=True)
    out = tattn.cross_attention_int8_window(torch.from_numpy(q), torch.from_numpy(kvp),
                                            torch.tensor(lengths, dtype=torch.int32))
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert_close(out, ref)
    v = kvp[1, :, :, 64:].astype(np.float32).mean(axis=1)
    np.testing.assert_allclose(out[1].numpy(), np.broadcast_to(v[:, None], (2, 8, 64)),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("case", ["mixed_lengths", "half_active", "len0_active"])
def test_k5_window_form_plain_version_matches_pallas(case):
    q, kvp = window_inputs(11, b=6, tq=5, t=64)
    lengths = np.array([64, 17, 1, 64, 33, 8], np.int32)
    active = np.ones(6, bool)
    if case == "half_active":
        active[1::2] = False
    elif case == "len0_active":
        lengths[2] = 0
        active[[0, 4]] = False
    ref = np.asarray(jattn.cross_attention_int8_window(
        jnp.asarray(q), jnp.asarray(kvp), lengths=jnp.asarray(lengths),
        active=jnp.asarray(active), interpret=True))
    args = (torch.from_numpy(q), torch.from_numpy(kvp), torch.from_numpy(lengths),
            torch.from_numpy(active))
    out = tattn.cross_attention_int8_skip_window(*args).numpy()
    assert_close(out[active], ref[active])
    np.testing.assert_array_equal(tattn.cross_attention_int8_window(*args).numpy(), out)
    assert not out[~active].any()  # the port's inactive rows are zero
    if case == "len0_active":
        v = kvp[2, :, :, 64:].astype(np.float32).mean(axis=1)
        np.testing.assert_allclose(out[2], np.broadcast_to(v[:, None], (2, 5, 64)), atol=1e-3)
    with pytest.raises(ValueError, match="lengths"):
        tattn.cross_attention_int8_window(args[0], args[1], None, args[3])


def int4_inputs(seed, b=4, h=2, t=80):
    rng = np.random.default_rng(seed)
    k4 = rng.integers(-128, 128, (b, h, t, 32)).astype(np.int8)
    v4 = rng.integers(-128, 128, (b, h, t, 32)).astype(np.int8)
    return rng, k4, v4


@pytest.mark.parametrize("lengths", [None, [80, 33, 1, 0]], ids=["unmasked", "lengths"])
def test_k7_plain_version_matches_pallas(lengths):
    rng, k4, v4 = int4_inputs(3)
    q = (rng.standard_normal((4, 2, 64)) * Q_SCALE_INT4).astype(np.float32)
    jlen = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    ref = jattn.cross_attention_int4(jnp.asarray(q), jnp.asarray(k4), jnp.asarray(v4),
                                     lengths=jlen, interpret=True)
    tlen = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    out = tattn.cross_attention_int4(*(torch.from_numpy(a) for a in (q, k4, v4)), tlen)
    assert out.shape == (4, 2, 64)
    assert_close(out, ref)


# T = 1500 is the encoder context, with a row of length 0 (a uniform
# softmax over all T)
@pytest.mark.parametrize("t, lengths", [(80, None), (80, [80, 33, 1, 0]),
                                        (1500, [1500, 700, 1, 0])],
                         ids=["unmasked", "lengths", "t1500-len0"])
@pytest.mark.parametrize("tq", [2, 8])
def test_k8_plain_version_matches_pallas(t, lengths, tq):
    rng, k4, v4 = int4_inputs(4 + tq, t=t)
    q = (rng.standard_normal((4, 2, tq, 64)) * Q_SCALE_INT4).astype(np.float32)
    jlen = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    ref = jattn.cross_attention_int4_window(jnp.asarray(q), jnp.asarray(k4), jnp.asarray(v4),
                                            lengths=jlen, interpret=True)
    tlen = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    out = tattn.cross_attention_int4_window(*(torch.from_numpy(a) for a in (q, k4, v4)), tlen)
    assert out.shape == q.shape
    assert_close(out, ref)


def test_int4_packing_is_bit_exact_with_jax():
    rng = np.random.default_rng(0)
    values = rng.integers(-8, 8, (3, 5, 64)).astype(np.int8)
    packed = tattn.pack_int4(torch.from_numpy(values))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jattn.pack_int4(jnp.asarray(values))))
    np.testing.assert_array_equal(tattn.unpack_int4(packed).numpy(), values)
    every_byte = np.arange(-128, 128, dtype=np.int8).reshape(8, 32)
    np.testing.assert_array_equal(tattn.unpack_int4(torch.from_numpy(every_byte)).numpy(),
                                  np.asarray(jattn.unpack_int4(jnp.asarray(every_byte))))


def test_cpu_tensors_take_the_plain_path_without_counting():
    before = dict(_kernels.launches)
    q, kvp = (torch.from_numpy(a) for a in window_inputs(1, b=2, tq=3, t=40))
    torch.testing.assert_close(tattn.cross_attention_int8_window(q, kvp),
                               tattn.cross_attention_int8_window_ref(q, kvp))
    _, k4, v4 = int4_inputs(2, b=2, t=40)
    k4, v4 = torch.from_numpy(k4), torch.from_numpy(v4)
    torch.testing.assert_close(tattn.cross_attention_int4(q[:, :, 0], k4, v4),
                               tattn.cross_attention_int4_ref(q[:, :, 0], k4, v4))
    torch.testing.assert_close(tattn.cross_attention_int4_window(q, k4, v4),
                               tattn.cross_attention_int4_window_ref(q, k4, v4))
    assert _kernels.launches == before
    assert {"cross_attention_int8_window", "cross_attention_int8_skip_window",
            "cross_attention_int4", "cross_attention_int4_window"} <= set(_kernels.KERNELS)
    names = {p.name for p in _kernels.sources()}
    # K5's window form, K6, K7 and K8 are instantiations of K4's source
    assert "cross_attention.cu" in names
    assert not names & {"cross_attention_int8.cu", "cross_attention_int8_window.cu",
                        "cross_attention_int4.cu"}
