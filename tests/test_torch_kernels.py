"""The port's kernel modules against the JAX package's Pallas kernels.

Each plain PyTorch `*_ref` (what a kernel wrapper runs for CPU tensors) is
held against the TPU kernel it stands for, run in Pallas interpret mode on
the CPU as tests/test_attention.py runs it, on the same float32 inputs made
with numpy. Tolerance: max abs error <= 1e-5 x max|ref| (float32 sums in
another order). The CUDA kernels themselves are checked against these refs
in tests/test_torch_cuda.py, which skips without a card (chip_smoke.py does
the same comparison at the serving shapes).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisperlive_tpu.ops import attention as jattn
from whisperlive_tpu.ops import quant_matmul as jqmm
from whisperlive_tpu_torch.ops import _kernels
from whisperlive_tpu_torch.ops import attention as tattn
from whisperlive_tpu_torch.ops import quant_matmul as tqmm

torch.set_num_threads(2)

REL_TOL = 1e-5


def assert_close(out, ref, rel_tol=REL_TOL):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= rel_tol * np.abs(ref).max(), (err, np.abs(ref).max())


def int8_weights(rng, rows, cols, axis):
    w = rng.standard_normal((rows, cols)).astype(np.float32)
    s = (np.abs(w).max(axis=axis) / 127.0).astype(np.float32)
    w8 = np.clip(np.round(w / np.expand_dims(s, axis)), -127, 127).astype(np.int8)
    return w8, s


@pytest.mark.parametrize("t", [200, 1500])
def test_fused_attention_ref_matches_pallas(t):
    rng = np.random.default_rng(t)
    q, k, v = (rng.standard_normal((1, t, 2, 64)).astype(np.float32) for _ in range(3))
    ref = jattn.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    out = tattn.fused_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    assert_close(out, ref)


@pytest.mark.parametrize("m", [1, 16, 300])
def test_int8_matmul_ref_matches_pallas(m):
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, 128)).astype(np.float32)
    w8, s = int8_weights(rng, 128, 384, axis=0)
    ref = jqmm.int8_matmul(jnp.asarray(x), jnp.asarray(w8), jnp.asarray(s), interpret=True)
    out = tqmm.int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(w8), torch.from_numpy(s))
    assert_close(out, ref)


@pytest.mark.parametrize("m", [1, 16, 300])
def test_int8_matmul_t_ref_matches_pallas(m):
    # N = 1000 has no multiple-of-128 divisor: the TPU kernel's padding path
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, 128)).astype(np.float32)
    w8, s = int8_weights(rng, 1000, 128, axis=1)
    ref = jqmm.int8_matmul_t(jnp.asarray(x), jnp.asarray(w8), jnp.asarray(s), interpret=True)
    out = tqmm.int8_matmul_t_ref(torch.from_numpy(x), torch.from_numpy(w8), torch.from_numpy(s))
    assert out.dtype == torch.float32
    assert_close(out, ref)


@pytest.mark.parametrize("lengths", [None, [300, 150, 1, 0]])
def test_cross_attention_int8_ref_matches_pallas(lengths):
    rng = np.random.default_rng(7)
    q = (rng.standard_normal((4, 2, 64)) * 0.05).astype(np.float32)
    kvp = rng.integers(-127, 128, (4, 2, 300, 128)).astype(np.int8)
    jlen = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    ref = jattn.cross_attention_int8(jnp.asarray(q), jnp.asarray(kvp), lengths=jlen,
                                     interpret=True)
    tlen = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    out = tattn.cross_attention_int8_ref(torch.from_numpy(q), torch.from_numpy(kvp), tlen)
    assert_close(out, ref)
    if lengths is not None:
        # every position masked (len 0): a uniform softmax, not NaN
        assert np.isfinite(out.numpy()).all()
        np.testing.assert_allclose(
            out[3].numpy(), kvp[3, :, :, 64:].astype(np.float32).mean(axis=1), rtol=1e-5,
            atol=1e-4,
        )


def test_cpu_tensors_take_the_plain_path_without_counting():
    rng = np.random.default_rng(0)
    before = dict(_kernels.launches)
    q = torch.from_numpy(rng.standard_normal((1, 70, 2, 64)).astype(np.float32))
    torch.testing.assert_close(tattn.fused_attention(q, q, q), tattn.fused_attention_ref(q, q, q))
    x = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    w8, s = (torch.from_numpy(a) for a in int8_weights(rng, 32, 48, axis=0))
    torch.testing.assert_close(tqmm.int8_matmul(x, w8, s), tqmm.int8_matmul_ref(x, w8, s))
    w8t, st = (torch.from_numpy(a) for a in int8_weights(rng, 48, 32, axis=1))
    torch.testing.assert_close(tqmm.int8_matmul_t(x, w8t, st), tqmm.int8_matmul_t_ref(x, w8t, st))
    qc = torch.from_numpy(rng.standard_normal((2, 2, 64)).astype(np.float32))
    kvp = torch.from_numpy(rng.integers(-127, 128, (2, 2, 40, 128)).astype(np.int8))
    torch.testing.assert_close(tattn.cross_attention_int8(qc, kvp),
                               tattn.cross_attention_int8_ref(qc, kvp))
    assert _kernels.launches == before


def test_wrappers_refuse_other_devices():
    q = torch.zeros((1, 4, 1, 64), device="meta")
    with pytest.raises(ValueError):
        tattn.fused_attention(q, q, q)


def test_kernel_library_is_named_by_its_sources():
    path = _kernels.library_path()
    assert path.parent == _kernels.BUILD_DIR
    assert path.name.startswith("libwl_kernels-") and path.suffix == ".so"
    names = {p.name for p in _kernels.sources()}
    assert names >= {"fused_attention.cu", "int8_matmul.cu", "int8_matmul_t.cu",
                     "cross_attention.cu"}
