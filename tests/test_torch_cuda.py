"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; every test skips when torch.cuda.is_available() is False.
This file imports no JAX, so it also runs on a machine without it, where
tests/conftest.py (which imports jax) must be left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Inputs are bf16 (int8 weights and K|V) made with numpy. Tolerances against
max|ref|: K1 2^-6 (flash normalises after the bf16 PV product, the plain
version before it), K2 2^-7 (bf16 output, f32 sums in another order), K3
1e-5 (f32 output), K4 1e-3 (a probability may round to the other bf16
neighbour).
"""

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


def _err(out, ref):
    return (out.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("t", [28, 1500])
def test_fused_attention_kernel_on_card(cuda_device, t):
    rng = np.random.default_rng(t)
    q, k, v = (_gpu(rng, (2, t, 20, 64)) for _ in range(3))
    n = _kernels.launches["fused_attention"]
    err, scale = _err(tattn.fused_attention(q, k, v), tattn.fused_attention_ref(q, k, v))
    assert _kernels.launches["fused_attention"] == n + 1
    assert err <= 2.0**-6 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 64, 300, 512])
def test_int8_matmul_kernel_on_card(cuda_device, m):
    rng = np.random.default_rng(m)
    x = _gpu(rng, (m, 1280))
    w8 = torch.from_numpy(rng.integers(-127, 128, (1280, 5120)).astype(np.int8)).cuda()
    s = _gpu(rng, (5120,), 0.01).abs()
    err, scale = _err(tqmm.int8_matmul(x, w8, s), tqmm.int8_matmul_ref(x, w8, s))
    assert err <= 2.0**-7 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 7])
def test_int8_matmul_t_kernel_on_card(cuda_device, m):
    rng = np.random.default_rng(m)
    x = _gpu(rng, (m, 1280))
    w8 = torch.from_numpy(rng.integers(-127, 128, (51866, 1280)).astype(np.int8)).cuda()
    s = _gpu(rng, (51866,), 0.01).abs()
    err, scale = _err(tqmm.int8_matmul_t(x, w8, s), tqmm.int8_matmul_t_ref(x, w8, s))
    assert err <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [None, [1500, 700, 1, 0]])
def test_cross_attention_int8_kernel_on_card(cuda_device, lengths):
    rng = np.random.default_rng(1)
    q = _gpu(rng, (4, 20, 64), 0.05)
    kvp = torch.from_numpy(rng.integers(-127, 128, (4, 20, 1500, 128)).astype(np.int8)).cuda()
    ln = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device="cuda")
    err, scale = _err(tattn.cross_attention_int8(q, kvp, ln),
                      tattn.cross_attention_int8_ref(q, kvp, ln))
    assert err <= 1e-3 * scale
