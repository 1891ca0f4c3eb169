"""Multi-process training of the port against the JAX package's mesh.

Ranks join through parallel.multihost.init_multihost (one host, gloo on
the CPU; tests/torch_parallel_worker.py with PYTHONPATH set for each
child) and train the reference's job (tests/multihost_worker.py: 2 + 2
layers, width 64, 4 heads, vocab 512, AdamW at 1e-3 with one warmup step)
on the same JAX init_params weights. The topology must not change the
math: the ranks' loss streams are equal to each other and within rtol
1e-4 / atol 1e-5 of the JAX package's on its eight-virtual-device mesh
(tp = 2, dp = 4); the primary's checkpoint (the port's training format,
gathered from the tp slices) loads in one process and equals the JAX
parameters after the same steps within the reference test's rtol 2e-3 /
atol 1e-4. Two grids: tp = 2 on two ranks (a new batch each step, as the
reference job) and dp = 2 x tp = 2 on four (one batch four times, as
tests/test_parallel.py's train step, whose loss must fall).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import multihost_worker as mhw
import torch_parallel_worker as tpw
from whisperlive_tpu import training as jtraining
from whisperlive_tpu.models.whisper import init_params as j_init_params
from whisperlive_tpu.parallel.mesh import EngineShardings as JShardings
from whisperlive_tpu_torch import training as ttraining
from whisperlive_tpu_torch.models.bridge import from_jax_params
from whisperlive_tpu_torch.models.safetensors_io import flatten_tree

GRIDS = {"tp2": (2, 1, 3, False), "dp2xtp2": (2, 2, 4, True)}  # tp, dp, steps, same batch


def _jax_job(steps: int, same_batch: bool):
    """The job on this process's own 8-device mesh: (losses, final params)."""
    cfg = mhw.test_config()
    sh = JShardings.create(tp=2)
    opt = jtraining.make_optimizer(learning_rate=1e-3, warmup_steps=1)
    params = jax.device_put(j_init_params(cfg, seed=0),
                            sh.param_shardings(j_init_params(cfg, seed=0)))
    state = jtraining.TrainState(params, jax.jit(opt.init)(params), jnp.zeros((), jnp.int32))
    step = jax.jit(jtraining.make_train_step(cfg, opt), donate_argnums=0)
    losses = []
    for i in range(steps):
        batch = mhw.make_global_batch(cfg, 0 if same_batch else i, 8)
        state, loss = step(state, {k: jax.device_put(v, sh.batch_sharding(v.ndim))
                                   for k, v in batch.items()})
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, jax.device_get(state.params))


@pytest.fixture(scope="module", params=sorted(GRIDS))
def train_run(request, tmp_path_factory):
    tp, dp, steps, same = GRIDS[request.param]
    d = tmp_path_factory.mktemp(request.param)
    cfg = mhw.test_config()
    tpw.save_params(d / "params.npz", jax.tree.map(np.asarray, j_init_params(cfg, 0)))
    dims = {k: getattr(cfg, k) for k in ("n_mels", "n_vocab", "n_audio_ctx", "n_audio_state",
                                         "n_audio_head", "n_audio_layer", "n_text_ctx",
                                         "n_text_state", "n_text_head", "n_text_layer")}
    tpw.run_ranks("train", tp * dp, str(d),
                  dict(tp=tp, dp=dp, dims=dims, steps=steps, same_batch=same))
    outs = [json.loads((d / f"out{r}.json").read_text()) for r in range(tp * dp)]
    return d, outs, _jax_job(steps, same), steps


def test_ranks_match_jax_mesh_losses(train_run):
    _, outs, (ref, _), steps = train_run
    for o in outs:  # every rank returns the same global loss
        np.testing.assert_allclose(o["losses"], outs[0]["losses"], rtol=0, atol=0)
        assert o["step"] == steps
        # fetch_replicated: every rank's copy, gathered on each
        assert o["fetched"] == [np.float32(outs[0]["losses"][-1]).item()] * len(outs)
    np.testing.assert_allclose(outs[0]["losses"], ref, rtol=1e-4, atol=1e-5)


def test_primary_checkpoint_restores(train_run):
    d, _, (_, ref_params), steps = train_run
    state, cfg = ttraining.load_checkpoint(str(d / "ckpt"), device="cpu")
    assert cfg == tpw.make_config({k: getattr(mhw.test_config(), k) for k in (
        "n_mels", "n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer",
        "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer")})
    assert state.step == steps and state.opt_state.count == steps
    got = flatten_tree(state.params)
    want = flatten_tree(from_jax_params(ref_params))
    assert set(got) == set(want) and len(got) > 20
    for key, ref in want.items():
        assert got[key].shape == ref.shape, key
        np.testing.assert_allclose(got[key].numpy(), ref.numpy(), rtol=2e-3, atol=1e-4,
                                   err_msg=key)


def test_train_step_lowers_the_loss(train_run):
    _, outs, _, _ = train_run
    losses = outs[0]["losses"]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
