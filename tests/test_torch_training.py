"""The port's training path (whisperlive_tpu_torch/training.py) against the
JAX package's (whisperlive_tpu/training.py).

A tiny config (width 64, 4 heads, 2 audio and 2 text layers, vocabulary 512,
96 encoder positions, 80 mels) in float32; JAX's init_params(cfg, seed)
weights carried over with from_jax_params and numpy inputs from a seed go
through both. Stated tolerances: the training decoder's logits within atol
1e-4 and rtol 1e-4; whisper_loss within rtol 1e-5 and every gradient leaf
within 1e-4 of that leaf's max|jax.grad| (float32 sums in another order);
the schedule within 1e-7 of optax's at every step; after n train steps
every parameter within n * 1e-3 * lr + 1e-6 of JAX's (the update divides by
sqrt(v_hat) + 1e-8, which amplifies the gradients' rounding near 1e-8; lr
1e-4), and bit-equal to the start after the first step (learning rate 0).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_convert import assert_trees_equal
from whisperlive_tpu import training as jtrain
from whisperlive_tpu.models import whisper as jw
from whisperlive_tpu_torch import training as ttrain
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.models.bridge import from_jax_params
from whisperlive_tpu_torch.models.safetensors_io import flatten_tree

torch.set_num_threads(2)

DIMS = dict(n_mels=80, n_vocab=512, n_audio_ctx=96, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_text_ctx=48, n_text_state=64, n_text_head=4, n_text_layer=2)
JCFG = jw.WhisperConfig(**DIMS)
TCFG = tw.WhisperConfig(**DIMS)



def to_port(jtree):
    return from_jax_params(jax.tree.map(np.asarray, jtree))


def batch(seed=0, b=2, t=12):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((b, 2 * DIMS["n_audio_ctx"], DIMS["n_mels"])).astype(np.float32)
    tokens = rng.integers(0, DIMS["n_vocab"], (b, t + 1)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[1, t - 3:] = 0.0  # a padded tail
    return {"mel": mel, "tokens_in": tokens[:, :-1], "tokens_out": tokens[:, 1:],
            "loss_mask": mask}


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def params():
    jp = jw.init_params(JCFG, 0)
    return jp, to_port(jp)


def test_decoder_forward_train_matches_jax(params):
    jp, tp = params
    b = batch(1)
    enc = np.random.default_rng(2).standard_normal((2, 96, 64)).astype(np.float32)
    ref = np.asarray(jtrain.decoder_forward_train(jp, JCFG, jnp.asarray(b["tokens_in"]),
                                                  jnp.asarray(enc)))
    out = ttrain.decoder_forward_train(tp, TCFG, torch.from_numpy(b["tokens_in"]),
                                       torch.from_numpy(enc))
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 12, 512)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_whisper_loss_and_every_gradient_match_jax(params):
    """jax.grad of whisper_loss against the port's autograd, leaf by leaf;
    the encoder's attention weights take a non-zero gradient (a K1-style
    detached attention output would cut them from the graph)."""
    jp, tp = params
    b = batch(3)
    jb = as_jax(b)
    ref_loss, ref_grads = jax.value_and_grad(jtrain.whisper_loss)(
        jp, JCFG, jb["mel"], jb["tokens_in"], jb["tokens_out"], jb["loss_mask"])
    tb = as_torch(b)
    loss, grads = ttrain.value_and_grad(lambda: ttrain.whisper_loss(
        tp, TCFG, tb["mel"], tb["tokens_in"], tb["tokens_out"], tb["loss_mask"]), tp)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)

    ref = flatten_tree(to_port(ref_grads))
    got = dict(zip(flatten_tree(tp).keys(), grads))
    assert got.keys() == ref.keys()
    for path, g in got.items():
        r = ref[path].numpy()
        scale = np.abs(r).max()
        assert np.abs(g.numpy() - r).max() <= 1e-4 * scale, path
    assert not any(p.requires_grad for p in ttrain.leaves(tp))
    for name in ("q", "k", "v", "o"):
        assert ref[f"encoder/layers/attn/{name}/w"].abs().max() > 0
        assert got[f"encoder/layers/attn/{name}/w"].abs().max() > 0


@pytest.mark.parametrize("lr, warmup, total", [(1e-3, 3, 10), (1e-5, 100, 10_000),
                                                (5e-4, 1, 3), (2e-4, 0, 5), (1e-4, 4, 2)])
def test_schedule_matches_optax(lr, warmup, total):
    opt = ttrain.make_optimizer(learning_rate=lr, warmup_steps=warmup, total_steps=total)
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(total, warmup + 1))
    steps = range(0, max(total, warmup + 1) + 3)
    if total == 10_000:
        steps = [*range(0, 103), 5000, 9999, 10_000, 10_001, 10_002]
    for s in steps:
        assert abs(opt.schedule(s) - float(ref(s))) <= 1e-7, s
    if warmup:  # the first update runs at learning rate 0
        assert opt.schedule(0) == 0.0


@pytest.mark.parametrize("max_norm", [1.0, 1e-2])
def test_three_train_steps_match_jax(params, max_norm):
    """Three steps of make_train_step from the same weights and batch; with
    max_norm 1e-2 the gradient's global norm exceeds the bound, so every
    step clips. lr 1e-4 is the distiller's default: the update divides by
    sqrt(v_hat) + 1e-8, so at a gradient element near 1e-8 a rounding
    difference of ~1e-10 between the two backward passes moves the update
    by ~2.5e-3 of lr (3e-6 at lr 1e-3), inside 1e-6 here."""
    jp, tp = params
    lr = 1e-4
    b = batch(4)
    jopt = jtrain.make_optimizer(learning_rate=lr, warmup_steps=1, total_steps=10,
                                 max_grad_norm=max_norm)
    topt = ttrain.make_optimizer(learning_rate=lr, warmup_steps=1, total_steps=10,
                                 max_grad_norm=max_norm)
    jstate = jtrain.init_train_state(JCFG, jopt, params=jp)
    jstep = jax.jit(jtrain.make_train_step(JCFG, jopt))
    tstate = ttrain.init_train_state(TCFG, topt, params=tp, device="cpu")
    tstep = ttrain.make_train_step(TCFG, topt)
    start = {k: v.clone() for k, v in flatten_tree(tstate.params).items()}
    callers = {k: v.clone() for k, v in flatten_tree(tp).items()}

    if max_norm < 1.0:
        tb = as_torch(b)
        _, grads = ttrain.value_and_grad(lambda: ttrain.whisper_loss(
            tstate.params, TCFG, tb["mel"], tb["tokens_in"], tb["tokens_out"],
            tb["loss_mask"]), tstate.params)
        assert float(torch.sqrt(sum((g * g).sum() for g in grads))) > 10 * max_norm

    for n in range(1, 4):
        jstate, jloss = jstep(jstate, as_jax(b))
        tstate, tloss = tstep(tstate, as_torch(b))
        assert tstate.step == int(jstate.step) == n
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        ref = flatten_tree(to_port(jstate.params))
        for path, p in flatten_tree(tstate.params).items():
            assert p.dtype == torch.float32
            err = (p - ref[path]).abs().max().item()
            assert err <= n * 1e-3 * lr + 1e-6, (n, path, err)
            if n == 1:
                assert torch.equal(p, start[path]), path
    assert all(not torch.equal(p, start[k]) for k, p in flatten_tree(tstate.params).items())
    # the caller's tensors are never updated
    assert all(torch.equal(p, callers[k]) for k, p in flatten_tree(tp).items())


def test_checkpoint_round_trip_and_deterministic_resume(tmp_path):
    """As tests/test_checkpoint.py does for the JAX package: two steps,
    save, restore bit-equal (params, both moments, counts), and one more
    step from each gives the same loss."""
    opt = ttrain.make_optimizer(learning_rate=1e-3, warmup_steps=1)
    state = ttrain.init_train_state(TCFG, opt, seed=0, device="cpu")
    step = ttrain.make_train_step(TCFG, opt)
    b = as_torch(batch(5))
    state, _ = step(state, b)
    state, _ = step(state, b)

    ttrain.save_checkpoint(str(tmp_path / "t"), state, TCFG)
    restored, cfg2 = ttrain.load_checkpoint(str(tmp_path / "t"), "cpu")
    assert cfg2 == TCFG
    assert restored.step == state.step == 2 and restored.opt_state.count == 2
    for a, r in ((state.params, restored.params), (state.opt_state.mu, restored.opt_state.mu),
                 (state.opt_state.nu, restored.opt_state.nu)):
        assert_trees_equal(a, r)

    s1, l1 = step(state, b)
    s2, l2 = step(restored, b)
    assert float(l1) == float(l2)
    for k, p in flatten_tree(s1.params).items():
        assert torch.equal(p, flatten_tree(s2.params)[k]), k


def test_orbax_training_checkpoint_is_refused(tmp_path):
    opt = jtrain.make_optimizer(learning_rate=1e-3, warmup_steps=1)
    cfg = jw.WhisperConfig(n_mels=80, n_vocab=64, n_audio_ctx=8, n_audio_state=16,
                           n_audio_head=2, n_audio_layer=1, n_text_ctx=8, n_text_state=16,
                           n_text_head=2, n_text_layer=1)
    jtrain.save_checkpoint(str(tmp_path / "orbax"), jtrain.init_train_state(cfg, opt), cfg)
    with pytest.raises(ValueError, match="orbax training checkpoint of the JAX package"):
        ttrain.load_checkpoint(str(tmp_path / "orbax"), "cpu")
    with pytest.raises(ValueError, match="holds no training checkpoint"):
        ttrain.load_checkpoint(str(tmp_path), "cpu")


def test_train_state_and_checkpoint_default_to_the_card(tmp_path):
    """init_train_state and load_checkpoint place the state on CUDA unless
    the caller asks for the CPU; on a machine without a card they raise
    rather than train on the CPU."""
    opt = ttrain.make_optimizer(learning_rate=1e-3, warmup_steps=1)
    ttrain.save_checkpoint(str(tmp_path), ttrain.init_train_state(TCFG, opt, device="cpu"), TCFG)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            ttrain.init_train_state(TCFG, opt)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            ttrain.load_checkpoint(str(tmp_path))
        return
    for state in (ttrain.init_train_state(TCFG, opt), ttrain.load_checkpoint(str(tmp_path))[0]):
        devices = {t.device.type for t in ttrain.leaves(state.params) + ttrain.leaves(
            state.opt_state.mu) + ttrain.leaves(state.opt_state.nu)}
        assert devices == {"cuda"}
