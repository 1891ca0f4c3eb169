"""The port's draft distillation (whisperlive_tpu_torch/distill.py,
cli/distill.py, dequantize_decoder_weights) against the JAX package's.

The five tests of tests/test_distill.py, on the port, with the JAX
package's init_params(CFG_T, 0) teacher carried over by from_jax_params.
Stated tolerances: distill_loss within rtol 1e-5 and every student gradient
leaf within 1e-4 of that leaf's max|jax.grad|; measure_acceptance and
dequantize_decoder_weights exactly equal. The distiller CLI against
scripts/distill_draft.py (both on the CPU, on one random `transformers`
checkpoint of width 64 with a 51865-token vocabulary): the same audio pool,
token-exact pseudo-labels, equal tokens_in and loss_mask, the logged
losses within rtol 1e-4 (the feature pool is bfloat16 in both, so the
cross K/V products run in bfloat16), and a draft dir the port's loader reads.
"""

import copy
import importlib.util
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_convert import hf_checkpoint
from whisperlive_tpu import distill as jdistill
from whisperlive_tpu import training as jtrain
from whisperlive_tpu.models import whisper as jw
from whisperlive_tpu_torch import distill as tdistill
from whisperlive_tpu_torch import loader as tloader
from whisperlive_tpu_torch import training as ttrain
from whisperlive_tpu_torch.cli import distill as tcli
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.models.bridge import from_jax_params
from whisperlive_tpu_torch.models.safetensors_io import flatten_tree

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
DIMS = dict(n_mels=80, n_vocab=512, n_audio_ctx=96, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_text_ctx=48, n_text_state=64, n_text_head=4, n_text_layer=4)
JCFG = jw.WhisperConfig(**DIMS)
CFG_T = tw.WhisperConfig(**DIMS)



def to_port(jtree):
    return from_jax_params(jax.tree.map(np.asarray, jtree))


@pytest.fixture(scope="module")
def teachers():
    jp = jw.init_params(JCFG, 0)
    return jp, to_port(jp)


def _batch(rng, b=2, t=12):
    mel = rng.standard_normal((b, 2 * DIMS["n_audio_ctx"], DIMS["n_mels"])).astype(np.float32)
    tokens = rng.integers(0, DIMS["n_vocab"], (b, t)).astype(np.int32)
    return {"mel": torch.from_numpy(mel), "tokens_in": torch.from_numpy(tokens),
            "loss_mask": torch.ones((b, t))}


# --- the five tests of tests/test_distill.py, on the port ---------------------


def test_layer_indices():
    assert tdistill.student_layer_indices(32, 2) == [0, 31]
    assert tdistill.student_layer_indices(4, 4) == [0, 1, 2, 3]
    assert tdistill.student_layer_indices(4, 1) == [3]
    assert tdistill.student_layer_indices(12, 4) == [0, 4, 7, 11]


def test_identity_init_matches_teacher(teachers):
    """A student keeping all the teacher's layers is the teacher."""
    _, teacher = teachers
    student = tdistill.init_student_from_teacher(teacher, n_text_layer=CFG_T.n_text_layer)
    b = _batch(np.random.default_rng(0))
    with torch.no_grad():
        enc = tw.encode(teacher, CFG_T, b["mel"])
        t_logits = ttrain.decoder_forward_train(teacher, CFG_T, b["tokens_in"], enc)
        s_logits = ttrain.decoder_forward_train(student, CFG_T, b["tokens_in"], enc)
    np.testing.assert_allclose(s_logits.numpy(), t_logits.numpy(), atol=1e-5)


def test_student_init_copies_spaced_layers(teachers):
    _, teacher = teachers
    student = tdistill.init_student_from_teacher(teacher, n_text_layer=2)
    t_leaf = teacher["decoder"]["layers"]["attn"]["q"]["w"]
    s_leaf = student["decoder"]["layers"]["attn"]["q"]["w"]
    assert torch.equal(s_leaf[0], t_leaf[0]) and torch.equal(s_leaf[-1], t_leaf[-1])
    # copies, never views: the optimizer updates the student in place
    t_ptrs = {t.data_ptr() for t in ttrain.leaves(teacher["decoder"])}
    assert not t_ptrs & {t.data_ptr() for t in ttrain.leaves(student["decoder"])}


def test_distill_loss_decreases_and_acceptance_rises(teachers):
    _, teacher = teachers
    cfg_s = tdistill.student_config(CFG_T, n_text_layer=2)
    opt = ttrain.make_optimizer(learning_rate=5e-4, warmup_steps=2, total_steps=60)
    state = tdistill.init_distill_state(teacher, opt, n_text_layer=2)
    step = tdistill.make_distill_step(cfg_s, CFG_T, opt)
    # agreement on the training batch (the CE term optimizes argmax
    # agreement there); the bounds leave margin, as in the JAX test
    b = _batch(np.random.default_rng(1), b=4, t=16)

    def acc():
        return tdistill.measure_acceptance(teacher, tdistill.student_params(teacher, state),
                                           CFG_T, cfg_s, b["mel"], b["tokens_in"],
                                           b["loss_mask"])

    acc0 = acc()
    losses = []
    for _ in range(50):
        state, loss = step(state, teacher, b)
        losses.append(float(loss))
    acc1 = acc()
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
    assert acc1 >= acc0 - 0.02, (acc0, acc1)


def test_distilled_student_is_a_valid_speculative_draft(teachers):
    from whisperlive_tpu_torch.engine.engine import WhisperEngine
    from whisperlive_tpu_torch.engine.speculative import SpeculativeDecoder

    _, teacher = teachers
    cfg_s = tdistill.student_config(CFG_T, n_text_layer=2)
    student = tdistill.init_student_from_teacher(teacher, n_text_layer=2)
    t_eng = WhisperEngine(CFG_T, teacher, device="cpu", compute_dtype=torch.float32)
    d_eng = WhisperEngine(cfg_s, student, device="cpu", compute_dtype=torch.float32)
    assert SpeculativeDecoder(t_eng, d_eng, k=3).k == 3


# --- against the JAX package ----------------------------------------------------


@pytest.mark.parametrize("precomputed", [False, True])
def test_distill_loss_and_student_gradients_match_jax(teachers, precomputed):
    """From the mel (the teacher encodes) and from precomputed encoder
    states and teacher logits (in float32 here: from the CLI's bfloat16
    pool the cross K/V gradients are rounded to bfloat16, which the CLI
    test below covers through the losses)."""
    jp, tp = teachers
    jcfg_s = jdistill.student_config(JCFG, 2)
    cfg_s = tdistill.student_config(CFG_T, 2)
    jdec = jdistill.init_student_from_teacher(jp, 2)["decoder"]
    tdec = tdistill.init_student_from_teacher(tp, 2)["decoder"]
    b = _batch(np.random.default_rng(2), b=3, t=10)
    b["loss_mask"][2, 6:] = 0.0
    jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
    jkw, tkw = {}, {}
    if precomputed:
        enc = jw.encode(jp, JCFG, jb["mel"])
        jkw = {"enc": enc,
               "t_logits": jtrain.decoder_forward_train(jp, JCFG, jb["tokens_in"], enc)}
        tkw = {k: from_jax_params({"x": np.asarray(v)})["x"] for k, v in jkw.items()}
    ref_loss, ref_grads = jax.value_and_grad(jdistill.distill_loss)(
        jdec, jp, jcfg_s, JCFG, None if precomputed else jb["mel"], jb["tokens_in"],
        jb["loss_mask"], **jkw)
    loss, grads = ttrain.value_and_grad(lambda: tdistill.distill_loss(
        tdec, tp, cfg_s, CFG_T, None if precomputed else b["mel"], b["tokens_in"],
        b["loss_mask"], **tkw), tdec)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    ref = flatten_tree(to_port(ref_grads))
    got = dict(zip(flatten_tree(tdec).keys(), grads))
    assert got.keys() == ref.keys()
    for path, g in got.items():
        r = ref[path].numpy()
        assert np.abs(g.numpy() - r).max() <= 1e-4 * np.abs(r).max(), path


@pytest.mark.parametrize("from_mel", [True, False])
def test_measure_acceptance_equals_jax(teachers, from_mel):
    jp, tp = teachers
    jcfg_s, cfg_s = jdistill.student_config(JCFG, 2), tdistill.student_config(CFG_T, 2)
    b = _batch(np.random.default_rng(3), b=4, t=16)
    mask = b["loss_mask"].numpy()
    mask[:, :3] = 0.0
    enc = None if from_mel else np.array(jw.encode(jp, JCFG, jnp.asarray(b["mel"].numpy())))
    ref = jdistill.measure_acceptance(jp, jdistill.init_student_from_teacher(jp, 2), JCFG,
                                      jcfg_s, b["mel"].numpy(), b["tokens_in"].numpy(), mask,
                                      enc=enc)
    got = tdistill.measure_acceptance(tp, tdistill.init_student_from_teacher(tp, 2), CFG_T,
                                      cfg_s, b["mel"].numpy(), b["tokens_in"].numpy(), mask,
                                      enc=enc)
    assert got == ref and 0.0 < got < 1.0


@pytest.mark.parametrize("n_layer", [2, 4])
def test_teacher_unchanged_by_distill_steps(teachers, n_layer):
    """torch optimizers update in place: five steps must leave every teacher
    tensor bit-equal (n_layer 4 is the identity init, every layer copied)."""
    _, teacher = teachers
    before = copy.deepcopy(teacher)
    cfg_s = tdistill.student_config(CFG_T, n_layer)
    opt = ttrain.make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    state = tdistill.init_distill_state(teacher, opt, n_text_layer=n_layer)
    start = copy.deepcopy(state.student_decoder)
    step = tdistill.make_distill_step(cfg_s, CFG_T, opt)
    b = _batch(np.random.default_rng(4))
    for _ in range(5):
        state, _ = step(state, teacher, b)
    for path, t in flatten_tree(teacher).items():
        assert torch.equal(t, flatten_tree(before)[path]) and not t.requires_grad, path
    start = flatten_tree(start)
    assert not any(torch.equal(t, start[k])
                   for k, t in flatten_tree(state.student_decoder).items())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_decoder_weights_bit_equal_to_jax(teachers, dtype):
    jp, tp = teachers
    jq = jw.quantize_decoder_weights(jp)
    tq = to_port(jq)
    ref = to_port(jw.dequantize_decoder_weights(jq, getattr(jnp, dtype)))
    got = tw.dequantize_decoder_weights(tq, getattr(torch, dtype))
    assert flatten_tree(got).keys() == flatten_tree(ref).keys()
    for path, r in flatten_tree(ref).items():
        g = flatten_tree(got)[path]
        assert g.dtype == r.dtype and torch.equal(g, r), path
    assert got["decoder"]["layers"]["mlp"]["fc1"]["b"] is tq["decoder"]["layers"]["mlp"]["fc1"]["b"]
    assert tw.dequantize_decoder_weights(tp) is tp


# --- the distiller CLI against scripts/distill_draft.py ------------------------


class NumpySpy:
    """numpy for the JAX script's module: records what np.stack and np.zeros
    return (the audio pool; tokens_in and loss_mask, filled in place)."""

    def __init__(self):
        self.stacked, self.made = [], []

    def __getattr__(self, name):
        return getattr(np, name)

    def stack(self, *a, **kw):
        self.stacked.append(np.stack(*a, **kw))
        return self.stacked[-1]

    def zeros(self, *a, **kw):
        self.made.append(np.zeros(*a, **kw))
        return self.made[-1]


def logged_losses(records, name):
    return {r.args[0]: r.args[1] for r in records
            if r.name == name and r.msg.startswith("step")}


def test_distill_cli_matches_jax_script(tmp_path, monkeypatch, caplog):
    hf, _ = hf_checkpoint(tmp_path / "hf")
    argv = ["--model", "tiny", "-tpu", hf, "--pool", "8", "--steps", "3", "--seq", "16",
            "--batch", "2", "--enc_ctx", "256"]
    spec = importlib.util.spec_from_file_location("distill_draft",
                                                  ROOT / "scripts" / "distill_draft.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    spy = NumpySpy()
    monkeypatch.setattr(script, "np", spy)
    caplog.set_level(logging.INFO)
    assert script.main([*argv, "--out", str(tmp_path / "jax"), "--platform", "cpu"]) == 0

    seen = {}
    for name in ("audio_pool", "pseudo_label"):
        fn = getattr(tcli, name)
        monkeypatch.setattr(tcli, name, lambda *a, _f=fn, _n=name, **k: seen.setdefault(
            _n, _f(*a, **k)))
    out = str(tmp_path / "port")
    assert tcli.main([*argv, "--out", out, "--device", "cpu"]) == 0

    np.testing.assert_array_equal(seen["audio_pool"], spy.stacked[0])
    tokens_in, loss_mask = seen["pseudo_label"]
    made = [z for z in spy.made if z.shape == (8, 16)]
    ref_tokens = next(z for z in made if z.dtype == np.int32)
    ref_mask = next(z for z in made if z.dtype == np.float32)
    np.testing.assert_array_equal(tokens_in, ref_tokens)
    np.testing.assert_array_equal(loss_mask, ref_mask)
    assert loss_mask.sum() > 8  # every clip has pseudo tokens to learn

    ref_losses = logged_losses(caplog.records, "distill_draft")
    losses = logged_losses(caplog.records, tcli.logger.name)
    assert sorted(losses) == sorted(ref_losses) == [0, 2]
    for i, ref in ref_losses.items():
        np.testing.assert_allclose(losses[i], ref, rtol=1e-4)

    assert tloader.draft_distill_ctx(out) == 256
    draft = tloader.load_engine("distill", out, device="cpu")
    assert draft.cfg.n_text_layer == 2 and draft.cfg.n_vocab == 51865
