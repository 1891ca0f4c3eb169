"""The port's VAD and speaker trainers against the JAX package's.

The four training forwards (`gru_forward_torch`, `silero_forward_torch`,
the MLP's and the WeSpeaker ResNet's `embed_torch`) and their gradients
(torch autograd against `jax.value_and_grad` of the same loss) on the same
numpy inputs, float32 on the CPU: within 1e-5 of max|ref|, the ResNet's
EMA-updated BatchNorm statistics included. The ResNet's gradients part by
up to 3.2e-5 of max|ref| in float32 (BatchNorm over a batch of 3 amplifies
the convolutions' summation order) and agree to ~1e-13 in float64, so its
gradient case runs in float64 (at the same 1e-5), beside a float32 case of
its forward, loss and statistics. Then 3 steps of each trainer
CLI (`cli.train_vad` --arch gru|silero, `cli.train_speaker` --arch
mlp|resnet, --device cpu) against the reference's own script
(scripts/train_vad.py, scripts/train_speaker.py: its optax loop) on the same
seed, so on the same synthetic batches: the saved parameters within 1e-4
(absolute: an Adam step moves a parameter by up to its lr of 2-3e-3, and
normalizes a near-zero gradient's float32 noise to that size), every key
present in both.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from whisperlive_tpu.audio import silero_vad as jsilero
from whisperlive_tpu.audio import speaker_model as jspk
from whisperlive_tpu.audio import vad_model as jvad
from whisperlive_tpu.audio import wespeaker as jws
from whisperlive_tpu_torch.audio import silero_vad as tsilero
from whisperlive_tpu_torch.audio import speaker_model as tspk
from whisperlive_tpu_torch.audio import vad_model as tvad
from whisperlive_tpu_torch.audio import wespeaker as tws
from whisperlive_tpu_torch.cli import train_speaker, train_vad

ROOT = Path(__file__).resolve().parents[1]
FWD_TOL = 1e-5
TRAIN_TOL = 1e-4


def _close(ref, got, tol, what):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ref - got).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _vad_loss_jax(forward, labels):
    def loss(p, feats):
        _, logits = forward(p, feats)
        return optax.sigmoid_binary_cross_entropy(logits, labels).mean()
    return loss


def _speaker_loss_jax(forward, labels, scale=12.0, margin=0.2):
    def loss(p, feats):
        emb, stats = forward(p, feats)
        wc = p["wc"] / (jnp.linalg.norm(p["wc"], axis=0, keepdims=True) + 1e-8)
        cos = emb @ wc
        onehot = jax.nn.one_hot(labels, cos.shape[1], dtype=cos.dtype)
        logits = scale * (cos - margin * onehot)
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean(), stats
    return loss


def _speaker_loss_torch(emb, wc, labels, scale=12.0, margin=0.2):
    wc = wc / (torch.linalg.vector_norm(wc, dim=0, keepdim=True) + 1e-8)
    cos = emb @ wc
    onehot = F.one_hot(labels, cos.shape[1]).to(cos.dtype)
    return F.cross_entropy(scale * (cos - margin * onehot), labels)


def _case(arch, seed):
    """(numpy params, numpy feats, numpy labels) of one forward case."""
    rng = np.random.default_rng(seed)
    if arch == "gru":
        params = jvad.init_vad_params(seed)
        feats = rng.standard_normal((3, 9, jvad.N_FEATS)).astype(np.float32)
        labels = (rng.random((3, 9)) > 0.5).astype(np.float32)
    elif arch == "silero":
        params = jsilero.init_silero_params(seed)
        feats = rng.standard_normal((2, 5, jsilero.N_FRAMES, jsilero.N_FREQS)).astype(np.float32)
        labels = (rng.random((2, 5)) > 0.5).astype(np.float32)
    elif arch == "mlp":
        params = jspk.init_speaker_params(seed, n_classes=12)
        # a padded tail of zero frames: the sqrt(var + eps) pooling
        feats = rng.standard_normal((4, 30, jspk.N_BANDS)).astype(np.float32)
        feats[:, 24:] = 0.0
        labels = rng.integers(0, 12, 4)
    else:
        params = jws.init_wespeaker_params(jws.LITE, seed)
        params["wc"] = rng.uniform(-0.2, 0.2, (jws.LITE.emb_dim, 12)).astype(np.float32)
        # non-trivial running statistics, so the EMA's both terms count
        for k in list(params):
            if k.endswith("_m"):
                params[k] = rng.standard_normal(params[k].shape).astype(np.float32) * 0.1
            elif k.endswith("_v"):
                params[k] = rng.uniform(0.5, 1.5, params[k].shape).astype(np.float32)
        feats = rng.standard_normal((3, 40, 80)).astype(np.float32)
        labels = rng.integers(0, 12, 3)
    return params, feats, labels


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", ["gru", "silero", "mlp", "resnet"])
def test_training_forward_and_gradients_match_jax(arch, seed):
    if arch != "resnet":
        return _forward_and_gradients(arch, seed, np.float32)
    with jax.enable_x64(True):
        _forward_and_gradients(arch, seed, np.float64)


@pytest.mark.parametrize("seed", [0, 1])
def test_resnet_training_forward_matches_jax_in_float32(seed):
    params, feats, labels = _case("resnet", seed)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    (loss_j, stats_j) = _speaker_loss_jax(
        lambda p, f: jws.embed_jax(p, f, train=True), jnp.asarray(labels))(jp, jnp.asarray(feats))
    emb_j, _ = jws.embed_jax(jp, jnp.asarray(feats), train=True)
    emb_t, stats_t = tws.embed_torch(tp, torch.tensor(feats), train=True)
    _close(emb_j, emb_t, FWD_TOL, "embedding")
    _close(loss_j, _speaker_loss_torch(emb_t, tp["wc"], torch.tensor(labels)), FWD_TOL, "loss")
    assert set(stats_t) == set(stats_j)
    for k, v in stats_j.items():
        _close(v, stats_t[k], FWD_TOL, f"EMA {k}")


@pytest.mark.parametrize("seed", [0, 1])
def test_mlp_inference_pooling_matches_embed_np(seed):
    """embed_torch with std_eps=0 is embed_np's function, batched: what a
    trained card model is checked against."""
    params, feats, _ = _case("mlp", seed)
    got = tspk.embed_torch({k: torch.tensor(v) for k, v in params.items()},
                           torch.tensor(feats[:, :24]), std_eps=0.0)
    for b in range(feats.shape[0]):
        _close(tspk.embed_np(params, feats[b, :24]), got[b], FWD_TOL, f"row {b}")


def _forward_and_gradients(arch, seed, dtype):
    params, feats, labels = _case(arch, seed)
    params = {k: v.astype(dtype) for k, v in params.items()}
    feats = feats.astype(dtype)
    if labels.dtype.kind == "f":
        labels = labels.astype(dtype)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tf = torch.tensor(feats)
    stats_t: dict = {}
    if arch in ("gru", "silero"):
        jfwd = jvad.gru_forward_jax if arch == "gru" else jsilero.silero_forward_jax
        tfwd = tvad.gru_forward_torch if arch == "gru" else tsilero.silero_forward_torch
        probs_j, logits_j = jfwd(jp, jnp.asarray(feats))
        probs_t, logits_t = tfwd(tp, tf)
        _close(probs_j, probs_t.detach(), FWD_TOL, "probs")
        _close(logits_j, logits_t.detach(), FWD_TOL, "logits")
        loss_j, grads_j = jax.value_and_grad(_vad_loss_jax(jfwd, jnp.asarray(labels)))(
            jp, jnp.asarray(feats))
        loss_t = F.binary_cross_entropy_with_logits(logits_t, torch.tensor(labels))
        stats_j = {}
    else:
        if arch == "mlp":
            def jfwd(p, f):
                return jspk.embed_jax(p, f), {}
            emb_t = tspk.embed_torch(tp, tf)
        else:
            def jfwd(p, f):
                return jws.embed_jax(p, f, train=True)
            emb_t, stats_t = tws.embed_torch(tp, tf, train=True)
            # eval mode too: the running statistics, as embed_np uses them
            ej, _ = jws.embed_jax(jp, jnp.asarray(feats), train=False)
            et, none = tws.embed_torch(tp, tf, train=False)
            _close(ej, et.detach(), FWD_TOL, "eval-mode embedding")
            assert none == {}
            _close(jws.embed_np(params, feats[0]), et[0].detach(), FWD_TOL, "embed_np")
        emb_j, _ = jfwd(jp, jnp.asarray(feats))
        _close(emb_j, emb_t.detach(), FWD_TOL, "embedding")
        (loss_j, stats_j), grads_j = jax.value_and_grad(
            _speaker_loss_jax(jfwd, jnp.asarray(labels)), has_aux=True)(jp, jnp.asarray(feats))
        loss_t = _speaker_loss_torch(emb_t, tp["wc"], torch.tensor(labels))
    _close(loss_j, loss_t.detach(), FWD_TOL, "loss")
    loss_t.backward()
    for k, g in grads_j.items():
        got = tp[k].grad
        if got is None:  # no path to the loss: JAX's zero gradient
            assert not np.asarray(g).any(), k
            continue
        _close(g, got, FWD_TOL, f"grad {k}")
    assert set(stats_t) == set(stats_j)
    for k, v in stats_j.items():
        assert not stats_t[k].requires_grad
        _close(v, stats_t[k], FWD_TOL, f"EMA {k}")
    if arch == "resnet":
        assert len(stats_j) == 2 * sum(k.endswith("_g") for k in params)


def _reference_script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("script,port,arch", [
    ("train_vad", train_vad, "gru"),
    ("train_vad", train_vad, "silero"),
    ("train_speaker", train_speaker, "mlp"),
    ("train_speaker", train_speaker, "resnet"),
])
def test_three_steps_match_the_reference_script(tmp_path, monkeypatch, script, port, arch):
    argv = ["--arch", arch, "--steps", "3", "--batch", "4", "--seed", "3"]
    if script == "train_speaker":
        argv += ["--n_speakers", "16"]
    ref_out, out = tmp_path / "ref.npz", tmp_path / "port.npz"
    monkeypatch.setattr(sys, "argv", [script] + argv + ["--out", str(ref_out)])
    _reference_script(script).main()
    result = port.run(argv + ["--out", str(out), "--device", "cpu"])
    ref, got = np.load(ref_out), np.load(out)
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        assert ref[k].shape == got[k].shape, k
        err = float(np.abs(ref[k] - got[k]).max())
        assert err <= TRAIN_TOL, f"{k}: {err}"
    assert len(result["losses"]) == 3 and np.isfinite(result["losses"]).all()
    assert result["out"] == str(out)
    assert sorted(result["params"]) == sorted(ref.files)


def test_trainers_default_to_the_ports_shipped_weights(monkeypatch):
    """Without --out each trainer writes the port's own weight file of its
    arch (here intercepted: nothing is written)."""
    saved = []
    for mod in (train_vad, train_speaker):
        monkeypatch.setattr(mod.np, "savez", lambda path, **kw: saved.append(path))
    monkeypatch.setattr(train_vad, "evaluate", lambda *a, **kw: (0.5, 0.5, 0.5))
    monkeypatch.setattr(train_speaker, "evaluate", lambda *a, **kw: ((0.5, 0.5), (0.5, 0.5)))
    for arch in ("gru", "silero"):
        train_vad.main(["--arch", arch, "--steps", "0", "--device", "cpu"])
    for arch in ("mlp", "resnet"):
        train_speaker.main(["--arch", arch, "--steps", "0", "--device", "cpu"])
    assert saved == [tvad.WEIGHTS_PATH, tsilero.WEIGHTS_PATH, tspk.WEIGHTS_PATH,
                     tws.WEIGHTS_PATH]
    assert all("whisperlive_tpu_torch" in p for p in saved)
