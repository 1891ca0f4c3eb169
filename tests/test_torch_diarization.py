"""The port's diarization and speaker embedders against the JAX package's.

The cases of tests/test_diarization.py and tests/test_wespeaker.py run on
the port's modules (diarization.py, audio/speaker_model.py,
audio/wespeaker.py), all but the two that run the JAX training forward
`embed_jax`, which the port does not carry. Then the port against the JAX
package on the same audio: every embedder's vectors within 1e-6, the
diarizer's labels equal over a sequence of segments (streaming and quality
embedders, named enrollment, the max_speakers cap), and the shipped weight
files byte-equal.
"""

import filecmp
import os
import sys

import numpy as np
import pytest

from whisperlive_tpu import diarization as jdiarization
from whisperlive_tpu.audio import speaker_model as jsm
from whisperlive_tpu.audio import wespeaker as jws
from whisperlive_tpu_torch import diarization as tdiarization
from whisperlive_tpu_torch.audio import speaker_model as tsm
from whisperlive_tpu_torch.audio import wespeaker as ws
from whisperlive_tpu_torch.diarization import SpeakerDiarizer, SpectralEmbedder

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))


def make_embedder(table):
    """Embedder double: maps audio 'key' (first sample value) to a vector."""

    def embed(audio):
        key = int(round(float(audio[0]) * 10))
        v = np.asarray(table[key], np.float32)
        return v / np.linalg.norm(v)

    return embed


def audio_for(key, seconds=1.0):
    a = np.zeros(int(seconds * 16000), np.float32)
    a[0] = key / 10.0
    return a


TABLE = {
    1: [1.0, 0.0, 0.0],
    2: [0.95, 0.3, 0.0],  # close to speaker 1
    3: [0.0, 1.0, 0.0],  # orthogonal: new speaker
    4: [0.0, 0.0, 1.0],
}


def test_new_speaker_then_match():
    d = SpeakerDiarizer(max_speakers=4, embedder=make_embedder(TABLE))
    assert d.identify_speaker(audio_for(1)) == "SPEAKER_0"
    assert d.identify_speaker(audio_for(2)) == "SPEAKER_0"  # cosine ~0.95
    assert d.identify_speaker(audio_for(3)) == "SPEAKER_1"
    assert d.identify_speaker(audio_for(1)) == "SPEAKER_0"


def test_max_speakers_cap():
    d = SpeakerDiarizer(max_speakers=2, embedder=make_embedder(TABLE))
    d.identify_speaker(audio_for(1))
    d.identify_speaker(audio_for(3))
    # a third distinct voice snaps to the nearest existing cluster
    label = d.identify_speaker(audio_for(4))
    assert label in ("SPEAKER_0", "SPEAKER_1")


def test_min_audio_length():
    d = SpeakerDiarizer(embedder=make_embedder(TABLE))
    assert d.identify_speaker(np.zeros(100, np.float32)) is None


def test_named_enrollment():
    d = SpeakerDiarizer(embedder=make_embedder(TABLE))
    assert d.enroll_speaker("alice", audio_for(1))
    assert d.identify_speaker(audio_for(2)) == "alice"
    assert d.identify_speaker(audio_for(3)) == "SPEAKER_1"


def test_reset():
    d = SpeakerDiarizer(embedder=make_embedder(TABLE))
    d.identify_speaker(audio_for(1))
    d.reset()
    assert d.speakers == []
    assert d.identify_speaker(audio_for(3)) == "SPEAKER_0"


def test_ema_update_drifts_centroid():
    d = SpeakerDiarizer(embedder=make_embedder(TABLE))
    d.identify_speaker(audio_for(1))
    before = d.speakers[0].copy()
    d.identify_speaker(audio_for(2))
    assert not np.allclose(before, d.speakers[0])


def test_spectral_embedder_separates_timbres():
    """Different harmonic structures should be less similar than identical
    ones (sanity check of the weight-free default embedder)."""
    rng = np.random.default_rng(0)
    t = np.arange(32000) / 16000

    def voice(f0, tilt):
        sig = sum(
            (1.0 / (k**tilt)) * np.sin(2 * np.pi * f0 * k * t + rng.random())
            for k in range(1, 12)
        )
        return (0.2 * sig / np.abs(sig).max()).astype(np.float32)

    e = SpectralEmbedder()
    low_a, low_b = e(voice(110, 1.0)), e(voice(118, 1.0))
    high = e(voice(340, 2.5))
    sim_same = float(np.dot(low_a, low_b))
    sim_diff = float(np.dot(low_a, high))
    assert sim_same > sim_diff


def test_session_integration_speaker_field():
    from types import SimpleNamespace

    from whisperlive_tpu_torch.serving.session import StreamingSession

    d = SpeakerDiarizer(embedder=make_embedder(TABLE))
    sess = StreamingSession(speaker_identifier=d.make_identifier())
    sess.add_frames(audio_for(1, seconds=5.0))
    sess.update_segments(
        [
            SimpleNamespace(start=0.0, end=2.0, text=" hi", no_speech_prob=0.0, words=None),
            SimpleNamespace(start=2.0, end=3.0, text=" there", no_speech_prob=0.0, words=None),
        ],
        duration=3.0,
    )
    assert sess.transcript[0]["speaker"] == "SPEAKER_0"


def _synth_voice_pair():
    """Two same-register synthetic speakers (same f0/tilt, different formant
    envelopes) — the confusion case the learned embedder exists for."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    from train_speaker import synth_utterance

    base = dict(f0=120.0, tilt=1.0, jitter=0.015, vibrato=0.005, breath=0.02)
    pa = dict(base, formants=[(450, 90), (1400, 150), (2600, 200)])
    pb = dict(base, formants=[(700, 90), (1900, 150), (3100, 200)])
    return pa, pb, synth_utterance


def test_learned_embedder_is_default_and_ships():
    from whisperlive_tpu_torch.audio.speaker_model import (
        LearnedSpeakerEmbedder,
        weights_available,
    )
    from whisperlive_tpu_torch.diarization import _default_embedder

    assert weights_available(), "speaker_weights.npz must ship in the repo"
    assert isinstance(_default_embedder(), LearnedSpeakerEmbedder)


def test_learned_embedder_separates_same_gender_voices():
    """Same-f0 voices: spectral confuses them (sim > threshold), learned
    must keep same-speaker sim above and cross-speaker sim below 0.55
    (VERDICT r1 missing #6 / next #8)."""
    from whisperlive_tpu_torch.audio.speaker_model import LearnedSpeakerEmbedder

    pa, pb, synth = _synth_voice_pair()
    rng = np.random.default_rng(42)
    learned = LearnedSpeakerEmbedder()
    spectral = SpectralEmbedder()
    same_l, diff_l, diff_s = [], [], []
    for _ in range(6):
        a1, a2, b1 = synth(rng, pa), synth(rng, pa), synth(rng, pb)
        same_l.append(float(learned(a1) @ learned(a2)))
        diff_l.append(float(learned(a1) @ learned(b1)))
        diff_s.append(float(spectral(a1) @ spectral(b1)))
    assert np.mean(same_l) > 0.7
    assert np.mean(diff_l) < 0.3
    # the spectral stand-in genuinely confuses this pair (above threshold),
    # demonstrating the learned model is load-bearing
    assert np.mean(diff_s) > 0.55


def test_learned_diarizer_clusters_hard_pair():
    pa, pb, synth = _synth_voice_pair()
    rng = np.random.default_rng(7)
    d = SpeakerDiarizer(max_speakers=4)  # default = learned embedder
    labels_a = [d.identify_speaker(synth(rng, pa)) for _ in range(3)]
    labels_b = [d.identify_speaker(synth(rng, pb)) for _ in range(3)]
    assert len(set(labels_a)) == 1
    assert len(set(labels_b)) == 1
    assert set(labels_a) != set(labels_b)


def test_learned_embedder_survives_channel_mismatch():
    """Same speaker through two DIFFERENT channels (reverb/noise/EQ) must
    still match above the clustering threshold, and different speakers
    through the same channel must stay apart — the real-world test
    (recording mismatch dominates voice similarity). Trained with
    per-utterance channel augmentation + AAM margin (round 3)."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    from train_speaker import apply_channel, make_profile, synth_utterance

    from whisperlive_tpu_torch.audio.speaker_model import LearnedSpeakerEmbedder

    rng = np.random.default_rng(5)
    emb = LearnedSpeakerEmbedder()
    pa, pb = make_profile(rng), make_profile(rng)
    a1 = emb(apply_channel(rng, synth_utterance(rng, pa)))
    a2 = emb(apply_channel(rng, synth_utterance(rng, pa)))
    b1 = emb(apply_channel(rng, synth_utterance(rng, pb)))
    same = float(a1 @ a2)
    diff = max(float(a1 @ b1), float(a2 @ b1))
    assert same > 0.55, same  # clustering threshold (diarization.py)
    assert same > diff + 0.1, (same, diff)


def _rand_params(seed, cfg=ws.LITE):
    rng = np.random.default_rng(seed)
    p = ws.init_wespeaker_params(cfg, seed)
    # perturb BN stats/affines so eval-mode parity is meaningful
    for k in list(p):
        if k.endswith("_m"):
            p[k] = (rng.standard_normal(p[k].shape) * 0.1).astype(np.float32)
        elif k.endswith("_v"):
            p[k] = (1 + 0.3 * rng.random(p[k].shape)).astype(np.float32)
        elif k.endswith("_g") or k.endswith("_b") and p[k].ndim == 1:
            p[k] = (1 + 0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p


def test_config_roundtrip_and_shapes():
    assert ws.config_of(ws.init_wespeaker_params(ws.LITE)) == ws.LITE
    assert ws.R34.channels == (32, 64, 128, 256)
    assert ws.R34.blocks == (3, 4, 6, 3)
    assert ws.R34.emb_dim == 256
    # 80 mel bins through three stride-2 stages -> 10; TSTP doubles
    assert ws.R34.pool_dim == 2 * 256 * 10


def test_onnx_roundtrip_torch_export_layout(tmp_path):
    """load_wespeaker_onnx must reconstruct the model from tensors in a
    torch ONNX export's layout and naming (conv [C_out,C_in,kh,kw]; BN as
    weight/bias/running_mean/running_var; linear [out,in]) — the ingestion
    path for a real wespeaker-voxceleb-resnet34-LM export."""
    from conftest import write_onnx_file

    p = _rand_params(5)
    cfg = ws.config_of(p)
    tensors = []

    def emit_bn(torch_name, prefix):
        tensors.append((f"{torch_name}.weight", p[f"{prefix}_g"]))
        tensors.append((f"{torch_name}.bias", p[f"{prefix}_b"]))
        tensors.append((f"{torch_name}.running_mean", p[f"{prefix}_m"]))
        tensors.append((f"{torch_name}.running_var", p[f"{prefix}_v"]))

    def to_onnx_conv(w):
        # TRUE wespeaker export layout: the torch model runs on
        # [B, C, F(height), T(width)], so the ONNX kernel is
        # [C_out, C_in, kh=FREQ, kw=TIME]; ours is [kh=T, kw=F, Ci, Co].
        return np.transpose(w, (3, 2, 1, 0))

    tensors.append(("front.conv1.weight", to_onnx_conv(p["stem_w"])))
    emit_bn("front.bn1", "stem_bn")
    for name, _ci, _co, _st, ds in ws._block_specs(cfg):
        tensors.append((f"front.{name}.conv1.weight", to_onnx_conv(p[f"{name}_c1_w"])))
        emit_bn(f"front.{name}.bn1", f"{name}_bn1")
        tensors.append((f"front.{name}.conv2.weight", to_onnx_conv(p[f"{name}_c2_w"])))
        emit_bn(f"front.{name}.bn2", f"{name}_bn2")
        if ds:
            tensors.append(
                (f"front.{name}.downsample.0.weight", to_onnx_conv(p[f"{name}_ds_w"]))
            )
            emit_bn(f"front.{name}.downsample.1", f"{name}_dsbn")
    # torch Linear [out, in] over wespeaker's CHANNEL-major pooled layout:
    # scatter our freq-major rows to their wespeaker positions first
    perm = ws.pool_permutation(cfg)
    onnx_rows = np.empty_like(p["emb_w"])
    onnx_rows[perm] = p["emb_w"]
    tensors.append(("seg_1.weight", onnx_rows.T))
    tensors.append(("seg_1.bias", p["emb_b"]))

    path = str(tmp_path / "wespeaker.onnx")
    write_onnx_file(path, tensors)
    loaded = ws.load_wespeaker_onnx(path, cfg)
    for k in p:
        np.testing.assert_allclose(loaded[k], p[k], atol=1e-6, err_msg=k)

    # and the ingested model embeds identically
    audio = (np.random.default_rng(6).standard_normal(16000) * 0.1).astype(
        np.float32
    )
    a = ws.WeSpeakerEmbedder(p)(audio)
    b = ws.WeSpeakerEmbedder(loaded)(audio)
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_onnx_roundtrip_anonymous_names(tmp_path):
    """Same graph as the torch-layout roundtrip but with STRIPPED
    initializer names (`onnx::Conv_N` / bare numbers, as newer torch
    exporters emit) — ingestion must fall back to pure graph order +
    shape signatures, with BN roles filled in the ONNX
    BatchNormalization input order (scale, B, mean, var)."""
    from conftest import write_onnx_file

    p = _rand_params(7)
    cfg = ws.config_of(p)
    tensors = []
    counter = [0]

    def nm(kind):
        counter[0] += 1
        return (f"onnx::{kind}_{counter[0]}" if counter[0] % 2
                else str(1000 + counter[0]))

    def emit_bn(prefix):
        # ONNX BatchNormalization input order: scale, B, input_mean, input_var
        for role in ("g", "b", "m", "v"):
            tensors.append((nm("BatchNormalization"), p[f"{prefix}_{role}"]))

    def to_onnx_conv(w):
        return np.transpose(w, (3, 2, 1, 0))

    tensors.append((nm("Conv"), to_onnx_conv(p["stem_w"])))
    emit_bn("stem_bn")
    for name, _ci, _co, _st, ds in ws._block_specs(cfg):
        tensors.append((nm("Conv"), to_onnx_conv(p[f"{name}_c1_w"])))
        emit_bn(f"{name}_bn1")
        tensors.append((nm("Conv"), to_onnx_conv(p[f"{name}_c2_w"])))
        emit_bn(f"{name}_bn2")
        if ds:
            tensors.append((nm("Conv"), to_onnx_conv(p[f"{name}_ds_w"])))
            emit_bn(f"{name}_dsbn")
    perm = ws.pool_permutation(cfg)
    onnx_rows = np.empty_like(p["emb_w"])
    onnx_rows[perm] = p["emb_w"]
    tensors.append((nm("MatMul"), onnx_rows.T))
    tensors.append((nm("Add"), p["emb_b"]))

    path = str(tmp_path / "wespeaker_anon.onnx")
    write_onnx_file(path, tensors)
    loaded = ws.load_wespeaker_onnx(path, cfg)
    for k in p:
        np.testing.assert_allclose(loaded[k], p[k], atol=1e-6, err_msg=k)


def test_onnx_wrong_family_raises_with_inventory(tmp_path):
    from conftest import write_onnx_file

    path = str(tmp_path / "bad.onnx")
    write_onnx_file(path, [("x", np.zeros((3, 3), np.float32))])
    with pytest.raises(ValueError, match="inventory"):
        ws.load_wespeaker_onnx(path, ws.LITE)


@pytest.mark.skipif(not ws.weights_available(), reason="weights not shipped")
def test_shipped_weights_verification_quality(monkeypatch):
    """Held-out synthetic speakers through mismatched channels: the shipped
    wespeaker-lite weights must separate them clearly (AUC) and beat the
    spectral stand-in — published by scripts/train_speaker.py --arch
    resnet."""
    import whisperlive_tpu.audio.wespeaker as jws
    import whisperlive_tpu.diarization as jdiar
    from train_speaker import evaluate

    # evaluate() imports its embedders from the JAX package: hand it the port's
    monkeypatch.setattr(jws, "WeSpeakerEmbedder", ws.WeSpeakerEmbedder)
    monkeypatch.setattr(jdiar, "SpectralEmbedder", SpectralEmbedder)
    data = np.load(ws.WEIGHTS_PATH)
    p = {k: data[k] for k in data.files}
    (auc_l, eer_l), (auc_s, _eer_s) = evaluate(
        p, seed=20260817, n_speakers=12, n_utt=3, channel=True, arch="resnet"
    )
    assert auc_l > 0.93, (auc_l, eer_l)
    assert auc_l > auc_s


@pytest.mark.skipif(not ws.weights_available(), reason="weights not shipped")
def test_quality_default_embedder_selection():
    """quality=True (REST/offline) selects the wespeaker embedder;
    streaming default stays the cheap learned MLP; WL_SPEAKER forces."""
    from whisperlive_tpu_torch.audio.speaker_model import LearnedSpeakerEmbedder
    from whisperlive_tpu_torch.diarization import _default_embedder

    assert isinstance(_default_embedder(quality=True), ws.WeSpeakerEmbedder)
    assert isinstance(_default_embedder(quality=False), LearnedSpeakerEmbedder)
    os.environ["WL_SPEAKER"] = "wespeaker"
    try:
        assert isinstance(_default_embedder(quality=False), ws.WeSpeakerEmbedder)
    finally:
        del os.environ["WL_SPEAKER"]


def test_torch_oracle_parity(tmp_path):
    """Cross-implementation oracle: a REAL torch ResNet running wespeaker's
    semantics ([B, 1, F(height), T(width)] convs, channel-major TSTP,
    Linear head) is exported in torch state_dict layout, ingested by
    load_wespeaker_onnx, and embed_np must reproduce the torch embedding —
    the axis-orientation proof the self-consistent roundtrip can't give."""
    import torch
    import torch.nn as nn

    from conftest import write_onnx_file

    torch.manual_seed(0)
    cfg = ws.LITE

    class Block(nn.Module):
        def __init__(self, c_in, c_out, stride, ds):
            super().__init__()
            self.conv1 = nn.Conv2d(c_in, c_out, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(c_out)
            self.conv2 = nn.Conv2d(c_out, c_out, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(c_out)
            self.ds = (
                nn.Sequential(
                    nn.Conv2d(c_in, c_out, 1, stride, bias=False),
                    nn.BatchNorm2d(c_out),
                )
                if ds
                else None
            )

        def forward(self, x):
            y = torch.relu(self.bn1(self.conv1(x)))
            y = self.bn2(self.conv2(y))
            sc = self.ds(x) if self.ds is not None else x
            return torch.relu(y + sc)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = nn.Conv2d(1, cfg.channels[0], 3, 1, 1, bias=False)
            self.stem_bn = nn.BatchNorm2d(cfg.channels[0])
            self.blocks = nn.ModuleList(
                Block(ci, co, st, ds)
                for _name, ci, co, st, ds in ws._block_specs(cfg)
            )
            self.head = nn.Linear(cfg.pool_dim, cfg.emb_dim)

        def forward(self, feats):  # feats [T, 80]
            x = feats.T[None, None]  # [1, 1, F, T] — wespeaker layout
            x = torch.relu(self.stem_bn(self.stem(x)))
            for b in self.blocks:
                x = b(x)
            bsz, c, f, t = x.shape
            flat = x.reshape(bsz, c * f, t)  # CHANNEL-major pooling rows
            pooled = torch.cat([flat.mean(-1), flat.std(-1, unbiased=False)], -1)
            emb = self.head(pooled)[0]
            return emb / emb.norm()

    net = Net().eval()
    # non-trivial BN running stats (fresh BNs have mean=0, var=1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)

    # export in the torch-name layout the ingester expects
    tensors = []

    def emit_bn(tname, bn):
        tensors.append((f"{tname}.weight", bn.weight.detach().numpy()))
        tensors.append((f"{tname}.bias", bn.bias.detach().numpy()))
        tensors.append((f"{tname}.running_mean", bn.running_mean.numpy()))
        tensors.append((f"{tname}.running_var", bn.running_var.numpy()))

    tensors.append(("front.conv1.weight", net.stem.weight.detach().numpy()))
    emit_bn("front.bn1", net.stem_bn)
    for (name, *_), blk in zip(ws._block_specs(cfg), net.blocks):
        tensors.append((f"front.{name}.conv1.weight",
                        blk.conv1.weight.detach().numpy()))
        emit_bn(f"front.{name}.bn1", blk.bn1)
        tensors.append((f"front.{name}.conv2.weight",
                        blk.conv2.weight.detach().numpy()))
        emit_bn(f"front.{name}.bn2", blk.bn2)
        if blk.ds is not None:
            tensors.append((f"front.{name}.downsample.0.weight",
                            blk.ds[0].weight.detach().numpy()))
            emit_bn(f"front.{name}.downsample.1", blk.ds[1])
    tensors.append(("seg_1.weight", net.head.weight.detach().numpy()))
    tensors.append(("seg_1.bias", net.head.bias.detach().numpy()))

    path = str(tmp_path / "torch_oracle.onnx")
    write_onnx_file(path, tensors)
    loaded = ws.load_wespeaker_onnx(path, cfg)

    audio = (np.random.default_rng(3).standard_normal(16000) * 0.1).astype(
        np.float32
    )
    feats = ws.fbank(audio)
    with torch.no_grad():
        ref = net(torch.from_numpy(feats)).numpy()
    ours = ws.embed_np(loaded, feats)
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------


def _utterances():
    pa, pb, synth = _synth_voice_pair()
    rng = np.random.default_rng(11)
    clips = [synth(rng, pa), synth(rng, pb), synth(rng, pa), synth(rng, pb)]
    t = np.arange(24000) / 16000.0
    clips.append((0.1 * np.sin(2 * np.pi * 220 * t)).astype(np.float32))
    clips.append(np.zeros(4000, np.float32))  # too short for two frames
    return clips


@pytest.mark.parametrize("kind", ["spectral", "mlp", "wespeaker"])
def test_embedder_vectors_match_jax(kind):
    pairs = {
        "spectral": (SpectralEmbedder(), jdiarization.SpectralEmbedder()),
        "mlp": (tsm.LearnedSpeakerEmbedder(), jsm.LearnedSpeakerEmbedder()),
        "wespeaker": (ws.WeSpeakerEmbedder(), jws.WeSpeakerEmbedder()),
    }
    ours, ref = pairs[kind]
    for clip in _utterances():
        a, b = ours(clip), ref(clip)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_features_and_forwards_match_jax():
    audio = _utterances()[0]
    np.testing.assert_array_equal(tsm.extract_features(audio), jsm.extract_features(audio))
    np.testing.assert_array_equal(ws.fbank(audio), jws.fbank(audio))
    p = _rand_params(9)
    feats = np.random.default_rng(10).standard_normal((61, 80)).astype(np.float32)
    np.testing.assert_allclose(ws.embed_np(p, feats), jws.embed_np(p, feats), atol=1e-6)
    assert ws.config_of(p) == ws.LITE and jws.config_of(p) == jws.LITE
    np.testing.assert_array_equal(ws.pool_permutation(ws.R34), jws.pool_permutation(jws.R34))
    for seed in (0, 3):
        for k, v in tsm.init_speaker_params(seed).items():
            np.testing.assert_array_equal(v, jsm.init_speaker_params(seed)[k])


@pytest.mark.parametrize("quality", [False, True])
def test_diarizer_labels_match_jax(quality, monkeypatch):
    monkeypatch.delenv("WL_SPEAKER", raising=False)
    clips = _utterances()
    ours = SpeakerDiarizer(max_speakers=3, quality=quality)
    ref = jdiarization.SpeakerDiarizer(max_speakers=3, quality=quality)
    assert type(ours._embedder).__name__ == type(ref._embedder).__name__
    assert ours.enroll_speaker("alice", clips[0]) == ref.enroll_speaker("alice", clips[0])
    got, want = [], []
    for clip in clips[1:] + clips[::-1] + clips:
        got.append(ours.identify_speaker(clip))
        want.append(ref.identify_speaker(clip))
    assert got == want
    assert "alice" in got and len(set(got) - {None}) >= 2
    np.testing.assert_allclose(np.stack(ours.speakers), np.stack(ref.speakers), atol=1e-6)

    ident_t, ident_j = ours.make_identifier(), ref.make_identifier()
    frames = np.concatenate(clips[:2])
    for start, end in ((0.0, 1.0), (1.2, 2.9), (0.0, 0.1)):
        assert ident_t(frames, start, end) == ident_j(frames, start, end)


@pytest.mark.parametrize("forced", ["spectral", "mlp", "wespeaker"])
def test_default_embedder_switch_matches_jax(forced, monkeypatch):
    monkeypatch.setenv("WL_SPEAKER", forced)
    for quality in (False, True):
        assert type(tdiarization._default_embedder(quality)).__name__ == \
            type(jdiarization._default_embedder(quality)).__name__


def test_missing_weights_fall_through_as_jax(monkeypatch, tmp_path):
    """wespeaker -> mlp -> spectral when weight files are missing."""
    monkeypatch.delenv("WL_SPEAKER", raising=False)
    monkeypatch.setattr(ws, "WEIGHTS_PATH", str(tmp_path / "none.npz"))
    assert isinstance(tdiarization._default_embedder(True), tsm.LearnedSpeakerEmbedder)
    monkeypatch.setattr(tsm, "WEIGHTS_PATH", str(tmp_path / "none.npz"))
    assert isinstance(tdiarization._default_embedder(True), SpectralEmbedder)
    assert isinstance(tdiarization._default_embedder(False), SpectralEmbedder)


@pytest.mark.parametrize("name", ["speaker_weights.npz", "wespeaker_weights.npz"])
def test_weight_files_byte_equal(name):
    ours = os.path.join(os.path.dirname(ws.__file__), name)
    ref = os.path.join(os.path.dirname(jws.__file__), name)
    assert filecmp.cmp(ours, ref, shallow=False)
