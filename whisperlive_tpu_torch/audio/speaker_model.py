"""Learned speaker embedder for online diarization.

The reference embeds segments with a pyannote checkpoint downloaded at
runtime (whisper_live/diarization.py:79-124) — unavailable offline. This is
a small self-contained embedder trained on synthetic voices
(scripts/train_speaker.py): per-frame log-mel-band features -> frame MLP ->
mean+std pooling -> linear projection -> L2-normalized embedding. Trained
as a speaker classifier over many synthetic voice profiles; the classifier
head is dropped and the projection output is the embedding.

Inference is pure numpy (host-side, called per committed segment). The
port's copy of whisperlive_tpu/audio/speaker_model.py; its training
forward, `embed_torch`, serves cli/train_speaker.py. Weights ship
in-repo (~100 KB). The diarizer's clustering semantics (cosine threshold 0.55, EMA 0.9) are unchanged — this only
replaces the weight-free spectral stand-in with a representation that
separates same-gender voices.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

SAMPLE_RATE = 16_000
FRAME = 400
HOP = 160
N_BANDS = 40
HIDDEN = 96
EMB_DIM = 64

WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "speaker_weights.npz")

_FB = None


def _band_matrix() -> np.ndarray:
    global _FB
    if _FB is not None:
        return _FB
    n_freqs = FRAME // 2 + 1
    freqs = np.linspace(0, SAMPLE_RATE / 2, n_freqs)
    mel = 2595 * np.log10(1 + freqs / 700)
    edges = np.linspace(mel[1], mel[-1], N_BANDS + 2)
    fb = np.zeros((n_freqs, N_BANDS), np.float32)
    for b in range(N_BANDS):
        lo, mid, hi = edges[b], edges[b + 1], edges[b + 2]
        up = (mel - lo) / max(mid - lo, 1e-6)
        down = (hi - mel) / max(hi - mid, 1e-6)
        fb[:, b] = np.clip(np.minimum(up, down), 0, 1)
    _FB = fb
    return fb


def extract_features(audio: np.ndarray) -> np.ndarray:
    """[n] f32 -> [T, N_BANDS] log band energies (voiced frames only)."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    n = (len(audio) - FRAME) // HOP + 1
    if n < 2:
        return np.zeros((0, N_BANDS), np.float32)
    idx = np.arange(FRAME)[None, :] + HOP * np.arange(n)[:, None]
    frames = audio[idx] * np.hanning(FRAME)[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    # keep frames with real signal — silence carries no speaker identity
    energy = spec.sum(axis=1)
    keep = energy > max(float(np.median(energy)) * 0.25, 1e-10)
    if keep.sum() >= 2:
        spec = spec[keep]
    feats = np.log(spec @ _band_matrix() + 1e-10).astype(np.float32)
    # per-utterance mean normalization: removes channel gain, keeps shape
    return feats - feats.mean(axis=0, keepdims=True)


def init_speaker_params(seed: int = 0, n_classes: int = 256) -> dict:
    rng = np.random.default_rng(seed)

    def glorot(shape):
        lim = np.sqrt(6.0 / (shape[0] + shape[1]))
        return rng.uniform(-lim, lim, shape).astype(np.float32)

    return {
        "w1": glorot((N_BANDS, HIDDEN)),
        "b1": np.zeros(HIDDEN, np.float32),
        "w2": glorot((HIDDEN, HIDDEN)),
        "b2": np.zeros(HIDDEN, np.float32),
        "wp": glorot((2 * HIDDEN, EMB_DIM)),
        "bp": np.zeros(EMB_DIM, np.float32),
        "wc": glorot((EMB_DIM, n_classes)),  # classifier head (training only)
    }


def embed_np(params: dict, feats: np.ndarray) -> np.ndarray:
    """[T, N_BANDS] -> [EMB_DIM] L2-normalized (numpy inference)."""
    if feats.shape[0] == 0:
        return np.zeros(EMB_DIM, np.float32)
    h = np.maximum(feats @ params["w1"] + params["b1"], 0.0)
    h = np.maximum(h @ params["w2"] + params["b2"], 0.0)
    pooled = np.concatenate([h.mean(axis=0), h.std(axis=0)])
    emb = pooled @ params["wp"] + params["bp"]
    norm = np.linalg.norm(emb)
    return (emb / norm if norm > 0 else emb).astype(np.float32)


def embed_torch(params: dict, feats, std_eps: float = 1e-6):
    """[B, T, N_BANDS] -> [B, EMB_DIM] (training forward; torch).
    std_eps=0 pools with the plain std, as embed_np does (inference)."""
    import torch

    # torch.maximum, not relu: at 0 its gradient splits in halves, as
    # jnp.maximum's does (a zero-padded frame sits exactly there at init)
    zero = feats.new_zeros(())
    h = torch.maximum(feats @ params["w1"] + params["b1"], zero)
    h = torch.maximum(h @ params["w2"] + params["b2"], zero)
    # sqrt(var + eps): a plain std has an infinite gradient at zero
    # variance (padded frames), which NaNs training
    std = torch.sqrt(h.var(dim=1, unbiased=False) + std_eps)
    pooled = torch.cat([h.mean(dim=1), std], dim=-1)
    emb = pooled @ params["wp"] + params["bp"]
    return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-8)


def weights_available() -> bool:
    return os.path.exists(WEIGHTS_PATH)


class LearnedSpeakerEmbedder:
    """Drop-in embedder for SpeakerDiarizer(embedder=...)."""

    def __init__(self, params: Optional[dict] = None):
        if params is None:
            params = dict(np.load(WEIGHTS_PATH))
        self.params = params

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        return embed_np(self.params, extract_features(audio))
