"""Learned streaming VAD: a tiny GRU over spectral band features.

The reference gates audio with silero VAD, whose ONNX weights it downloads
at runtime (whisper_live/vad.py:111-128) — not an option in an offline
deployment. This module provides the same streaming contract with a
self-contained model: 512-sample windows -> 26 spectral features -> GRU(32)
-> P(speech), trained on synthetic speech-like audio (harmonic stacks with
formant resonances and syllabic amplitude modulation) against noise, tones,
chirps and clicks (scripts/train_vad.py). Weights ship in-repo (~30 KB
.npz); `audio/vad.py` uses this model when the weight file exists and falls
back to the energy heuristic otherwise.

Inference is pure numpy (the host gate must not touch the device). The
port's copy of whisperlive_tpu/audio/vad_model.py keeps inference only:
training stays with the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

WINDOW = 512
N_BANDS = 24
N_FEATS = N_BANDS + 2  # + log total energy + spectral flatness
HIDDEN = 32

WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "vad_weights.npz")

_BAND_EDGES = None


def _band_matrix() -> np.ndarray:
    """[257, N_BANDS] triangular mel-spaced pooling matrix for 512-pt rfft."""
    global _BAND_EDGES
    if _BAND_EDGES is not None:
        return _BAND_EDGES
    n_freqs = WINDOW // 2 + 1
    freqs = np.linspace(0, 8000, n_freqs)
    mel = 2595 * np.log10(1 + freqs / 700)
    edges = np.linspace(mel[1], mel[-1], N_BANDS + 2)
    fb = np.zeros((n_freqs, N_BANDS), np.float32)
    for b in range(N_BANDS):
        lo, mid, hi = edges[b], edges[b + 1], edges[b + 2]
        up = (mel - lo) / max(mid - lo, 1e-6)
        down = (hi - mel) / max(hi - mid, 1e-6)
        fb[:, b] = np.clip(np.minimum(up, down), 0, 1)
    _BAND_EDGES = fb
    return fb


def extract_features(audio: np.ndarray) -> np.ndarray:
    """[T*512] float32 -> [T, N_FEATS] per-window features."""
    n = len(audio) // WINDOW
    if n == 0:
        return np.zeros((0, N_FEATS), np.float32)
    frames = audio[: n * WINDOW].reshape(n, WINDOW) * np.hanning(WINDOW)[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2  # [T, 257]
    bands = spec @ _band_matrix()  # [T, N_BANDS]
    log_bands = np.log(bands + 1e-8)
    total = np.log(spec.sum(axis=1) + 1e-8)[:, None]
    p = spec[:, 1:] + 1e-10
    flat = (np.exp(np.mean(np.log(p), axis=1)) / np.mean(p, axis=1))[:, None]
    feats = np.concatenate([log_bands, total, flat], axis=1).astype(np.float32)
    # normalize the log features to a stable range
    feats[:, : N_BANDS + 1] = (feats[:, : N_BANDS + 1] + 8.0) / 10.0
    return feats


def init_vad_params(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def glorot(shape):
        lim = np.sqrt(6.0 / sum(shape))
        return rng.uniform(-lim, lim, shape).astype(np.float32)

    return {
        "gru_wx": glorot((N_FEATS, 3 * HIDDEN)),
        "gru_wh": glorot((HIDDEN, 3 * HIDDEN)),
        "gru_b": np.zeros((3 * HIDDEN,), np.float32),
        "out_w": glorot((HIDDEN, 1)),
        "out_b": np.zeros((1,), np.float32),
    }


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(np.clip(-x, -60.0, 60.0)))


def gru_step_np(params: dict, h: np.ndarray, x: np.ndarray) -> np.ndarray:
    """One GRU step in numpy. h [H], x [N_FEATS] -> new h."""
    gates_x = x @ params["gru_wx"] + params["gru_b"]
    gates_h = h @ params["gru_wh"]
    r = _sigmoid(gates_x[:HIDDEN] + gates_h[:HIDDEN])
    z = _sigmoid(gates_x[HIDDEN: 2 * HIDDEN] + gates_h[HIDDEN: 2 * HIDDEN])
    n = np.tanh(gates_x[2 * HIDDEN:] + r * gates_h[2 * HIDDEN:])
    return (1 - z) * n + z * h


class LearnedVAD:
    """Streaming speech-probability model (numpy inference)."""

    def __init__(self, params: Optional[dict] = None):
        if params is None:
            data = np.load(WEIGHTS_PATH)
            params = {k: data[k] for k in data.files}
        self.params = params
        self.h = np.zeros(HIDDEN, np.float32)

    def reset(self) -> None:
        self.h[:] = 0.0

    def update(self, audio: np.ndarray) -> np.ndarray:
        """Chunk of PCM -> per-window speech probabilities (stateful)."""
        feats = extract_features(np.asarray(audio, np.float32))
        probs = np.empty(len(feats), np.float32)
        h = self.h
        for i, x in enumerate(feats):
            h = gru_step_np(self.params, h, x)
            logit = float((h @ self.params["out_w"])[0] + self.params["out_b"][0])
            probs[i] = _sigmoid(logit)
        self.h = h
        return probs


def weights_available() -> bool:
    return os.path.exists(WEIGHTS_PATH)
