"""Online speaker diarization: embeddings + incremental cosine clustering.

Behavioral port of the reference's SpeakerDiarizer (whisper_live/
diarization.py, §2.17): per-segment speaker embedding, cosine similarity
against known speaker centroids, new-speaker threshold 0.55, EMA centroid
update 0.9/0.1, max_speakers cap, named enrollment for the REST
known-speakers feature, 0.3 s minimum audio.

The embedding model is pluggable. The reference downloads a pyannote
checkpoint at runtime; the default here is the learned in-repo embedder
(audio/speaker_model.py, trained by scripts/train_speaker.py on synthetic
voice profiles) when its weight file ships, falling back to a weight-free
spectral embedder (log-mel statistics + spectral envelope shape). The
learned model separates same-register voices (same f0, different formant
envelopes) that the spectral signature confuses; set WL_SPEAKER=spectral
to force the fallback. Any other embedder can be dropped in via the
`embedder` argument without touching call sites.

The port's copy of whisperlive_tpu/diarization.py; its embedders run as
host numpy (audio/speaker_model.py, audio/wespeaker.py).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

import numpy as np

logger = logging.getLogger(__name__)

SAMPLE_RATE = 16_000
MIN_AUDIO_S = 0.3  # diarization.py:111
SIMILARITY_THRESHOLD = 0.55  # diarization.py:135
EMA_KEEP = 0.9  # diarization.py:160


class SpectralEmbedder:
    """Weight-free speaker embedding from spectral statistics.

    Features: per-band log-energy mean/std over 25 ms frames plus spectral
    centroid/rolloff moments — a coarse vocal-timbre signature. Returns an
    L2-normalized vector.
    """

    N_BANDS = 32
    FRAME = 400
    HOP = 160

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        audio = np.asarray(audio, np.float32).reshape(-1)
        n = (len(audio) - self.FRAME) // self.HOP + 1
        if n < 2:
            return np.zeros(self.N_BANDS * 2 + 4, np.float32)
        idx = np.arange(self.FRAME)[None, :] + self.HOP * np.arange(n)[:, None]
        frames = audio[idx] * np.hanning(self.FRAME)[None, :]
        spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2  # [n, 201]
        # drop near-silent frames so silence doesn't wash out the timbre
        energy = spec.sum(axis=1)
        keep = energy > max(np.median(energy) * 0.25, 1e-10)
        if keep.sum() >= 2:
            spec = spec[keep]
        # band-pool to N_BANDS log energies
        bands = np.array_split(spec, self.N_BANDS, axis=1)
        band_e = np.stack([b.sum(axis=1) for b in bands], axis=1)  # [n, B]
        log_e = np.log(band_e + 1e-10)
        mean = log_e.mean(axis=0)
        std = log_e.std(axis=0)
        freqs = np.arange(spec.shape[1])
        p = spec / (spec.sum(axis=1, keepdims=True) + 1e-10)
        centroid = (p * freqs).sum(axis=1)
        spread = np.sqrt((p * (freqs - centroid[:, None]) ** 2).sum(axis=1))
        extra = np.array(
            [centroid.mean(), centroid.std(), spread.mean(), spread.std()],
            np.float32,
        ) / spec.shape[1]
        vec = np.concatenate([mean - mean.mean(), std, extra]).astype(np.float32)
        norm = np.linalg.norm(vec)
        return vec / norm if norm > 0 else vec


def _default_embedder(quality: bool = False):
    """Pick the best available embedder for the call site.

    quality=True (offline/REST, latency-tolerant) prefers the
    WeSpeaker-ResNet-shaped model (audio/wespeaker.py — the reference's
    embedding-model family, ~0.2 s/segment on this host's single core);
    quality=False (streaming) prefers the cheap learned MLP
    (audio/speaker_model.py, ~1 ms/segment). WL_SPEAKER forces one of
    wespeaker|mlp|spectral on every path; missing weights fall through
    wespeaker -> mlp -> spectral.
    """
    import os

    forced = os.environ.get("WL_SPEAKER", "")
    if forced == "spectral":
        return SpectralEmbedder()
    if forced == "wespeaker" or (not forced and quality):
        try:
            from whisperlive_tpu_torch.audio.wespeaker import (
                WeSpeakerEmbedder,
                weights_available,
            )

            if weights_available():
                return WeSpeakerEmbedder()
        except Exception:  # corrupt/missing weights: fall through
            pass
        if forced:
            logger.warning("WL_SPEAKER=wespeaker but no weights; using mlp")
    try:
        from whisperlive_tpu_torch.audio.speaker_model import (
            LearnedSpeakerEmbedder,
            weights_available,
        )

        if weights_available():
            return LearnedSpeakerEmbedder()
    except Exception:  # corrupt/missing weights: fall through
        pass
    return SpectralEmbedder()


class SpeakerDiarizer:
    """Incremental clustering over a pluggable embedder (diarization.py)."""

    def __init__(
        self,
        max_speakers: int = 4,
        similarity_threshold: float = SIMILARITY_THRESHOLD,
        embedder: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        quality: bool = False,
    ):
        self.max_speakers = max_speakers
        self.similarity_threshold = similarity_threshold
        self._embedder = embedder or _default_embedder(quality)
        self._lock = threading.Lock()
        self.speakers: list[np.ndarray] = []
        self.speaker_names: list[str] = []

    def reset(self) -> None:
        with self._lock:
            self.speakers = []
            self.speaker_names = []

    # ------------------------------------------------------------------

    def enroll_speaker(self, name: str, audio: np.ndarray) -> bool:
        """Named enrollment (diarization.py:170-176; REST known-speakers)."""
        emb = self._embedder(audio)
        if not np.any(emb):
            return False
        with self._lock:
            self.speakers.append(emb)
            self.speaker_names.append(name)
        return True

    def identify_speaker(self, audio: np.ndarray) -> Optional[str]:
        """Assign a speaker label to a segment slice (diarization.py:125-168)."""
        if audio is None or len(audio) < MIN_AUDIO_S * SAMPLE_RATE:
            return None
        emb = self._embedder(audio)
        if not np.any(emb):
            return None
        with self._lock:
            if self.speakers:
                sims = np.array([float(np.dot(emb, s)) for s in self.speakers])
                best = int(np.argmax(sims))
                if sims[best] >= self.similarity_threshold:
                    # EMA centroid update
                    updated = EMA_KEEP * self.speakers[best] + (1 - EMA_KEEP) * emb
                    norm = np.linalg.norm(updated)
                    self.speakers[best] = updated / norm if norm > 0 else updated
                    return self.speaker_names[best]
            if len(self.speakers) >= self.max_speakers:
                # over capacity: snap to nearest anyway
                sims = np.array([float(np.dot(emb, s)) for s in self.speakers])
                return self.speaker_names[int(np.argmax(sims))]
            name = f"SPEAKER_{len(self.speakers)}"
            self.speakers.append(emb)
            self.speaker_names.append(name)
            return name

    # ------------------------------------------------------------------

    def make_identifier(self):
        """(frames, start_s, end_s) -> label hook for StreamingSession."""

        def identify(frames: Optional[np.ndarray], start: float, end: float):
            if frames is None:
                return None
            a = frames[int(start * SAMPLE_RATE) : int(end * SAMPLE_RATE)]
            return self.identify_speaker(a)

        return identify
