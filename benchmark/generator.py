"""The benchmark's traffic generator: every mix is a data file under
benchmark/traffic/, read here, and made from the run's seed.

Audio is a speech-like signal: a glottal-like harmonic series on a drifting
pitch contour, shaped by syllable-rate and word-rate envelopes, over a faint
noise floor. No sample is exactly zero, so the unpadded length of a window
row is the index of its last nonzero sample plus one.

Two kinds of mix exist:

  stream  live sessions: each stream's whole signal, its start time (the
          streams start staggered before the window, each with some audio
          already buffered) and its chunk size;
  files   offline batches: one call after another, each a set of files whose
          durations are the same set on every seed (evenly spaced over the
          mix's range), in a seed-drawn order, cut from a bank of signals
          with seed-drawn offsets.

Seeds are any whole number; numpy's generator takes them whole.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

SAMPLE_RATE = 16_000
TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
_TABLE_SIZE = 4096


def load_mix(name: str) -> dict:
    """The traffic file benchmark/traffic/<name>.json."""
    path = TRAFFIC_DIR / f"{name}.json"
    with open(path) as f:
        mix = json.load(f)
    mix["name"] = name
    return mix


def _harmonic_table(rng: np.random.Generator, harmonics: int) -> np.ndarray:
    """One period of a harmonic series with 1/k amplitudes and random phases."""
    t = np.arange(_TABLE_SIZE) / _TABLE_SIZE
    k = np.arange(1, harmonics + 1)[:, None]
    phases = rng.uniform(0, 2 * np.pi, (harmonics, 1))
    wave = (np.sin(2 * np.pi * k * t[None, :] + phases) / k).sum(axis=0)
    return (wave / np.abs(wave).max()).astype(np.float32)


def speech_like(rng: np.random.Generator, n_samples: int, signal: dict) -> np.ndarray:
    """[n_samples] float32 PCM at 16 kHz with no exact zero."""
    n = int(n_samples)
    t = np.arange(n, dtype=np.float64) / SAMPLE_RATE
    f0 = rng.uniform(*signal["f0_hz"])
    drift = signal["f0_drift"] * np.sin(2 * np.pi * rng.uniform(0.1, 0.4) * t
                                        + rng.uniform(0, 2 * np.pi))
    freq = f0 * (1.0 + drift)
    phase = np.cumsum(freq) / SAMPLE_RATE
    table = _harmonic_table(rng, signal["harmonics"])
    voiced = table[(phase * _TABLE_SIZE).astype(np.int64) % _TABLE_SIZE]
    rate = rng.uniform(*signal["syllables_hz"])
    syll = 0.5 + 0.5 * np.sin(2 * np.pi * rate * t + rng.uniform(0, 2 * np.pi))
    # word-rate gating: a level per word, some words silent-ish (pauses)
    word = int(signal["word_s"] * SAMPLE_RATE)
    levels = rng.uniform(0.0, 1.0, n // word + 2)
    levels = np.where(levels < signal["pause_share"], 0.05, levels)
    env = syll * syll * np.repeat(levels, word)[:n]
    x = signal["level"] * env * voiced + signal["noise"] * rng.standard_normal(n)
    x = x.astype(np.float32)
    x[x == 0.0] = 1e-7
    return x


def stream_traffic(mix: dict, seed: int, seconds: float) -> list[dict]:
    """One entry per stream: {"uid", "audio", "start_s"} where start_s is the
    stream's start relative to the window's start (negative: before it):
    the streams start evenly over mix["stagger_s"], then run
    mix["settle_s"] more before the window opens. At its start a stream has
    mix["prebuffer_s"] of audio, then chunks of mix["chunk_samples"] in real
    time until the window ends."""
    rng = np.random.default_rng([seed, 1])
    n = mix["streams"]
    out = []
    for i in range(n):
        start = -(mix["stagger_s"] + mix["settle_s"]) + mix["stagger_s"] * i / n
        total_s = mix["prebuffer_s"] + (seconds - start) + 2.0
        audio = speech_like(np.random.default_rng([seed, 2, i]),
                            int(total_s * SAMPLE_RATE), mix["signal"])
        out.append({"uid": f"s{i}", "audio": audio, "start_s": start})
    rng.shuffle(out)  # submission order within a tick is drawn, the set is not
    return out


class FileBank:
    """The files mix: call c's files, made on demand from a bank of signals
    drawn once from the seed."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = seed
        n = mix["files_per_call"]
        lo, hi = mix["duration_s"]
        # the same durations on every seed: evenly spaced over [lo, hi]
        self.durations = [lo + (hi - lo) * (i + 0.5) / n for i in range(n)]
        bank_len = int((hi + mix["bank_extra_s"]) * SAMPLE_RATE)
        self.bank = [speech_like(np.random.default_rng([seed, 3, i]), bank_len, mix["signal"])
                     for i in range(n)]

    def call(self, c: int) -> list[np.ndarray]:
        """The files of call c: the fixed durations in a drawn order, each cut
        from a bank signal at a drawn offset."""
        rng = np.random.default_rng([self.seed, 4, c])
        n = len(self.durations)
        order = rng.permutation(n)
        files = []
        for i in range(n):
            dur = int(self.durations[order[i]] * SAMPLE_RATE)
            src = self.bank[(i + c) % n]
            off = int(rng.integers(0, len(src) - dur + 1))
            files.append(src[off: off + dur])
        return files


def real_samples(row: np.ndarray) -> int:
    """Unpadded length of a window row: the generator makes no exact zero,
    so the row's audio ends at its last nonzero sample."""
    nz = np.flatnonzero(row)
    return int(nz[-1]) + 1 if nz.size else 0
