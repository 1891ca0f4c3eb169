"""Whisper log-mel frontend in PyTorch (features last).

Port of whisperlive_tpu/ops/mel.py: 16 kHz audio, N_FFT=400, HOP=160,
80 or 128 Slaney mel bins, 30 s = 3000 frames,
``log10(clamp(mel @ |STFT|^2)) -> max(x, x.max()-8) -> (x+4)/4``.
The STFT is two float32 matmuls against a Hann-folded DFT basis over
reflect-padded frames, with the final frame dropped, exactly as the JAX
version computes it. On CUDA, device.resolve_device turns TF32 off so these
products run in full float32 (the JAX code asks for Precision.HIGHEST).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


def _hertz_to_mel(freq):
    """Slaney-style mel scale (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(
        freq >= min_log_hertz,
        min_log_mel + np.log(np.maximum(freq, min_log_hertz) / min_log_hertz) * logstep,
        mels,
    )


def _mel_to_hertz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(
        mels >= min_log_mel, min_log_hertz * np.exp(logstep * (mels - min_log_mel)), freq
    )


def mel_filter_bank(
    n_freqs: int = N_FFT // 2 + 1,
    n_mels: int = 80,
    sample_rate: int = SAMPLE_RATE,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank [n_freqs, n_mels]
    (librosa.filters.mel(htk=False, norm="slaney"))."""
    if fmax is None:
        fmax = sample_rate / 2.0
    fft_freqs = np.linspace(0, sample_rate / 2.0, n_freqs)
    mel_points = np.linspace(_hertz_to_mel(fmin), _hertz_to_mel(fmax), n_mels + 2)
    hz_points = _mel_to_hertz(mel_points)
    fdiff = np.diff(hz_points)
    slopes = hz_points[np.newaxis, :] - fft_freqs[:, np.newaxis]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (hz_points[2 : n_mels + 2] - hz_points[:n_mels])
    fb *= enorm[np.newaxis, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _windowed_basis(n_fft: int, n_mels: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hann-folded real/imaginary DFT basis [n_fft, n_fft//2+1] and the mel
    filterbank, as numpy constants."""
    n_freqs = n_fft // 2 + 1
    k = np.arange(n_freqs)[np.newaxis, :]
    n = np.arange(n_fft)[:, np.newaxis]
    angle = -2.0 * np.pi * n * k / n_fft
    cos_b, sin_b = np.cos(angle).astype(np.float32), np.sin(angle).astype(np.float32)
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)  # periodic Hann
    return window[:, None] * cos_b, window[:, None] * sin_b, mel_filter_bank(n_mels=n_mels)


def _raw_log_mel(frames: torch.Tensor, cos_b, sin_b, mel_fb) -> torch.Tensor:
    """STFT frames [..., n_fft] -> log10 mel power [..., n_mels], with no
    dynamic-range clamp."""
    re = frames @ cos_b
    im = frames @ sin_b
    mel = (re * re + im * im) @ mel_fb
    return torch.log10(torch.clamp(mel, min=1e-10))


def log_mel_spectrogram(
    audio: torch.Tensor,
    n_mels: int = 80,
    n_fft: int = N_FFT,
    hop_length: int = HOP_LENGTH,
) -> torch.Tensor:
    """[B, n_samples] float PCM -> [B, n_samples // hop_length, n_mels] f32."""
    if audio.dim() == 1:
        audio = audio[None, :]
    dev = audio.device
    cos_b, sin_b, mel_fb = (
        torch.from_numpy(a).to(dev) for a in _windowed_basis(n_fft, n_mels)
    )
    pad = n_fft // 2
    padded = torch.nn.functional.pad(
        audio.float()[:, None, :], (pad, pad), mode="reflect"
    )[:, 0]
    frames = padded.unfold(-1, n_fft, hop_length)  # [B, n_frames, n_fft] view
    frames = frames[:, :-1, :]  # Whisper drops the final STFT frame
    log_spec = _raw_log_mel(frames, cos_b, sin_b, mel_fb)
    max_per_item = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_per_item - 8.0)
    return (log_spec + 4.0) / 4.0


def pad_or_trim(audio: np.ndarray, length: int = N_SAMPLES) -> np.ndarray:
    """Host-side pad/trim to a fixed sample count."""
    if audio.shape[-1] >= length:
        return audio[..., :length]
    pad = length - audio.shape[-1]
    return np.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(0, pad)])


def pad_or_trim_frames(mel: np.ndarray, length: int = N_FRAMES) -> np.ndarray:
    """Zero-pad/trim a [T, n_mels] feature slice to a fixed frame count: the
    mel-domain pad_or_trim of each seek window."""
    if mel.shape[0] >= length:
        return mel[:length]
    return np.pad(mel, [(0, length - mel.shape[0]), (0, 0)])


def log_mel_full(
    audio: np.ndarray,
    n_mels: int = 80,
    padding: int = HOP_LENGTH,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Whole-clip log-mel features for the offline seek loop.

    faster_whisper FeatureExtractor semantics: `padding` zero samples
    appended, centered STFT with reflect edges, final frame dropped, and the
    max - 8 dynamic-range clamp taken over the WHOLE clip, not per window
    (so log_mel_spectrogram, which clamps per window, cannot serve the seek
    loop). The raw log-mel runs on `device`, 3000 frames at a time, so
    device memory stays bounded for long files; only the global clamp and
    scale run on the host. The STFT power and the mel projection are taken
    in float64 (float32 samples in, float32 features out): in float32 the
    bins near the clamp floor, down to 1e-8 of the clip's peak power, carry
    most of the rounding, and on an H100 the float32 products put the
    features of a 70 s clip 1.07e-4 away from the CPU's at 128 mels.

    Returns [T, n_mels] float32 with T = (len(audio) + padding) // HOP_LENGTH.
    """
    from whisperlive_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    audio = np.asarray(audio, np.float32).reshape(-1)
    n_frames = (len(audio) + padding) // HOP_LENGTH
    if n_frames <= 0:
        return np.zeros((0, n_mels), np.float32)
    half = N_FFT // 2
    sig = np.pad(audio, (0, padding))
    sig = np.pad(sig, (half, half), mode="reflect" if len(sig) > half else "constant")
    # frame f starts at sample f * HOP_LENGTH; zero-fill up to the last
    # frame of the last 3000-frame chunk
    n_chunks = -(-n_frames // N_FRAMES)
    buf = np.zeros((n_chunks * N_FRAMES - 1) * HOP_LENGTH + N_FFT, np.float32)
    buf[: min(len(sig), len(buf))] = sig[: len(buf)]
    cos_b, sin_b, mel_fb = (torch.from_numpy(a).to(dev, torch.float64)
                            for a in _windowed_basis(N_FFT, n_mels))
    with torch.inference_mode():
        frames = torch.from_numpy(buf).to(dev, torch.float64).unfold(0, N_FFT, HOP_LENGTH)
        pieces = [_raw_log_mel(frames[f0 : f0 + N_FRAMES], cos_b, sin_b, mel_fb)
                  for f0 in range(0, n_chunks * N_FRAMES, N_FRAMES)]
        log_spec = torch.cat(pieces)[:n_frames].float().cpu().numpy()
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)
