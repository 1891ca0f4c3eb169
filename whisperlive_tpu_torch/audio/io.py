"""Host audio IO: PCM conversion, WAV files, resampling, file loading.

The port's copy of whisperlive_tpu/audio/io.py: wire PCM bytes for the
server, and for the offline CLI stdlib `wave` for WAV, polyphase resampling
via scipy, the port's own FLAC decoder (audio/flac.py), and other
containers behind an optional PyAV import.
"""

from __future__ import annotations

import io
import wave

import numpy as np

SAMPLE_RATE = 16_000


def bytes_to_float_array(data: bytes, audio_format: str = "float32") -> np.ndarray:
    """Wire PCM bytes -> float32 in [-1, 1] (server.py:365-385 formats)."""
    if audio_format == "float32":
        return np.frombuffer(data, np.float32).copy()
    if audio_format == "int16":
        try:
            import wl_native

            return np.frombuffer(wl_native.int16_to_float32(data), np.float32).copy()
        except ImportError:
            return np.frombuffer(data, np.int16).astype(np.float32) / 32768.0
    if audio_format == "uint8":
        return (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
    raise ValueError(f"unsupported audio_format: {audio_format!r}")


def float_to_int16_bytes(audio: np.ndarray) -> bytes:
    return (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16).tobytes()


def resample_audio(
    audio: np.ndarray, orig_sr: int, target_sr: int = SAMPLE_RATE
) -> np.ndarray:
    """Polyphase resampling (scipy) — no ffmpeg needed."""
    if orig_sr == target_sr:
        return audio.astype(np.float32)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(audio.astype(np.float32), target_sr // g, orig_sr // g).astype(
        np.float32
    )


def read_wav(path_or_bytes) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono audio, sample_rate)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        fobj = io.BytesIO(path_or_bytes)
    else:
        fobj = open(path_or_bytes, "rb")
    with wave.open(fobj, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        audio = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        audio = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width: {width}")
    if ch > 1:
        audio = audio.reshape(-1, ch).mean(axis=1)
    return audio, sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(float_to_int16_bytes(audio))


def load_audio(path: str, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """Load any audio file to float32 mono 16 kHz.

    WAV natively; FLAC via the built-in pure-Python decoder; other
    containers via PyAV when installed (the reference's approach,
    tensorrt_utils.py load_audio).
    """
    lower = path.lower()
    if lower.endswith(".wav"):
        audio, sr = read_wav(path)
        return resample_audio(audio, sr, target_sr)
    if lower.endswith(".flac"):
        from whisperlive_tpu_torch.audio.flac import read_flac

        audio, sr = read_flac(path)
        return resample_audio(audio, sr, target_sr)
    try:
        import av  # optional
    except ImportError as e:
        raise RuntimeError(
            f"cannot decode {path!r}: install PyAV for non-WAV/FLAC containers"
        ) from e
    container = av.open(path)
    frames = []
    resampler = av.audio.resampler.AudioResampler(
        format="s16", layout="mono", rate=target_sr
    )
    for frame in container.decode(audio=0):
        for out in resampler.resample(frame):
            frames.append(np.frombuffer(bytes(out.planes[0]), np.int16))
    container.close()
    if not frames:
        return np.zeros(0, np.float32)
    return np.concatenate(frames).astype(np.float32) / 32768.0
