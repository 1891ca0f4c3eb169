"""Wire PCM bytes -> float32 samples.

The port's copy of the part of whisperlive_tpu/audio/io.py that the server
needs; WAV files, resampling and container formats stay with the JAX
package until the offline CLI is ported (ROADMAP.md open item 11).
"""

from __future__ import annotations

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
