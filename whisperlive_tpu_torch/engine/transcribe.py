"""Timestamp segmentation of one decoded window.

Port of the window-path pieces of whisperlive_tpu/engine/transcribe.py:
the Segment/Word records the serving layer sends and
split_segments_by_timestamps, which cuts a window's tokens at timestamp
boundaries. The offline seek loop (Transcriber) is not ported yet
(ROADMAP.md open item 7). Host-side numpy only.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np

from whisperlive_tpu_torch.engine.engine import TranscribeOptions

# Whisper timing constants (transcriber_faster_whisper.py:656-667)
INPUT_STRIDE = 2  # mel frames per encoder position
FRAMES_PER_SECOND = 100
TOKENS_PER_SECOND = 50
TIME_PRECISION = 0.02


@dataclasses.dataclass
class Word:
    start: float
    end: float
    word: str
    probability: float


@dataclasses.dataclass
class Segment:
    """Mirrors faster_whisper.Segment (transcriber_faster_whisper.py:43-59)."""

    id: int
    seek: int
    start: float
    end: float
    text: str
    tokens: list[int]
    temperature: float
    avg_logprob: float
    compression_ratio: float
    no_speech_prob: float
    words: Optional[list[Word]] = None


class TranscriptionInfo(NamedTuple):
    language: str
    language_probability: float
    duration: float
    transcription_options: TranscribeOptions
    all_language_probs: Optional[list[tuple[str, float]]] = None


def split_segments_by_timestamps(
    spec,
    tokens: np.ndarray,
    time_offset: float,
    window_duration: float,
    segment_size_frames: int,
    include_unfinished: bool = False,
) -> tuple[list[tuple[float, float, list[int]]], int, bool]:
    """Split one window's sampled tokens at timestamp boundaries.

    Port of the seek-advance semantics of _split_segments_by_timestamps
    (transcriber_faster_whisper.py:970-1047). Returns
    ([(start_s, end_s, tokens)], seek_advance_frames,
    single_timestamp_ending).

    include_unfinished: streaming-only mode — also emit the unfinished
    trailing slice (tokens after the last closed timestamp pair) as a final
    segment ending at the window edge. The offline seek loop must NOT use
    this (the tail is re-decoded next window, reference drops it); the
    streaming scheduler does, because its per-cycle decode is one window and
    the session layer needs the in-flight tail as the incomplete partial.
    """
    tb = spec.timestamp_begin
    toks = [int(t) for t in tokens]
    single = []

    # True when the window's output ends on a lone timestamp (no speech
    # after it): transcriber_faster_whisper.py:980-982.
    ended_with_single = (
        len(toks) >= 2 and toks[-2] < tb <= toks[-1]
    )
    consecutive = [
        i + 1
        for i in range(len(toks) - 1)
        if toks[i] >= tb and toks[i + 1] >= tb
    ]
    segments: list[tuple[float, float, list[int]]] = []
    if consecutive:
        # Boundaries at each consecutive-timestamp pair. On a single-
        # timestamp ending the trailing slice IS a finished segment (emit it
        # and advance the full window); otherwise trailing tokens are
        # unfinished — drop them and rewind seek to the last closed
        # timestamp so the next window re-decodes them
        # (transcriber_faster_whisper.py:992-1025).
        bounds = list(consecutive)
        if ended_with_single:
            bounds.append(len(toks))
        for a, b in zip([0] + bounds[:-1], bounds):
            piece = toks[a:b]
            if not piece:
                continue
            start_ts = piece[0] - tb if piece[0] >= tb else 0
            end_ts = piece[-1] - tb if piece[-1] >= tb else start_ts
            segments.append(
                (
                    time_offset + start_ts * TIME_PRECISION,
                    time_offset + end_ts * TIME_PRECISION,
                    piece,
                )
            )
        if ended_with_single:
            return segments, segment_size_frames, True
        if include_unfinished and bounds[-1] < len(toks):
            piece = toks[bounds[-1]:]
            start_ts = piece[0] - tb if piece[0] >= tb else 0
            segments.append(
                (
                    time_offset + start_ts * TIME_PRECISION,
                    time_offset + window_duration,
                    piece,
                )
            )
        last_close = toks[bounds[-1] - 1]
        seek_advance = (last_close - tb) * INPUT_STRIDE
        return segments, max(seek_advance, 1), False

    # No consecutive pair: one segment spanning the window; if the output
    # ends with a lone timestamp, it bounds the duration.
    duration = window_duration
    ts_tokens = [t for t in toks if t >= tb]
    if ts_tokens and ts_tokens[-1] != tb:
        duration = (ts_tokens[-1] - tb) * TIME_PRECISION
    single = [(time_offset, time_offset + duration, toks)]
    return single, segment_size_frames, ended_with_single
