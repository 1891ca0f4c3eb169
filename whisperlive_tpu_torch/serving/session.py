"""Per-stream session state: ring buffer + hypothesis stabilization.

Behavioral port of the reference's `ServeClientBase` streaming state machine
(whisper_live/backend/base.py; constants at base.py:16-23,40): a growing
PCM buffer trimmed at 45 s down to the last 30 s, a timestamp-offset
cursor separating committed audio from the un-committed tail, and the
"same partial output N times -> force commit" repetition heuristic
(base.py:383-483) that turns rolling re-transcriptions into stable
segments. The segment JSON format ({start,end,text,completed[,speaker]
[,words]} with "%.3f"-formatted second strings, base.py:145-171) is kept
byte-compatible so the reference's browser/iOS clients work unmodified.

This class is transport- and model-agnostic: the asyncio serving layer
feeds it PCM and decode results; it returns the JSON-ready segment dicts.
That separation mirrors the reference's hermetic test strategy (SURVEY §4:
tests inject a fake transcriber behind `transcribe_audio`).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

logger = logging.getLogger(__name__)

SAMPLE_RATE = 16_000

# Buffering policy (whisper_live/backend/base.py:16-23)
MAX_BUFFER_S = 45.0
TRIM_TARGET_S = 30.0
CLIP_AT_S = 25.0
CLIP_KEEP_TAIL_S = 5.0
MAX_TRANSCRIPT_SEGMENTS = 500  # base.py:40


def format_segment(
    start: float,
    end: float,
    text: str,
    completed: bool,
    speaker: Optional[str] = None,
    words: Optional[list[dict]] = None,
) -> dict:
    """Wire-format segment dict (base.py:145-171): ms-precision strings."""
    seg: dict[str, Any] = {
        "start": "{:.3f}".format(start),
        "end": "{:.3f}".format(end),
        "text": text,
        "completed": completed,
    }
    if speaker is not None:
        seg["speaker"] = speaker
    if words is not None:
        seg["words"] = words
    return seg


@dataclasses.dataclass
class SessionOptions:
    """Per-connection options from the handshake JSON (server.py:288-314)."""

    language: Optional[str] = None
    task: str = "transcribe"
    model: str = "small"
    use_vad: bool = True
    send_last_n_segments: int = 10
    no_speech_thresh: float = 0.45
    clip_audio: bool = False
    same_output_threshold: int = 10
    enable_translation: bool = False
    target_language: Optional[str] = None
    hotwords: Optional[str] = None
    enable_diarization: bool = False
    max_speakers: int = 4
    word_timestamps: bool = False
    initial_prompt: Optional[str] = None
    vad_parameters: Optional[dict] = None


class StreamingSession:
    """Audio buffer + segment stabilization for one stream.

    Thread-safe for one producer (network receive) and one consumer
    (transcription loop), matching the reference's lock + Event discipline
    (base.py:84-86,190-203).
    """

    def __init__(
        self,
        options: SessionOptions | None = None,
        segment_post_processor: Optional[Callable[[list[dict]], list[dict]]] = None,
        speaker_identifier: Optional[Callable[[np.ndarray, float, float], str]] = None,
    ):
        self.options = options or SessionOptions()
        self.lock = threading.Lock()
        self.frames_np: Optional[np.ndarray] = None
        self.frames_offset = 0.0  # seconds of audio discarded from the left
        self.timestamp_offset = 0.0  # committed-up-to cursor (seconds)
        self.transcript: list[dict] = []
        # All segment texts ever seen at a completed position (base.py:40
        # `self.text`): the forced-commit dedup compares against this, NOT
        # against the committed transcript (base.py:453).
        self.text: list[str] = []
        self.current_out = ""
        self.prev_out = ""
        self.same_output_count = 0
        self.end_time_for_same_output: Optional[float] = None
        self.exit = False
        self.eos = False
        self.segment_post_processor = segment_post_processor
        self.speaker_identifier = speaker_identifier
        self.translation_queue = None  # set by the server when enabled
        self.total_audio_s = 0.0

    # ------------------------------------------------------------------
    # producer side
    # ------------------------------------------------------------------

    def add_frames(self, frame_np: np.ndarray) -> None:
        """Append PCM; trim when the buffer exceeds 45 s (base.py:173-203)."""
        with self.lock:
            self.total_audio_s += len(frame_np) / SAMPLE_RATE
            if self.frames_np is not None and (
                self.frames_np.shape[0] > MAX_BUFFER_S * SAMPLE_RATE
            ):
                self.frames_offset += TRIM_TARGET_S
                self.frames_np = self.frames_np[int(TRIM_TARGET_S * SAMPLE_RATE):]
                # If the committed cursor fell off the left edge, snap it
                # forward (client stopped being transcribed fast enough).
                if self.timestamp_offset < self.frames_offset:
                    self.timestamp_offset = self.frames_offset
            if self.frames_np is None:
                self.frames_np = frame_np.copy()
            else:
                self.frames_np = np.concatenate([self.frames_np, frame_np])

    # ------------------------------------------------------------------
    # consumer side
    # ------------------------------------------------------------------

    def buffered_duration(self) -> float:
        with self.lock:
            if self.frames_np is None:
                return 0.0
            return self.frames_offset + len(self.frames_np) / SAMPLE_RATE - self.timestamp_offset

    def get_audio_chunk_for_processing(self) -> tuple[np.ndarray, float]:
        """Un-committed tail since timestamp_offset (base.py:216-234).

        With clip_audio, a tail longer than 25 s is clipped to its last 5 s
        (base.py:205-214) — the cursor jumps, dropping backlog.
        """
        with self.lock:
            if self.frames_np is None:
                return np.zeros(0, np.float32), 0.0
            if self.options.clip_audio:
                tail_s = (
                    self.frames_offset
                    + len(self.frames_np) / SAMPLE_RATE
                    - self.timestamp_offset
                )
                if tail_s > CLIP_AT_S:
                    self.timestamp_offset = (
                        self.frames_offset
                        + len(self.frames_np) / SAMPLE_RATE
                        - CLIP_KEEP_TAIL_S
                    )
            samples_take = max(
                0, int((self.timestamp_offset - self.frames_offset) * SAMPLE_RATE)
            )
            input_bytes = self.frames_np[samples_take:].copy()
        duration = input_bytes.shape[0] / SAMPLE_RATE
        return input_bytes, duration

    def peek_tail(self, anchor_s: float):
        """Current un-committed tail IF the cursor still sits at anchor_s,
        else None. Read-only (never clips/moves the cursor) and
        thread-safe — the continuous scheduler's late-bound audio refresh
        calls this from its worker thread at slot-grant time to decode the
        freshest buffered audio instead of the submit-time snapshot."""
        with self.lock:
            if self.frames_np is None or abs(
                self.timestamp_offset - anchor_s
            ) > 1e-6:
                return None
            samples_take = max(
                0, int((self.timestamp_offset - self.frames_offset) * SAMPLE_RATE)
            )
            return self.frames_np[samples_take:].copy()

    # ------------------------------------------------------------------
    # stabilization (base.py:383-483)
    # ------------------------------------------------------------------

    def _commit_segment(
        self,
        start: float,
        end: float,
        text: str,
        words: Optional[list[dict]] = None,
        identify_speaker: bool = True,
    ) -> dict:
        speaker = None
        if identify_speaker and self.speaker_identifier is not None:
            try:
                # start/end are absolute stream seconds; frames_np begins at
                # frames_offset after left-trims. Snapshot buffer + offset
                # under the lock: the network thread's 45 s trim rebinds
                # BOTH, and reading them unpaired would hand the embedder a
                # window displaced by the trim amount (wrong speaker) or
                # one past the shrunk buffer (empty slice).
                with self.lock:
                    buf, off = self.frames_np, self.frames_offset
                speaker = self.speaker_identifier(
                    buf,
                    max(start - off, 0.0),
                    max(end - off, 0.0),
                )
            except Exception:
                logger.exception("speaker identification failed")
        seg = format_segment(start, end, text, completed=True, speaker=speaker, words=words)
        self.transcript.append(seg)
        if len(self.transcript) > MAX_TRANSCRIPT_SEGMENTS:
            self.transcript = self.transcript[-MAX_TRANSCRIPT_SEGMENTS:]
        if len(self.text) > MAX_TRANSCRIPT_SEGMENTS:
            self.text = self.text[-MAX_TRANSCRIPT_SEGMENTS:]
        if self.translation_queue is not None:
            try:
                self.translation_queue.put_nowait(seg)
            except Exception:
                logger.warning("translation queue full, dropping segment")
        return seg

    def update_segments(self, segments: list[Any], duration: float) -> Optional[dict]:
        """Process one re-transcription of the current tail.

        `segments`: Segment-like objects with .start/.end/.text/
        .no_speech_prob (and optionally .words). `duration`: seconds of
        audio that was transcribed. Returns the last (incomplete) segment
        dict, or None.

        Semantics (base.py:383-483): all but the last segment are committed
        immediately (subject to the no-speech filter); the last segment is
        the rolling hypothesis — if its text repeats `same_output_threshold`
        times it is force-committed and the cursor advances.
        """
        offset: Optional[float] = None
        self.current_out = ""
        last_segment = None
        if not segments:
            return None
        last_ns_prob = getattr(segments[-1], "no_speech_prob", 0.0)

        # Commit all-but-last, gated on the LAST segment's no_speech_prob
        # (base.py:401) — not on its text.
        if len(segments) > 1 and last_ns_prob <= self.options.no_speech_thresh:
            for s in segments[:-1]:
                text = s.text
                # every completed-position text is recorded, even if the
                # segment itself is then filtered (base.py:403-404) — so
                # the bound must apply HERE too, or filtered middle
                # segments grow self.text without ever reaching the trim
                # in _commit_segment
                self.text.append(text)
                if len(self.text) > MAX_TRANSCRIPT_SEGMENTS:
                    self.text = self.text[-MAX_TRANSCRIPT_SEGMENTS:]
                start = self.timestamp_offset + s.start
                end = self.timestamp_offset + min(duration, s.end)
                if start >= end:
                    continue
                if getattr(s, "no_speech_prob", 0.0) > self.options.no_speech_thresh:
                    continue
                self._commit_segment(
                    start, end, text, words=self._words_of(s)
                )
                offset = min(duration, s.end)

        # rolling hypothesis = last segment (base.py:424-436): current_out
        # is set ONLY when the no-speech gate passes, so silent windows
        # never count toward the repetition heuristic.
        if last_ns_prob <= self.options.no_speech_thresh:
            s = segments[-1]
            self.current_out += s.text
            # clamp START to the window too: a decode whose trailing
            # timestamp lands beyond the actual audio (hallucination past
            # content; routine with random weights) would otherwise emit an
            # inverted start>end segment on the wire
            last_segment = format_segment(
                self.timestamp_offset + min(duration, s.start),
                self.timestamp_offset + min(duration, s.end),
                self.current_out,
                completed=False,
                words=self._words_of(s),
            )

        # repetition-based forced commit (base.py:437-480)
        if (
            self.current_out.strip() == self.prev_out.strip()
            and self.current_out != ""
        ):
            self.same_output_count += 1
            # Capture the extent of the repeated hypothesis at the FIRST
            # repetition only (base.py:442-446): the forced commit must not
            # advance the cursor past audio that arrived during later
            # repetitions and is not yet transcribed.
            if self.end_time_for_same_output is None:
                self.end_time_for_same_output = segments[-1].end
        else:
            self.same_output_count = 0
            self.end_time_for_same_output = None

        if self.same_output_count > self.options.same_output_threshold:
            # dedup vs the last seen text, case-insensitively (base.py:453)
            if (
                not self.text
                or self.text[-1].strip().lower() != self.current_out.strip().lower()
            ):
                self.text.append(self.current_out)
                self._commit_segment(
                    self.timestamp_offset,
                    self.timestamp_offset
                    + min(duration, self.end_time_for_same_output),
                    self.current_out,
                    identify_speaker=False,
                )
            self.current_out = ""
            offset = min(duration, self.end_time_for_same_output)
            self.same_output_count = 0
            last_segment = None
            self.end_time_for_same_output = None
            # prev_out is intentionally left unchanged on the forced-commit
            # branch (base.py:475-476).
        else:
            self.prev_out = self.current_out

        if offset is not None:
            with self.lock:
                self.timestamp_offset += offset
        return last_segment

    def _words_of(self, s) -> Optional[list[dict]]:
        words = getattr(s, "words", None)
        if not words or not self.options.word_timestamps:
            return None
        # wire format matches _extract_words (base.py:366-381):
        # "%.3f"-formatted STRING timestamps, like segment start/end
        return [
            {
                "word": w.word,
                "start": "{:.3f}".format(self.timestamp_offset + w.start),
                "end": "{:.3f}".format(self.timestamp_offset + w.end),
                "probability": round(getattr(w, "probability", 1.0), 4),
            }
            for w in words
        ]

    def prepare_segments(self, last_segment: Optional[dict] = None) -> list[dict]:
        """Last N committed + the rolling hypothesis (base.py:236-259)."""
        n = self.options.send_last_n_segments
        segments = self.transcript[-n:].copy() if len(self.transcript) >= n else self.transcript.copy()
        if last_segment is not None:
            segments.append(last_segment)
        if self.segment_post_processor is not None:
            try:
                segments = self.segment_post_processor(segments)
            except Exception:
                logger.exception("segment post-processor failed")
        return segments
