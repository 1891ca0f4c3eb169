"""High-level transcription: seek loop, timestamp segmentation, segments.

Port of whisperlive_tpu/engine/transcribe.py, the behavioral twin of the
reference's faster-whisper pipeline (`WhisperModel.transcribe` +
`generate_segments`, transcriber_faster_whisper.py:692-968, 1049-1337):
30 s windowed decoding with temperature fallback, timestamp-token
segmentation, no-speech gating, condition-on-previous-text prompting, word
timestamps and the hallucination re-seek. The device work (whole-clip
log-mel, encoder, sampling loop) is the port's engine; this layer is
host-side orchestration on numpy token arrays. The Segment/Word records and
split_segments_by_timestamps also serve the streaming scheduler.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Optional

import numpy as np

from whisperlive_tpu_torch.engine.engine import (
    TranscribeOptions,
    WhisperEngine,
    _bucket,
)
from whisperlive_tpu_torch.ops import mel as mel_ops
from whisperlive_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

# Whisper timing constants (transcriber_faster_whisper.py:656-667)
INPUT_STRIDE = 2  # mel frames per encoder position
FRAMES_PER_SECOND = 100
TOKENS_PER_SECOND = 50
TIME_PRECISION = 0.02


def detect_language_from_features(
    eng: WhisperEngine,
    features: np.ndarray,
    threshold: float | None = 0.5,
    segments: int = 1,
) -> tuple[str, float, list[tuple[str, float]]]:
    """Multi-segment language detection (faster-whisper detect_language,
    transcriber_faster_whisper.py:1716-1789): probe up to `segments` 30 s
    windows left to right, accept the first whose top probability clears
    `threshold`; if none does, the language detected most often wins and
    reports its best probability.

    Returns (language, probability, all_language_probs) where the prob
    list comes from the deciding window, sorted descending.
    """
    codes = eng.tokenizer.spec.language_codes
    content_frames = max(features.shape[0] - 1, 1)
    n_windows = max(1, min(int(segments), -(-content_frames // mel_ops.N_FRAMES)))
    votes: dict[str, float] = {}
    counts: dict[str, int] = {}
    row = None
    language = None
    for w in range(n_windows):
        window = mel_ops.pad_or_trim_frames(
            features[w * mel_ops.N_FRAMES : (w + 1) * mel_ops.N_FRAMES]
        )
        _, cross_kv = eng.prepare_mel(window[None])
        (row,) = eng.detect_language_probs_from_cross(cross_kv)
        top = int(np.argmax(row))
        language, prob = codes[top], float(row[top])
        if threshold is None or prob > threshold:
            break
        counts[language] = counts.get(language, 0) + 1
        votes[language] = max(votes.get(language, 0.0), prob)
    else:
        # nothing cleared the bar: plurality of per-window winners, best
        # observed probability for that language
        language = max(counts, key=lambda k: counts[k])
        prob = votes[language]
    all_probs = sorted(
        ((codes[i], float(p)) for i, p in enumerate(row)),
        key=lambda kv: kv[1],
        reverse=True,
    )
    return language, prob, all_probs


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


_ANOMALY_PUNCT = "\"'“¿([{-\"'.。,，!！?？:：”)]}、"
_SENTENCE_END_MARKS = ".。!！?？"

# Hallucination fingerprint on aligned words: suspicion accrues from an
# implausibly low token probability (flat penalty) and from durations
# outside the plausible speech range (linear penalties). The numeric
# thresholds match the reference heuristics exactly — they define
# user-visible output behavior (cf. transcriber_faster_whisper.py
# word_anomaly_score / is_segment_anomaly) — but the scoring here is a
# closed-form expression, not a branch chain.
_SUSPECT_PROB = 0.15  # below this, the word itself is doubtful
_DUR_FLOOR = 0.133  # seconds; shorter implies a clipped/ghost word
_DUR_CEIL = 2.0  # seconds; longer implies a smeared alignment
_SHORT_RATE = 15.0  # suspicion per second under the floor
_SEG_SCORE_LIMIT = 3.0  # total suspicion that damns a segment
_SEG_WORD_SAMPLE = 8  # leading words considered per segment


def _word_suspicion(word: dict) -> float:
    dur = word["end"] - word["start"]
    return (
        float(word.get("probability", 0.0) < _SUSPECT_PROB)
        + max(_DUR_FLOOR - dur, 0.0) * _SHORT_RATE
        + max(dur - _DUR_CEIL, 0.0)
    )


def _looks_hallucinated(segment: Optional[dict]) -> bool:
    """Segment-level verdict: sum word suspicions over the first few
    non-punctuation words; damn the segment when the total crosses the
    absolute limit or (within epsilon) averages >= 1 per word."""
    if segment is None or not segment.get("words"):
        return False
    sampled = [
        w for w in segment["words"] if w["word"] not in _ANOMALY_PUNCT
    ][:_SEG_WORD_SAMPLE]
    total = sum(_word_suspicion(w) for w in sampled)
    return total >= _SEG_SCORE_LIMIT or total + 0.01 >= len(sampled)


def _next_words_segment(segments: list[dict]) -> Optional[dict]:
    return next((s for s in segments if s["words"]), None)


def _get_end(segments: list[dict]) -> Optional[float]:
    return next(
        (w["end"] for s in reversed(segments) for w in reversed(s["words"])),
        segments[-1]["end"] if segments else None,
    )


def add_word_timestamps(
    eng,
    cross_kv,
    item_index: int,
    pieces: list[dict],
    segment_size: int,
    time_offset: float,
    last_speech_timestamp: float,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    language: str | None = None,
    task: str = "transcribe",
) -> None:
    """Attach word-level timings to this window's segment dicts, mutating
    their start/end like the reference (add_word_timestamps,
    transcriber_faster_whisper.py:1515-1646): one DTW alignment over the
    window's concatenated text tokens, duration hacks at sentence and
    segment boundaries, punctuation merging, then distribution across
    segments by token count."""
    from whisperlive_tpu_torch.engine import align as align_mod

    eot = eng.spec.eot
    tokens_per_piece = [[t for t in p["tokens"] if t < eot] for p in pieces]
    flat = [t for toks in tokens_per_piece for t in toks]
    if not flat:
        for p in pieces:
            p["words"] = []
        return
    alignment = eng.align_words(
        cross_kv, item_index, flat, segment_size, merge=False,
        language=language, task=task,
    )

    word_durations = np.array([w.end - w.start for w in alignment])
    word_durations = word_durations[word_durations.nonzero()]
    median_duration = (
        float(np.median(word_durations)) if len(word_durations) > 0 else 0.0
    )
    median_duration = min(0.7, median_duration)
    max_duration = median_duration * 2

    if len(word_durations) > 0:
        _cap_sentence_boundary_words(alignment, max_duration)

    alignment = align_mod.merge_punctuations(
        alignment, prepend_punctuations, append_punctuations
    )

    word_index = 0
    for piece, piece_tokens in zip(pieces, tokens_per_piece):
        saved_tokens = 0
        words: list[dict] = []
        while word_index < len(alignment) and saved_tokens < len(piece_tokens):
            timing = alignment[word_index]
            if timing.word:
                words.append(
                    dict(
                        word=timing.word,
                        start=round(time_offset + timing.start, 2),
                        end=round(time_offset + timing.end, 2),
                        probability=timing.probability,
                    )
                )
            saved_tokens += len(timing.tokens)
            word_index += 1

        if words:
            _rebalance_post_pause(
                words, last_speech_timestamp, median_duration, max_duration
            )
            _reconcile_segment_edges(piece, words, median_duration)
            last_speech_timestamp = piece["end"]
        piece["words"] = words


def _cap_sentence_boundary_words(alignment, max_duration: float) -> None:
    """A word stretched past max_duration at a sentence boundary is an
    alignment smear, not real speech: shrink a long punctuation mark
    forward onto its start, and a long word that FOLLOWS a mark backward
    onto its end. (DTW likes to park sentence-final silence on whichever
    token sits next to it; same duration bound as the reference.)"""
    for i in range(1, len(alignment)):
        cur = alignment[i]
        if cur.end - cur.start <= max_duration:
            continue
        if cur.word in _SENTENCE_END_MARKS:
            cur.end = cur.start + max_duration
        elif alignment[i - 1].word in _SENTENCE_END_MARKS:
            cur.start = cur.end - max_duration


def _rebalance_post_pause(
    words: list[dict],
    pause_anchor: float,
    median_duration: float,
    max_duration: float,
) -> None:
    """After a long pause (> 4x the median word), the window's leading
    word tends to absorb the silence. Detect the smear — the lead word
    itself over-long, or the lead pair spanning > 2x the bound — then
    re-cut: if the SECOND word is also over-long, move their shared
    boundary to the later of (half its end, end - bound); finally pull
    the lead word's start up to at most `max_duration` before its end."""
    lead = words[0]
    paused = lead["end"] - pause_anchor > median_duration * 4
    lead_smeared = lead["end"] - lead["start"] > max_duration
    pair_smeared = (
        len(words) > 1 and words[1]["end"] - lead["start"] > max_duration * 2
    )
    if not (paused and (lead_smeared or pair_smeared)):
        return
    if len(words) > 1 and words[1]["end"] - words[1]["start"] > max_duration:
        cut = max(words[1]["end"] / 2, words[1]["end"] - max_duration)
        lead["end"] = words[1]["start"] = cut
    lead["start"] = max(0, lead["end"] - max_duration)


def _reconcile_segment_edges(
    piece: dict, words: list[dict], median_duration: float
) -> None:
    """Segment (timestamp-token) boundaries vs edge-word (DTW) boundaries
    disagree at window edges. Policy, per edge: when the segment boundary
    sits INSIDE the edge word but far (> 0.5 s) from the word's own
    boundary, the word is the smeared party — clamp it toward the segment
    time (keeping at least a median-word of duration); otherwise the word
    wins and the segment adopts its boundary."""
    lead, tail = words[0], words[-1]
    seg_start_inside = piece["start"] < lead["end"]
    word_start_far = piece["start"] - 0.5 > lead["start"]
    if seg_start_inside and word_start_far:
        lead["start"] = max(
            0, min(lead["end"] - median_duration, piece["start"])
        )
    else:
        piece["start"] = lead["start"]

    seg_end_inside = piece["end"] > tail["start"]
    word_end_far = piece["end"] + 0.5 < tail["end"]
    if seg_end_inside and word_end_far:
        tail["end"] = max(tail["start"] + median_duration, piece["end"])
    else:
        piece["end"] = tail["end"]


def _reseek_past_hallucination(
    pieces: list[dict],
    threshold: float,
    *,
    time_offset: float,
    window_duration: float,
    window_end_time: float,
    content_frames: int,
    content_duration: float,
    previous_seek: int,
    last_speech_timestamp: float,
) -> tuple[Optional[int], bool]:
    """Hallucinations live in silence: a suspect segment with quiet on
    both sides is noise the decoder invented, so the seek loop should
    jump past the silence (or truncate the window at the suspect) rather
    than commit it. The numeric bounds match the reference's
    hallucination_silence_threshold behavior; the decomposition here is
    two phases — a leading-silence restart check, then a flanked-suspect
    scan over the word-bearing segments.

    Returns (seek_frames, restart). seek_frames is None when no rule
    fired. restart=True: re-decode the window from seek_frames without
    committing anything. restart=False with seek_frames set: `pieces`
    was truncated in place at the suspect; the survivors commit.
    """
    near_edge_s = 2.0  # proximity to a window edge that counts as quiet

    lead = _next_words_segment(pieces)
    if _looks_hallucinated(lead):
        leading_quiet = lead["start"] - time_offset
        if leading_quiet > threshold:
            return (
                previous_seek + round(leading_quiet * FRAMES_PER_SECOND),
                True,
            )

    prev_speech_end = last_speech_timestamp
    for idx, seg in enumerate(pieces):
        if not seg["words"]:
            continue
        if _looks_hallucinated(seg):
            follower = _next_words_segment(pieces[idx + 1:])
            next_speech_start = (
                follower["words"][0]["start"]
                if follower is not None
                else time_offset + window_duration
            )
            quiet_before = (
                seg["start"] - prev_speech_end > threshold
                or seg["start"] < threshold
                or seg["start"] - time_offset < near_edge_s
            )
            quiet_after = (
                next_speech_start - seg["end"] > threshold
                or _looks_hallucinated(follower)
                or window_end_time - seg["end"] < near_edge_s
            )
            if quiet_before and quiet_after:
                seek_frames = round(
                    max(time_offset + 1, seg["start"]) * FRAMES_PER_SECOND
                )
                if content_duration - seg["end"] < threshold:
                    # the suspicion extends to the end of the clip: stop
                    seek_frames = content_frames
                del pieces[idx:]
                return seek_frames, False
        prev_speech_end = seg["end"]
    return None, False


def generate_segments(
    eng: WhisperEngine,
    features: np.ndarray,  # [T, n_mels] full-clip log-mel (log_mel_full)
    options: TranscribeOptions,
    seed: int = 0,
    log_progress: bool = False,
    spec_decoder=None,  # SpeculativeDecoder — draft-accelerated T=0 decodes
) -> tuple[list[Segment], Optional[str], float, Optional[list[tuple[str, float]]]]:
    """The offline seek loop — behavioral port of generate_segments
    (transcriber_faster_whisper.py:1049-1337) over the full-clip feature
    array: clip ranges, windowed decode with temperature fallback, the
    no-speech skip, timestamp segmentation, word-timestamp seek adjustment
    and the hallucination_silence_threshold silence-gap re-seek.

    Returns (segments, language, language_probability, all_language_probs).
    """
    spec = eng.spec
    content_frames = features.shape[0] - 1
    content_duration = float(content_frames / FRAMES_PER_SECOND)

    # chunk_length shortens every seek window (faster-whisper's
    # `chunk_length`: the feature extractor emits shorter windows, the
    # encoder still sees a padded full-context window — here the pad
    # happens in pad_or_trim_frames, so only the stride changes)
    window_frames = mel_ops.N_FRAMES
    if options.chunk_length is not None:
        if not 0 < options.chunk_length <= mel_ops.N_FRAMES // FRAMES_PER_SECOND:
            raise ValueError(
                f"chunk_length must be in (0, 30] seconds, got {options.chunk_length}"
            )
        window_frames = round(options.chunk_length * FRAMES_PER_SECOND)

    clip_ts = options.clip_timestamps
    if isinstance(clip_ts, str):
        clip_ts = [float(t) for t in clip_ts.split(",")] if clip_ts else []
    seek_points = [round(ts * FRAMES_PER_SECOND) for ts in clip_ts]
    if len(seek_points) == 0:
        seek_points.append(0)
    if len(seek_points) % 2 == 1:
        seek_points.append(content_frames)
    seek_clips = list(zip(seek_points[::2], seek_points[1::2]))

    language = options.language
    language_prob = 1.0
    all_language_probs: Optional[list[tuple[str, float]]] = None
    # multi-window initial detection runs up front; the default
    # single-segment probe stays lazy and reuses the first seek window's
    # encoder output (the inline branch below)
    if (
        language is None
        and eng.tokenizer.spec.multilingual
        and options.language_detection_segments > 1
    ):
        language, language_prob, all_language_probs = detect_language_from_features(
            eng,
            features,
            options.language_detection_threshold,
            options.language_detection_segments,
        )
        logger.info("detected language %s (p=%.2f)", language, language_prob)
    clip_idx = 0
    seek = seek_clips[0][0]
    all_segments: list[Segment] = []
    all_tokens: list[int] = []
    prompt_reset_since = 0
    seg_id = 0
    last_speech_timestamp = 0.0

    # initial_prompt seeds the rolling context (generate_segments:1089-1095);
    # build_prompt then sees non-empty previous_tokens and won't re-add it.
    if options.initial_prompt is not None:
        all_tokens.extend(eng.tokenizer.encode(" " + options.initial_prompt.strip()))

    pbar = None
    if log_progress:
        from tqdm import tqdm  # noqa: PLC0415 — optional UI dependency

        pbar = tqdm(
            total=round(content_duration, 2), unit="seconds", dynamic_ncols=True
        )

    while clip_idx < len(seek_clips):
        if pbar is not None:
            pbar.n = min(round(seek / FRAMES_PER_SECOND, 2), pbar.total)
            pbar.refresh()
        seek_clip_start, seek_clip_end = seek_clips[clip_idx]
        seek_clip_end = min(seek_clip_end, content_frames)
        seek = max(seek, seek_clip_start)
        if seek >= seek_clip_end:
            clip_idx += 1
            if clip_idx < len(seek_clips):
                seek = seek_clips[clip_idx][0]
            continue
        time_offset = seek / FRAMES_PER_SECOND
        window_end_time = float((seek + window_frames) / FRAMES_PER_SECOND)
        segment_size = min(
            window_frames, content_frames - seek, seek_clip_end - seek
        )
        segment_duration = segment_size / FRAMES_PER_SECOND
        window = mel_ops.pad_or_trim_frames(features[seek : seek + segment_size])

        enc, cross_kv = eng.prepare_mel(window[None])
        # Speculative serving: the draft shares the teacher's encoder, so
        # its cross-KV is one extra projection of the SAME encoder output
        # (only when the speculative branch below will actually run).
        use_spec = spec_decoder is not None and options.beam_size == 1
        cross_d = spec_decoder.cross_from_enc(enc) if use_spec else None
        if language is None:
            if eng.tokenizer.spec.multilingual:
                codes = eng.tokenizer.spec.language_codes
                (row,) = eng.detect_language_probs_from_cross(cross_kv)
                top = int(np.argmax(row))
                language, language_prob = codes[top], float(row[top])
                all_language_probs = sorted(
                    ((codes[i], float(p)) for i, p in enumerate(row)),
                    key=lambda kv: kv[1],
                    reverse=True,
                )
                logger.info(
                    "detected language %s (p=%.2f)", language, language_prob
                )
            else:
                language = "en"

        # multilingual: re-detect on EVERY window and splice that token into
        # the prompt (code-switched audio; faster-whisper `multilingual`,
        # transcriber_faster_whisper.py:214-222). info.language stays the
        # first detection.
        window_language = language
        if options.multilingual and eng.tokenizer.spec.multilingual:
            (window_language, _), = eng.detect_language_from_cross(cross_kv)

        win_options = options if seek == 0 else dataclasses.replace(
            options, prefix=None
        )
        prompt, sot_idx = eng.build_prompt(
            win_options,
            previous_tokens=all_tokens[prompt_reset_since:],
            language=window_language,
            # initial_prompt is already seeded into all_tokens and
            # conditioning is handled via prompt_reset_since (the
            # reference's exact structure)
            context_preseeded=True,
        )
        if use_spec:
            (result,) = spec_decoder.decode_with_fallback(
                cross_kv, cross_d, prompt, sot_idx, options, seed=seed
            )
        else:
            (result,) = eng.decode_with_fallback(
                cross_kv, [prompt], [sot_idx], options, seed=seed
            )

        # No-speech skip (transcriber_faster_whisper.py:1162-1182): skip on
        # high no-speech prob unless the logprob clears the threshold.
        if options.no_speech_threshold is not None:
            should_skip = result.no_speech_prob > options.no_speech_threshold
            if (
                options.log_prob_threshold is not None
                and result.avg_logprob > options.log_prob_threshold
            ):
                should_skip = False
            if should_skip:
                seek += segment_size
                continue

        previous_seek = seek
        raw_pieces, advance, single_timestamp_ending = (
            split_segments_by_timestamps(
                spec, result.tokens, time_offset, segment_duration, segment_size
            )
        )
        seek += advance
        pieces = [
            {"start": s, "end": e, "tokens": t, "words": None}
            for s, e, t in raw_pieces
        ]

        if options.word_timestamps:
            add_word_timestamps(
                eng, cross_kv, 0, pieces, segment_size, time_offset,
                last_speech_timestamp,
                options.prepend_punctuations, options.append_punctuations,
                language=window_language, task=options.task,
            )
            if not single_timestamp_ending:
                last_word_end = _get_end(pieces)
                if last_word_end is not None and last_word_end > time_offset:
                    new_seek = round(last_word_end * FRAMES_PER_SECOND)
                    # strict progress: when the last word ends a hair past
                    # the window start, round() can land back ON
                    # previous_seek — the same window would re-decode with
                    # the same seed forever (BatchedTranscriber carries
                    # the same guard)
                    if new_seek > previous_seek:
                        seek = new_seek

            # Hallucinations live in silence: re-seek past / truncate at
            # suspect segments flanked by quiet (behavioral contract of
            # the reference's hallucination_silence_threshold rules).
            if options.hallucination_silence_threshold is not None:
                new_seek, restart = _reseek_past_hallucination(
                    pieces,
                    options.hallucination_silence_threshold,
                    time_offset=time_offset,
                    window_duration=segment_duration,
                    window_end_time=window_end_time,
                    content_frames=content_frames,
                    content_duration=content_duration,
                    previous_seek=previous_seek,
                    last_speech_timestamp=last_speech_timestamp,
                )
                if new_seek is not None:
                    seek = new_seek
                    if restart:
                        continue

            last_word_end = _get_end(pieces)
            if last_word_end is not None:
                last_speech_timestamp = last_word_end

        for piece in pieces:
            toks = piece["tokens"]
            text = eng.tokenizer.decode(toks)
            if piece["start"] == piece["end"] or not text.strip():
                continue
            all_tokens.extend(toks)
            seg_id += 1
            all_segments.append(
                Segment(
                    id=seg_id,
                    seek=previous_seek,
                    start=piece["start"],
                    end=piece["end"],
                    text=text,
                    tokens=toks,
                    temperature=result.temperature,
                    avg_logprob=result.avg_logprob,
                    compression_ratio=result.compression_ratio,
                    no_speech_prob=result.no_speech_prob,
                    words=(
                        [Word(**w) for w in piece["words"]]
                        if options.word_timestamps and piece["words"] is not None
                        else None
                    ),
                )
            )

        if (
            not options.condition_on_previous_text
            or result.temperature > options.prompt_reset_on_temperature
        ):
            prompt_reset_since = len(all_tokens)

    if pbar is not None:
        pbar.n = pbar.total
        pbar.refresh()
        pbar.close()
    return all_segments, language, language_prob, all_language_probs


class Transcriber:
    """Sequential (single-request) transcribe API over the engine.

    The streaming server uses the batched scheduler instead; this class
    provides the REST/offline path and the behavioral reference for tests.
    """

    def __init__(self, engine: WhisperEngine, spec_decoder=None):
        """spec_decoder: optional engine.speculative.SpeculativeDecoder —
        T=0 window decodes then run draft-accelerated (token-exact)."""
        self.engine = engine
        self.spec_decoder = spec_decoder

    def transcribe(
        self,
        audio: np.ndarray,
        options: TranscribeOptions | None = None,
        seed: int = 0,
        vad_filter: bool = False,
        vad_parameters: Optional[dict] = None,
        log_progress: bool = False,
    ) -> tuple[list[Segment], TranscriptionInfo]:
        """audio: float32 mono 16 kHz. Returns (segments, info).

        vad_filter collapses silence before decoding and restores original
        timestamps afterwards (WhisperModel.transcribe's vad_filter path,
        transcriber_faster_whisper.py:830-856, 1792-1817).
        """
        options = options or TranscribeOptions()
        if vad_filter:
            from whisperlive_tpu_torch.audio.vad import (
                SpeechTimestampsMap,
                VadOptions,
                collect_chunks,
                get_speech_timestamps,
            )

            full_duration = len(audio) / mel_ops.SAMPLE_RATE
            opts = VadOptions(**(vad_parameters or {}))
            chunks = get_speech_timestamps(audio, opts)
            if not chunks:
                return [], TranscriptionInfo(
                    language=options.language or "en",
                    language_probability=1.0,
                    duration=full_duration,
                    transcription_options=options,
                )
            ts_map = SpeechTimestampsMap(chunks)
            segments, info = self.transcribe(
                collect_chunks(audio, chunks), options, seed=seed,
                log_progress=log_progress,
            )
            for s in segments:
                idx = ts_map.get_chunk_index(s.start)
                s.start = ts_map.get_original_time(s.start, idx)
                s.end = max(ts_map.get_original_time(s.end, idx), s.start)
                if s.words:
                    for w in s.words:
                        wi = ts_map.get_chunk_index(w.start)
                        w.start = ts_map.get_original_time(w.start, wi)
                        w.end = max(ts_map.get_original_time(w.end, wi), w.start)
            return segments, info._replace(duration=full_duration)

        eng = self.engine
        duration = len(audio) / mel_ops.SAMPLE_RATE
        features = mel_ops.log_mel_full(audio, n_mels=eng.cfg.n_mels, device=eng.device)
        segments, language, language_prob, all_probs = generate_segments(
            eng, features, options, seed=seed, log_progress=log_progress,
            spec_decoder=self.spec_decoder,
        )
        info = TranscriptionInfo(
            language=language or "en",
            language_probability=language_prob,
            duration=duration,
            transcription_options=options,
            all_language_probs=all_probs,
        )
        return segments, info

    def detect_language(
        self,
        audio: Optional[np.ndarray] = None,
        features: Optional[np.ndarray] = None,
        vad_filter: bool = False,
        vad_parameters: Optional[dict] = None,
        language_detection_segments: int = 1,
        language_detection_threshold: float = 0.5,
    ) -> tuple[str, float, list[tuple[str, float]]]:
        """Standalone language probe (reference detect_language,
        transcriber_faster_whisper.py:1716-1789): returns (language,
        probability, all_language_probs). Provide `audio` (float32 mono
        16 kHz) or precomputed full-clip `features`; with vad_filter the
        probe runs on silence-collapsed audio."""
        if audio is None and features is None:
            raise ValueError("either audio or features must be provided")
        if audio is not None:
            if vad_filter:
                from whisperlive_tpu_torch.audio.vad import (
                    VadOptions,
                    collect_chunks,
                    get_speech_timestamps,
                )

                opts = VadOptions(**(vad_parameters or {}))
                chunks = get_speech_timestamps(audio, opts)
                if chunks:
                    audio = collect_chunks(audio, chunks)
            audio = audio[
                : language_detection_segments * mel_ops.N_SAMPLES
            ]
            features = mel_ops.log_mel_full(
                audio, n_mels=self.engine.cfg.n_mels, device=self.engine.device
            )
        return detect_language_from_features(
            self.engine,
            features,
            language_detection_threshold,
            language_detection_segments,
        )


class BatchedTranscriber:
    """Offline batched transcription of many files (the capability of the
    reference's BatchedInferencePipeline, transcriber_faster_whisper.py:
    113-571): each file's current 30 s window joins one device batch; files
    advance their seek cursors independently until all are exhausted.

    word_timestamps (options.word_timestamps) aligns each window against
    the batch's device-resident cross-KV and applies the same boundary
    rules as the sequential path (add_word_timestamps); vad_filter
    collapses silence per file before decoding and restores original
    times afterwards. Like the reference's batched pipeline, no
    hallucination re-seek runs here (that is a sequential-seek-loop
    feature, transcriber_faster_whisper.py:1240-1287)."""

    def __init__(self, engine: WhisperEngine):
        self.engine = engine

    def transcribe(
        self,
        audios: list[np.ndarray],
        options: TranscribeOptions | None = None,
        seed: int = 0,
        vad_filter: bool = False,
        vad_parameters: Optional[dict] = None,
    ) -> list[tuple[list[Segment], TranscriptionInfo]]:
        options = options or TranscribeOptions()
        eng = self.engine

        if vad_filter:
            return self._transcribe_vad(
                audios, options, seed=seed, vad_parameters=vad_parameters
            )

        # chunk_length shortens each file's seek windows (reference batched
        # pipeline shares WhisperModel's chunk_length feature extractor)
        window_frames = mel_ops.N_FRAMES
        if options.chunk_length is not None:
            if not 0 < options.chunk_length <= mel_ops.N_FRAMES // FRAMES_PER_SECOND:
                raise ValueError(
                    f"chunk_length must be in (0, 30] seconds, got {options.chunk_length}"
                )
            window_frames = round(options.chunk_length * FRAMES_PER_SECOND)
        window_samples = window_frames * mel_ops.HOP_LENGTH

        n = len(audios)
        seeks = [0] * n
        all_segments: list[list[Segment]] = [[] for _ in range(n)]
        # initial_prompt seeds each file's rolling context, like the
        # sequential loop (reference generate_segments:1089-1095)
        seed_tokens = (
            eng.tokenizer.encode(" " + options.initial_prompt.strip())
            if options.initial_prompt
            else []
        )
        all_tokens: list[list[int]] = [list(seed_tokens) for _ in range(n)]
        languages: list[Optional[str]] = [options.language] * n
        language_probs = [1.0] * n
        seg_ids = [0] * n
        last_speech_ts = [0.0] * n

        def active_items():
            # at most the largest batch bucket at a time; later files wait
            # for a free row (the JAX package overflows the batch instead)
            return [
                i for i in range(n)
                if seeks[i] < int(len(audios[i]) / mel_ops.HOP_LENGTH)
            ][: eng.batch_buckets[-1]]

        while True:
            active = active_items()
            if not active:
                break
            # one window batch: rows of real windows in a bucket of the
            # engine's, from the windows' audio to their segments
            with profiling.span("transcribe.batch", rows=len(active),
                                bucket=_bucket(len(active), eng.batch_buckets)):
                with profiling.span("transcribe.windows"):
                    windows = []
                    for i in active:
                        windows.append(
                            mel_ops.pad_or_trim(
                                audios[i][seeks[i] * mel_ops.HOP_LENGTH :][:window_samples]
                            )
                        )
                    bucket = _bucket(len(active), eng.batch_buckets)
                    batch = np.zeros((bucket, mel_ops.N_SAMPLES), np.float32)
                    for j, w in enumerate(windows):
                        batch[j] = w
                _, cross = eng.prepare(batch)

                window_langs = {}
                detect_all = options.multilingual and eng.tokenizer.spec.multilingual
                if detect_all or any(languages[i] is None for i in active):
                    detected = eng.detect_language_from_cross(cross)
                    for j, i in enumerate(active):
                        if detect_all:
                            # per-window re-detection (faster-whisper
                            # `multilingual`): splice the detected token into
                            # THIS window's prompt; info.language keeps the
                            # first detection.
                            window_langs[i] = detected[j][0]
                        if languages[i] is None:
                            languages[i], language_probs[i] = detected[j]

                prompts, sots = [], []
                for i in active:
                    p, s = eng.build_prompt(
                        options, previous_tokens=all_tokens[i][-224:],
                        language=window_langs.get(i, languages[i]),
                        context_preseeded=True,
                    )
                    prompts.append(p)
                    sots.append(s)
                results = eng.decode_with_fallback(
                    cross, prompts, sots, options, seed=seed
                )

                with profiling.span("transcribe.segments"):
                    for j, i in enumerate(active):
                        res = results[j]
                        content_frames = int(len(audios[i]) / mel_ops.HOP_LENGTH)
                        segment_size = min(window_frames, content_frames - seeks[i])
                        time_offset = seeks[i] * mel_ops.HOP_LENGTH / mel_ops.SAMPLE_RATE
                        window_duration = segment_size * mel_ops.HOP_LENGTH / mel_ops.SAMPLE_RATE
                        skip = (
                            options.no_speech_threshold is not None
                            and res.no_speech_prob > options.no_speech_threshold
                            and (
                                options.log_prob_threshold is None
                                or res.avg_logprob < options.log_prob_threshold
                            )
                        )
                        if skip:
                            seeks[i] += segment_size
                            continue
                        raw_pieces, advance, single_ts_ending = (
                            split_segments_by_timestamps(
                                eng.spec, res.tokens, time_offset, window_duration,
                                segment_size,
                            )
                        )
                        # the window's own cursor, stamped on its segments (the
                        # sequential path and the reference record the pre-advance
                        # seek)
                        window_seek = seeks[i]
                        seeks[i] += advance
                        pieces = [
                            {"start": st, "end": en, "tokens": tk, "words": None}
                            for st, en, tk in raw_pieces
                        ]
                        if options.word_timestamps:
                            add_word_timestamps(
                                eng, cross, j, pieces, segment_size, time_offset,
                                last_speech_ts[i],
                                options.prepend_punctuations,
                                options.append_punctuations,
                                language=window_langs.get(i, languages[i]),
                                task=options.task,
                            )
                            if not single_ts_ending:
                                last_word_end = _get_end(pieces)
                                if last_word_end is not None:
                                    new_seek = round(last_word_end * FRAMES_PER_SECOND)
                                    # strict progress: a rewind to (or before) the
                                    # window start would loop forever
                                    if new_seek > window_seek:
                                        seeks[i] = new_seek
                            last_word_end = _get_end(pieces)
                            if last_word_end is not None:
                                last_speech_ts[i] = last_word_end
                        for piece in pieces:
                            toks = piece["tokens"]
                            text = eng.tokenizer.decode(toks)
                            if not text.strip():
                                continue
                            seg_ids[i] += 1  # ids start at 1, like the sequential path
                            all_segments[i].append(
                                Segment(
                                    id=seg_ids[i], seek=window_seek,
                                    start=piece["start"], end=piece["end"],
                                    text=text, tokens=toks,
                                    temperature=res.temperature,
                                    avg_logprob=res.avg_logprob,
                                    compression_ratio=res.compression_ratio,
                                    no_speech_prob=res.no_speech_prob,
                                    words=(
                                        [Word(**w) for w in piece["words"]]
                                        if options.word_timestamps
                                        and piece["words"] is not None
                                        else None
                                    ),
                                )
                            )
                            # context carries only under condition_on_previous_text
                            # (build_prompt no longer gates preseeded context; the
                            # seeded initial_prompt stays either way)
                            if options.condition_on_previous_text:
                                all_tokens[i].extend(
                                    t for t in toks if t < eng.spec.eot
                                )

        return [
            (
                all_segments[i],
                TranscriptionInfo(
                    language=languages[i] or "en",
                    language_probability=language_probs[i],
                    duration=len(audios[i]) / mel_ops.SAMPLE_RATE,
                    transcription_options=options,
                ),
            )
            for i in range(n)
        ]

    def _transcribe_vad(
        self,
        audios: list[np.ndarray],
        options: TranscribeOptions,
        seed: int,
        vad_parameters: Optional[dict],
    ) -> list[tuple[list[Segment], TranscriptionInfo]]:
        """Per-file silence collapse before the batched decode, original
        timestamps restored afterwards (BatchedInferencePipeline's
        vad_filter capability; restoration semantics shared with
        Transcriber.transcribe's vad path)."""
        from whisperlive_tpu_torch.audio.vad import (
            SpeechTimestampsMap,
            VadOptions,
            collect_chunks,
            get_speech_timestamps,
        )

        opts = VadOptions(**(vad_parameters or {}))
        collapsed: list[np.ndarray] = []
        maps: list[Optional[SpeechTimestampsMap]] = []
        durations = [len(a) / mel_ops.SAMPLE_RATE for a in audios]
        keep_idx: list[int] = []
        for i, audio in enumerate(audios):
            chunks = get_speech_timestamps(audio, opts)
            if not chunks:
                maps.append(None)
                continue
            maps.append(SpeechTimestampsMap(chunks))
            collapsed.append(collect_chunks(audio, chunks))
            keep_idx.append(i)

        decoded = (
            self.transcribe(collapsed, options, seed=seed)
            if collapsed else []
        )
        out: list[tuple[list[Segment], TranscriptionInfo]] = []
        it = iter(zip(keep_idx, decoded))
        next_item = next(it, None)
        for i in range(len(audios)):
            if next_item is None or next_item[0] != i:
                out.append(
                    (
                        [],
                        TranscriptionInfo(
                            language=options.language or "en",
                            language_probability=1.0,
                            duration=durations[i],
                            transcription_options=options,
                        ),
                    )
                )
                continue
            _, (segments, info) = next_item
            ts_map = maps[i]
            for s in segments:
                ci = ts_map.get_chunk_index(s.start)
                s.start = ts_map.get_original_time(s.start, ci)
                s.end = max(ts_map.get_original_time(s.end, ci), s.start)
                if s.words:
                    for w in s.words:
                        wi = ts_map.get_chunk_index(w.start)
                        w.start = ts_map.get_original_time(w.start, wi)
                        w.end = max(ts_map.get_original_time(w.end, wi), w.start)
            out.append((segments, info._replace(duration=durations[i])))
            next_item = next(it, None)
        return out
