"""Word-level timestamps: cross-attention DTW alignment.

The reference calls CTranslate2's C++ `model.align` and post-processes in
Python (transcriber_faster_whisper.py:1515-1714). Here the decoder itself
returns cross-attention maps (models/whisper.py decode_with_cross_attn —
one extra teacher-forced pass over the already-computed cross-KV), and the
sequential DTW runs on host in numpy, per segment, off the device hot path.

Pipeline (openai-whisper semantics):
  1. teacher-forced forward over [sot-seq + text tokens + eot]
  2. take cross-attention of the alignment heads (upper half of decoder
     layers when no model-specific head list is available)
  3. normalize per head over time, median-filter (width 7), average heads
  4. DTW over -matrix -> monotone token/frame path
  5. token boundaries -> word boundaries via tokenizer.split_to_word_tokens
  6. merge leading/trailing punctuation into neighboring words
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Sequence

import numpy as np

from whisperlive_tpu_torch.engine.transcribe import Word

logger = logging.getLogger(__name__)

TOKENS_PER_SECOND = 50  # encoder positions per second / 1 (0.02 s per pos)


def dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotone DTW trace through a [N_text, N_frames] cost matrix
    (port of whisper's dtw_cpu)."""
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf, np.float64)
    trace = np.zeros((n + 1, m + 1), np.int8)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        row_cost = cost[i - 1]
        for j in range(1, m + 1):
            c0 = acc[i - 1, j - 1]
            c1 = acc[i - 1, j]
            c2 = acc[i, j - 1]
            if c0 <= c1 and c0 <= c2:
                acc[i, j] = c0 + row_cost[j - 1]
                trace[i, j] = 0
            elif c1 <= c2:
                acc[i, j] = c1 + row_cost[j - 1]
                trace[i, j] = 1
            else:
                acc[i, j] = c2 + row_cost[j - 1]
                trace[i, j] = 2
    i, j = n, m
    text_idx, time_idx = [], []
    while i > 0 and j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(text_idx[::-1]), np.array(time_idx[::-1])


def _median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Median filter along the last axis (reflect padding)."""
    if width <= 1 or x.shape[-1] <= width:
        return x
    from scipy.ndimage import median_filter

    size = [1] * (x.ndim - 1) + [width]
    return median_filter(x, size=size, mode="reflect")


@dataclasses.dataclass
class WordTiming:
    word: str
    tokens: list[int]
    start: float
    end: float
    probability: float


def find_alignment_from_attn(
    cross_attn: np.ndarray,  # [L, H, T_tokens, n_audio_ctx] for ONE item
    token_probs: np.ndarray,  # [T_tokens] per-token probability
    tokenizer,
    text_tokens: Sequence[int],
    sot_len: int,
    num_frames: int,
    median_filter_width: int = 7,
) -> list[WordTiming]:
    """Turn cross-attention maps into word timings for one segment."""
    n_layers = cross_attn.shape[0]
    # alignment heads: all heads of the upper half of layers (fallback used
    # when no model-specific head list ships with the checkpoint)
    weights = cross_attn[n_layers // 2 :]
    weights = weights.reshape(-1, *cross_attn.shape[2:])  # [heads, T, ctx]
    # only frames covered by actual audio; input_stride=2 mel frames/pos
    weights = weights[:, :, : max(num_frames // 2, 1)]

    # per-head normalization over time, then smooth + average
    std = weights.std(axis=-1, keepdims=True) + 1e-8
    mean = weights.mean(axis=-1, keepdims=True)
    weights = (weights - mean) / std
    weights = _median_filter(weights, median_filter_width)
    matrix = weights.mean(axis=0)  # [T_tokens, frames]
    matrix = matrix[sot_len - 1 : -1]  # rows predicting text tokens + eot

    if matrix.shape[0] == 0 or matrix.shape[1] == 0:
        return []
    text_indices, time_indices = dtw_path(-matrix.astype(np.float64))

    words, word_tokens = tokenizer.split_to_word_tokens(
        list(text_tokens) + [tokenizer.eot]
    )
    if not words:
        return []
    # K+1 boundaries over ALL word groups, leading 0 (dtype=int matters:
    # cumsum of an empty list is float64 and poisons index arithmetic)
    word_boundaries = np.cumsum([len(t) for t in word_tokens], dtype=np.int64)
    word_boundaries = np.concatenate([np.zeros(1, np.int64), word_boundaries])

    jumps = np.diff(text_indices, prepend=-1) > 0
    jump_times = time_indices[jumps] / TOKENS_PER_SECOND
    if len(jump_times) < word_boundaries[-1] + 1:
        pad = np.full(word_boundaries[-1] + 1 - len(jump_times),
                      jump_times[-1] if len(jump_times) else 0.0)
        jump_times = np.concatenate([jump_times, pad])

    start_times = jump_times[word_boundaries[:-1]]
    end_times = jump_times[np.minimum(word_boundaries[1:], len(jump_times) - 1)]

    # per-word probability from token probs
    probs = np.asarray(token_probs, np.float64)
    timings = []
    tok_pos = 0
    for w, toks, t0, t1 in zip(words[:-1] if words[-1] == "" else words,
                               word_tokens, start_times, end_times):
        seg_probs = probs[tok_pos : tok_pos + len(toks)]
        tok_pos += len(toks)
        if all(t >= tokenizer.eot for t in toks):
            continue
        timings.append(
            WordTiming(
                word=w,
                tokens=list(toks),
                start=float(round(t0, 2)),
                end=float(round(t1, 2)),
                probability=float(seg_probs.mean()) if len(seg_probs) else 0.0,
            )
        )
    return timings


_PREPEND_PUNCT = "\"'“¿([{-"
_APPEND_PUNCT = "\"'.。,，!！?？:：”)]}、"


def merge_punctuations(
    words: list[WordTiming],
    prepend: str = _PREPEND_PUNCT,
    append: str = _APPEND_PUNCT,
) -> list[WordTiming]:
    """Merge leading/trailing punctuation into neighbors
    (transcriber_faster_whisper.py merge_punctuations semantics; the
    punctuation sets are per-request options upstream —
    prepend/append_punctuations, defaults identical to the reference)."""
    # prepend punctuation attaches to the following word
    i = len(words) - 2
    j = len(words) - 1
    while i >= 0:
        prev, cur = words[i], words[j]
        if prev.word.startswith(" ") and prev.word.strip() in prepend:
            cur.word = prev.word + cur.word
            cur.tokens = prev.tokens + cur.tokens
            cur.start = prev.start
            prev.tokens = []
        else:
            j = i
        i -= 1
    # append punctuation attaches to the preceding word
    i, j = 0, 1
    while j < len(words):
        prev, cur = words[i], words[j]
        if not prev.word.endswith(" ") and cur.word in append:
            prev.word = prev.word + cur.word
            prev.tokens = prev.tokens + cur.tokens
            prev.end = cur.end
            cur.tokens = []
        else:
            i = j
        j += 1
    return [w for w in words if w.tokens]


_PUNCT_ONLY = set('"\'.。,，!！?？:：")]}、 ')


def word_anomaly_score(word) -> float:
    """Suspiciousness of one aligned word (hallucination heuristic,
    transcriber_faster_whisper.py:1189-1290 semantics): low probability,
    impossibly short, or absurdly long words score up."""
    probability = getattr(word, "probability", 1.0)
    duration = word.end - word.start
    score = 0.0
    if probability < 0.15:
        score += 1.0
    if duration < 0.133:
        score += (0.133 - duration) * 15.0
    if duration > 2.0:
        score += duration - 2.0
    return score


def is_segment_anomaly(words) -> bool:
    """True if a segment's words look hallucinated (first 8 content words
    scoring >= 3, or nearly every word anomalous)."""
    if not words:
        return False
    content = [w for w in words if w.word.strip() not in _PUNCT_ONLY][:8]
    if not content:
        return False
    score = sum(word_anomaly_score(w) for w in content)
    return score >= 3.0 or score + 0.01 >= len(content)


def words_for_segment(
    timings: list[WordTiming], seg_start: float, seg_end: float
) -> list[Word]:
    """Clip aligned words to a segment's [start, end) window."""
    out = []
    for t in timings:
        if t.end <= seg_start or t.start >= seg_end:
            continue
        out.append(
            Word(
                start=max(t.start, seg_start),
                end=min(t.end, seg_end) if t.end > t.start else t.end,
                word=t.word,
                probability=t.probability,
            )
        )
    return out
