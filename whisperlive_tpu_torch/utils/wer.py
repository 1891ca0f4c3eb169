"""Word-error-rate scoring and error analysis.

The reference bundles an icefall-derived `write_error_stats` built on the
kaldialign C++ wheel (whisper_live/transcriber/tensorrt_utils.py:216-364);
this is the zero-dependency equivalent: a numpy Levenshtein aligner plus
an error report with the same analysis surface — corpus WER, error
breakdown (ins/del/sub/correct), per-utterance diffs, ranked
substitution/deletion/insertion tables, and per-word statistics. It is
the measurement half of the WER harness (scripts can feed it
reference/hypothesis pairs once real weights+audio exist; tests feed it
synthetic pairs with known edit distances).

The port's copy of whisperlive_tpu/utils/wer.py.
"""

from __future__ import annotations

import dataclasses
import re
from collections import Counter
from typing import Iterable, Optional, Sequence, TextIO

import numpy as np

GAP = "*"  # rendered placeholder for an insertion/deletion slot

_PUNCT = re.compile(r"[^\w\s']", re.UNICODE)


def normalize_text(text: str) -> list[str]:
    """Whisper-style scoring normalization: casefold, strip punctuation
    (apostrophes kept — contractions are words), split on whitespace."""
    return _PUNCT.sub(" ", text.casefold()).split()


def align(ref: Sequence[str], hyp: Sequence[str]) -> list[tuple[Optional[str], Optional[str]]]:
    """Minimum-edit alignment of two word sequences.

    Returns (ref_word, hyp_word) pairs in order; None marks the empty side
    of an insertion (None, hyp_word) or deletion (ref_word, None). Unit
    costs; on ties substitution is preferred over ins+del (standard WER
    convention, matches kaldialign's counts).
    """
    n, m = len(ref), len(hyp)
    # DP over the (n+1) x (m+1) grid, vectorized per anti-diagonal row
    cost = np.empty((n + 1, m + 1), np.int32)
    cost[0, :] = np.arange(m + 1)
    cost[:, 0] = np.arange(n + 1)
    hyp_arr = np.asarray(hyp, dtype=object)
    for i in range(1, n + 1):
        neq = (hyp_arr != ref[i - 1]).astype(np.int32)
        row, prev = cost[i], cost[i - 1]
        # the row has a left-to-right dependency; keep the hot loop small
        acc = row[0]
        for j in range(1, m + 1):
            acc = min(prev[j] + 1, acc + 1, prev[j - 1] + neq[j - 1])
            row[j] = acc
    # backtrace, preferring diagonal moves (substitution/match) on ties
    out: list[tuple[Optional[str], Optional[str]]] = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and cost[i, j] == cost[i - 1, j - 1] + int(
            ref[i - 1] != hyp[j - 1]
        ):
            out.append((ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and cost[i, j] == cost[i - 1, j] + 1:
            out.append((ref[i - 1], None))
            i -= 1
        else:
            out.append((None, hyp[j - 1]))
            j -= 1
    out.reverse()
    return out


@dataclasses.dataclass
class ErrorStats:
    """Aggregated alignment errors over a result set."""

    insertions: int = 0
    deletions: int = 0
    substitutions: int = 0
    correct: int = 0
    ref_words: int = 0
    # ranked analysis tables
    sub_pairs: Counter = dataclasses.field(default_factory=Counter)
    ins_words: Counter = dataclasses.field(default_factory=Counter)
    del_words: Counter = dataclasses.field(default_factory=Counter)
    # word -> [correct, sub_as_ref, sub_as_hyp, inserted, deleted]
    per_word: dict = dataclasses.field(default_factory=dict)

    @property
    def errors(self) -> int:
        return self.insertions + self.deletions + self.substitutions

    @property
    def wer(self) -> float:
        return self.errors / self.ref_words if self.ref_words else 0.0

    def _word(self, w: str) -> list[int]:
        return self.per_word.setdefault(w, [0, 0, 0, 0, 0])

    def add_pair(self, ref_w: Optional[str], hyp_w: Optional[str]) -> None:
        if ref_w is None:
            self.insertions += 1
            self.ins_words[hyp_w] += 1
            self._word(hyp_w)[3] += 1
            return
        self.ref_words += 1
        if hyp_w is None:
            self.deletions += 1
            self.del_words[ref_w] += 1
            self._word(ref_w)[4] += 1
        elif hyp_w != ref_w:
            self.substitutions += 1
            self.sub_pairs[(ref_w, hyp_w)] += 1
            self._word(ref_w)[1] += 1
            self._word(hyp_w)[2] += 1
        else:
            self.correct += 1
            self._word(ref_w)[0] += 1


def score(
    results: Iterable[tuple[str, Sequence[str] | str, Sequence[str] | str]],
    normalize: bool = False,
) -> ErrorStats:
    """Score (utt_id, reference, hypothesis) triples; strings are split
    (or normalized when normalize=True), pre-tokenized lists pass through."""
    stats = ErrorStats()
    for _utt, ref, hyp in results:
        ref_t = _tokens(ref, normalize)
        hyp_t = _tokens(hyp, normalize)
        for ref_w, hyp_w in align(ref_t, hyp_t):
            stats.add_pair(ref_w, hyp_w)
    return stats


def _tokens(text, normalize: bool) -> list[str]:
    if not isinstance(text, str):
        return list(text)
    return normalize_text(text) if normalize else text.split()


def _render_utt(ref_t: Sequence[str], hyp_t: Sequence[str]) -> str:
    """Inline diff: matched words verbatim, errors as (ref->hyp) with `*`
    on the empty side; adjacent errors merge into one parenthesized span
    so a shifted phrase reads as one edit."""
    spans: list[tuple[list[str], list[str], bool]] = []  # (ref, hyp, is_err)
    for ref_w, hyp_w in align(ref_t, hyp_t):
        err = ref_w != hyp_w
        if spans and spans[-1][2] == err and err:
            spans[-1][0].extend([ref_w] if ref_w else [])
            spans[-1][1].extend([hyp_w] if hyp_w else [])
        else:
            spans.append((
                [ref_w] if ref_w else [],
                [hyp_w] if hyp_w else [],
                err,
            ))
    parts = []
    for ref_side, hyp_side, err in spans:
        if not err:
            parts.extend(ref_side)
        else:
            parts.append(
                f"({' '.join(ref_side) or GAP}->{' '.join(hyp_side) or GAP})"
            )
    return " ".join(parts)


def write_error_stats(
    f: TextIO,
    name: str,
    results: Sequence[tuple[str, str, str]],
    normalize: bool = False,
    top_k: int = 30,
) -> float:
    """Write the full error report for (utt_id, ref, hyp) triples and
    return the corpus WER (the reference's write_error_stats surface:
    %WER, error counts, per-utt diffs, ranked error tables, per-word
    stats — tensorrt_utils.py:216-364, re-expressed)."""
    stats = score(results, normalize=normalize)
    print(f"[{name}] %WER = {100.0 * stats.wer:.2f}", file=f)
    print(
        f"Errors: {stats.insertions} insertions, {stats.deletions} "
        f"deletions, {stats.substitutions} substitutions, over "
        f"{stats.ref_words} reference words ({stats.correct} correct)",
        file=f,
    )
    print("\nPER-UTT DETAILS: matched words verbatim, errors as (ref->hyp)",
          file=f)
    for utt, ref, hyp in results:
        print(
            f"{utt}:\t"
            + _render_utt(_tokens(ref, normalize), _tokens(hyp, normalize)),
            file=f,
        )
    print("\nSUBSTITUTIONS: count ref -> hyp", file=f)
    for (r, h), c in stats.sub_pairs.most_common(top_k):
        print(f"{c}  {r} -> {h}", file=f)
    print("\nDELETIONS: count word", file=f)
    for w, c in stats.del_words.most_common(top_k):
        print(f"{c}  {w}", file=f)
    print("\nINSERTIONS: count word", file=f)
    for w, c in stats.ins_words.most_common(top_k):
        print(f"{c}  {w}", file=f)
    print("\nPER-WORD STATS: word corr sub-as-ref sub-as-hyp ins del",
          file=f)
    for w, (corr, sref, shyp, ins_c, del_c) in sorted(
        stats.per_word.items(),
        key=lambda kv: -(kv[1][1] + kv[1][2] + kv[1][3] + kv[1][4]),
    )[:top_k]:
        print(f"{w}  {corr} {sref} {shyp} {ins_c} {del_c}", file=f)
    return stats.wer


def main(argv: Optional[list[str]] = None) -> None:
    """`python -m whisperlive_tpu_torch.utils.wer ref.txt hyp.txt` — line-paired
    transcript files (line i of each file is one utterance)."""
    import argparse
    import sys

    parser = argparse.ArgumentParser(description="WER report")
    parser.add_argument("ref")
    parser.add_argument("hyp")
    parser.add_argument("--normalize", action="store_true",
                        help="casefold + strip punctuation before scoring")
    args = parser.parse_args(argv)
    with open(args.ref) as fr, open(args.hyp) as fh:
        refs = [line.rstrip("\n") for line in fr]
        hyps = [line.rstrip("\n") for line in fh]
    results = [
        (f"utt{i}", r, h)
        for i, (r, h) in enumerate(zip(refs, hyps))
    ]
    write_error_stats(sys.stdout, "cli", results, normalize=args.normalize)


if __name__ == "__main__":
    main()
