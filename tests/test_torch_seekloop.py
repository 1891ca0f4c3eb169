"""The port's generate_segments against the JAX package's on scripted
engines.

The scripted cases of tests/test_seekloop_wordts.py (word-timestamp seek
adjustment, the hallucination re-seeks past leading silence and at a
flanked suspect, clip_timestamps) drive both seek loops with the same
scripted decode results and word alignments, each run with fresh copies
(the boundary rules mutate them). The segments must be equal, field by
field, and so must the windows each loop asked for (the scripts left over).
"""

import copy

import pytest

from tests.test_seekloop_wordts import OPTS, FakeEngine, _features, _res, ts
from whisperlive_tpu.engine import transcribe as jtr
from whisperlive_tpu.engine.align import WordTiming as JWord
from whisperlive_tpu.engine.engine import TranscribeOptions as JOptions
from whisperlive_tpu_torch.engine import transcribe as ttr
from whisperlive_tpu_torch.engine.align import WordTiming as TWord
from whisperlive_tpu_torch.engine.engine import TranscribeOptions as TOptions


def word(cls, text, tok, start, end, p):
    return cls(word=text, tokens=[tok], start=start, end=end, probability=p)


def word_seek(cls):
    return ([_res([ts(0.0), 5, ts(8.0), ts(8.0), 6, 7]), _res([ts(0.0), 9, ts(4.0), ts(4.0)])],
            [[word(cls, " a", 5, 5.4, 6.0, 0.9)], [word(cls, " b", 9, 2.4, 3.0, 0.9)]],
            dict(word_timestamps=True), 9.0)


def leading_silence(cls):
    return ([_res([ts(4.0), 5, 6, ts(5.0), ts(5.0), 7, ts(6.0)]),
             _res([ts(0.0), 9, ts(3.0), ts(3.0)])],
            [[word(cls, " x", 5, 4.0, 4.05, 0.01), word(cls, " y", 6, 4.05, 4.1, 0.01)],
             [word(cls, " ok", 9, 0.5, 2.5, 0.9)]],
            dict(word_timestamps=True, hallucination_silence_threshold=2.0), 6.5)


def flanked_suspect(cls):
    return ([_res([ts(0.0), 5, ts(2.0), ts(2.0), ts(10.0), 6, ts(10.4), ts(10.4), 7,
                   ts(12.0)]),
             _res([ts(0.0), 9, ts(2.0)])],
            [[word(cls, " good", 5, 0.2, 1.8, 0.9), word(cls, " bad", 6, 10.0, 10.05, 0.01),
              word(cls, " bad2", 7, 10.4, 10.45, 0.01)],
             [word(cls, " z", 9, 0.1, 1.5, 0.9)]],
            dict(word_timestamps=True, hallucination_silence_threshold=2.0), 15.0)


def clip_timestamps(cls):
    return [_res([ts(0.0), 5, ts(4.0)])], [], dict(clip_timestamps="2,6"), 30.0


SCRIPTS = {"word_seek": word_seek, "leading_silence": leading_silence,
           "flanked_suspect": flanked_suspect, "clip_timestamps": clip_timestamps}


def run(mod, options_cls, word_cls, script):
    decodes, alignments, opts, seconds = script(word_cls)
    eng = FakeEngine(copy.deepcopy(decodes), alignments)
    opts = options_cls(**{**OPTS.__dict__, **opts})
    out = mod.generate_segments(eng, _features(seconds), opts)
    return out, len(eng.decodes), len(eng.alignments)


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_scripted_seek_loop_matches_jax(name):
    (jsegs, jlang, jp, _), jleft, jaleft = run(jtr, JOptions, JWord, SCRIPTS[name])
    (tsegs, tlang, tp, _), tleft, taleft = run(ttr, TOptions, TWord, SCRIPTS[name])
    assert (tleft, taleft) == (jleft, jaleft)
    assert (tlang, tp) == (jlang, jp)
    assert len(tsegs) == len(jsegs) > 0
    for a, b in zip(jsegs, tsegs):
        words = [(w.word, w.start, w.end, w.probability) for w in b.words or []]
        assert words == [(w.word, w.start, w.end, w.probability) for w in a.words or []]
        assert (b.id, b.seek, b.start, b.end, b.text, list(b.tokens)) == (
            a.id, a.seek, a.start, a.end, a.text, list(a.tokens))


def test_word_seek_adjustment_rewinds_to_last_word_end():
    """The second window starts at the last aligned word's end (6.0 s), not
    at the last closed timestamp (8.0 s)."""
    (segments, *_), _, _ = run(ttr, TOptions, TWord, word_seek)
    assert segments[0].words[0].end == pytest.approx(6.0)
    assert segments[1].seek == 600
    assert segments[1].start == pytest.approx(8.4)


def test_hallucination_reseeks_drop_the_suspects():
    (segments, *_), _, _ = run(ttr, TOptions, TWord, leading_silence)
    assert all("w5" not in s.text and "w6" not in s.text for s in segments)
    assert segments[0].seek == 400  # re-seeked past the 4 s of leading silence
    (segments, *_), _, _ = run(ttr, TOptions, TWord, flanked_suspect)
    texts = [s.text for s in segments]
    assert any("w5" in t for t in texts)
    assert all("w6" not in t and "w7" not in t for t in texts)
    assert segments[1].seek == 1000  # the suspect's start


def test_clip_timestamps_decode_one_window():
    (segments, *_), left, _ = run(ttr, TOptions, TWord, clip_timestamps)
    assert left == 0
    assert segments[0].seek == 200
    assert (segments[0].start, segments[0].end) == (pytest.approx(2.0), pytest.approx(6.0))
