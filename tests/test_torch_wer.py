"""The port's WER scoring (utils/wer.py) and harness (cli/eval_wer.py)
against the JAX package's.

Over hypothesis-drawn sentence pairs (words from a small vocabulary with
case and punctuation, so normalization, substitutions, insertions and
deletions all occur) the two `write_error_stats` reports are byte-equal,
with and without normalization, and so are `align` and the `score` counts;
the line-paired CLI prints the same report. `run_eval` with each
package's FakeBackend, each through its own server and client over real
websockets, returns equal dicts and writes equal SRT files; the port's
loopback transport (the same messages in-process) returns the same dict,
and the port's CLI runs the harness from its flags.
"""

import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from whisperlive_tpu.serving.backends import FakeBackend as JFake
from whisperlive_tpu.utils import wer as jwer
from whisperlive_tpu_torch.audio.io import write_wav
from whisperlive_tpu_torch.cli import eval_wer
from whisperlive_tpu_torch.serving.backends import FakeBackend as TFake
from whisperlive_tpu_torch.utils import wer as twer

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import eval_wer as jeval  # noqa: E402

WORDS = ["the", "The", "cat", "cat,", "sat", "on", "mat.", "don't", "Don't", "a", "A!", "x"]
sentence = st.lists(st.sampled_from(WORDS), max_size=12).map(" ".join)


@settings(max_examples=150, deadline=None, database=None)
@given(st.lists(st.tuples(sentence, sentence), min_size=1, max_size=4), st.booleans())
def test_reports_are_byte_equal_to_jax(pairs, normalize):
    results = [(f"u{i}", r, h) for i, (r, h) in enumerate(pairs)]
    outs = []
    for mod in (jwer, twer):
        f = io.StringIO()
        wer = mod.write_error_stats(f, "t", results, normalize=normalize, top_k=5)
        stats = mod.score(results, normalize=normalize)
        outs.append((f.getvalue(), wer, stats.insertions, stats.deletions, stats.substitutions,
                     stats.correct, stats.ref_words, dict(stats.per_word),
                     [mod.align(mod._tokens(r, normalize), mod._tokens(h, normalize))
                      for _, r, h in results]))
    assert outs[1] == outs[0]


def test_cli_prints_the_same_report(tmp_path, capsys):
    ref, hyp = tmp_path / "ref.txt", tmp_path / "hyp.txt"
    ref.write_text("And so, my fellow Americans\nask not\n")
    hyp.write_text("and so my fellow american\nask what not\n")
    reports = []
    for mod in (jwer, twer):
        mod.main([str(ref), str(hyp), "--normalize"])
        reports.append(capsys.readouterr().out)
    assert reports[1] == reports[0] and "%WER" in reports[0]


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = tmp_path_factory.mktemp("wer") / "eval.wav"
    audio = (0.1 * np.sin(2 * np.pi * 300 * np.arange(32000) / 16000)).astype(np.float32)
    write_wav(str(path), audio)
    return str(path)


def test_run_eval_matches_the_jax_harness(wav, tmp_path):
    """Each harness on its own package's FakeBackend: the same result dict
    (the SRT path aside) and the same SRT file."""
    kw = dict(audio=wav, ref_text="word0 word1", use_vad=False)
    ref = jeval.run_eval(backend=JFake(), out_srt=str(tmp_path / "j.srt"), **kw)
    out = eval_wer.run_eval(backend=TFake(), out_srt=str(tmp_path / "t.srt"), **kw)
    assert (tmp_path / "t.srt").read_text() == (tmp_path / "j.srt").read_text()
    assert ref.pop("srt") != out.pop("srt")
    assert out == ref
    assert out["ref_words"] == 2 and "word0" in out["hypothesis"]

    loop = eval_wer.run_eval(backend=TFake(), out_srt=str(tmp_path / "l.srt"),
                             transport="loopback", **kw)
    loop.pop("srt")
    assert loop == out
    assert (tmp_path / "l.srt").read_text() == (tmp_path / "t.srt").read_text()
    with pytest.raises(ValueError, match="transport"):
        eval_wer.run_eval(backend=TFake(), transport="pigeon", **kw)


def test_cli_runs_the_harness_from_its_flags(wav, tmp_path, capsys):
    """--audio is required; the server flags after "--" build the backend
    as the server CLI does (here FakeBackend), and the exit code is the
    threshold's verdict."""
    with pytest.raises(SystemExit):
        eval_wer.main([])
    capsys.readouterr()
    rc = eval_wer.main(["--audio", wav, "--ref_text", "word0 partial", "--no_vad",
                        "--out_srt", str(tmp_path / "c.srt"), "--transport", "loopback",
                        "--", "--fake_transcriber"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["reference"] == "word0 partial" and result["srt"] == str(tmp_path / "c.srt")
    assert rc == (0 if result["pass"] else 1)
    assert eval_wer.JFK_GROUND_TRUTH == jeval.JFK_GROUND_TRUTH
