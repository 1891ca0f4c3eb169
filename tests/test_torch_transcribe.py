"""The port's offline seek loop against the JAX package's.

Transcriber (generate_segments over log_mel_full features, prepare_mel per
seek window), detect_language and BatchedTranscriber, on the narrow engine
of tests/test_transcriber.py (80 mels, vocab 51865, 1500 encoder positions,
width 64, 4 heads, 2 + 2 layers) with int8 decoder weights and int8
cross-KV, the JAX init_params carried over with from_jax_params; both sides
run on the CPU in float32. A tokenizer that decodes each text token to a
visible word, and makes each its own word, gives random weights segment
text and word timings on both sides. Stated tolerances: segments equal
(start, end, text, tokens, seek), words equal up to 1e-6 s and their
probabilities within 1e-4; language probabilities within 1e-5; log_mel_full
within 1e-4 (float32 sums in another order); encoder states within 1e-4 and
int8 cross-KV codes off by at most one in at most 1e-4 of them.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke

from whisperlive_tpu.engine import tokenizer as jtok
from whisperlive_tpu.engine import transcribe as jtr
from whisperlive_tpu.engine.engine import TranscribeOptions as JOptions
from whisperlive_tpu.engine.engine import WhisperEngine as JEngine
from whisperlive_tpu.engine.speculative import SpeculativeDecoder as JSpec
from whisperlive_tpu.models import whisper as jw
from whisperlive_tpu.ops import mel as jmel
from whisperlive_tpu_torch.audio.vad import VadOptions, get_speech_timestamps
from whisperlive_tpu_torch.engine import tokenizer as ttok
from whisperlive_tpu_torch.engine import transcribe as ttr
from whisperlive_tpu_torch.engine.engine import TranscribeOptions as TOptions
from whisperlive_tpu_torch.engine.engine import WhisperEngine as TEngine
from whisperlive_tpu_torch.engine.speculative import SpeculativeDecoder as TSpec
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.models.bridge import from_jax_params
from whisperlive_tpu_torch.ops import mel as tmel

torch.set_num_threads(2)

DIMS = dict(
    n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
    n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)
# random weights fail every gate: greedy, one attempt, no skip
GREEDY = dict(temperatures=(0.0,), log_prob_threshold=None, no_speech_threshold=None,
              compression_ratio_threshold=None, max_new_tokens=24)


class _Visible:
    """Each text token decodes to, and is, the word " t<id>"."""

    def decode(self, tokens):
        return "".join(f" t{int(t)}" for t in tokens if int(t) < self.spec.eot)

    def split_to_word_tokens(self, tokens):
        text = [int(t) for t in tokens if int(t) < self.spec.eot]
        return [f" t{t}" for t in text], [[t] for t in text]


class JVisible(_Visible, jtok.WhisperTokenizer):
    pass


class TVisible(_Visible, ttok.WhisperTokenizer):
    pass


@functools.lru_cache(maxsize=None)
def engines():
    """(JAX engine, port engine) on the same parameters."""
    jcfg, tcfg = jw.WhisperConfig(**DIMS), tw.WhisperConfig(**DIMS)
    jp = jw.init_params(jcfg, 0)
    kw = dict(decoder_int8=True, cross_kv_bits=8, batch_buckets=(1, 2, 4))
    je = JEngine(jcfg, jp, compute_dtype=jnp.float32,
                 tokenizer=JVisible(jtok.TokenSpec(51865, multilingual=True)), **kw)
    te = TEngine(tcfg, from_jax_params(jax.tree.map(np.asarray, jp)), device="cpu",
                 tokenizer=TVisible(ttok.TokenSpec(51865, multilingual=True)), **kw)
    return je, te


def speech_like(seconds, seed=0):
    t = np.arange(int(16000 * seconds)) / 16000.0
    rng = np.random.default_rng(seed)
    f0 = 140 + 40 * np.sin(2 * np.pi * 2.1 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
    sig = sig * (0.55 + 0.45 * np.sin(2 * np.pi * 3.7 * t)) + 0.02 * rng.standard_normal(t.shape)
    return (0.12 * sig / np.max(np.abs(sig))).astype(np.float32)


def with_gap(seed=3):
    """Speech, 10 s of silence, speech: the VAD collapses the gap."""
    return np.concatenate([speech_like(6.0, seed), np.zeros(160000, np.float32),
                           speech_like(5.0, seed + 1)])


def assert_same_segments(jsegs, tsegs):
    assert len(tsegs) == len(jsegs)
    for a, b in zip(jsegs, tsegs):
        assert (b.id, b.seek, b.text, list(b.tokens)) == (a.id, a.seek, a.text, list(a.tokens))
        assert b.start == pytest.approx(a.start, abs=1e-6)
        assert b.end == pytest.approx(a.end, abs=1e-6)
        assert b.temperature == a.temperature
        assert abs(b.avg_logprob - a.avg_logprob) <= 1e-4
        assert abs(b.no_speech_prob - a.no_speech_prob) <= 1e-4
        assert (a.words is None) == (b.words is None)
        for wa, wb in zip(a.words or [], b.words or []):
            assert wb.word == wa.word
            assert wb.start == pytest.approx(wa.start, abs=1e-6)
            assert wb.end == pytest.approx(wa.end, abs=1e-6)
            assert abs(wb.probability - wa.probability) <= 1e-4
        assert len(a.words or []) == len(b.words or [])


def assert_same_info(jinfo, tinfo):
    assert tinfo.language == jinfo.language
    assert tinfo.duration == pytest.approx(jinfo.duration)
    assert abs(tinfo.language_probability - jinfo.language_probability) <= 1e-5
    assert (jinfo.all_language_probs is None) == (tinfo.all_language_probs is None)
    if jinfo.all_language_probs:
        ja, ta = dict(jinfo.all_language_probs), dict(tinfo.all_language_probs)
        assert set(ta) == set(ja)
        np.testing.assert_allclose([ta[k] for k in ja], [ja[k] for k in ja], atol=1e-5)


CASES = {
    # 35 s: two seek windows, the second prompt carries the first's text
    "two_windows": (dict(language="en"), {}, 35.0),
    "chunk_length": (dict(language="en", chunk_length=10), {}, 25.0),
    "clip_timestamps": (dict(language="en", clip_timestamps="3,9.5,14,20"), {}, 25.0),
    "word_timestamps": (dict(language="en", word_timestamps=True), {}, 35.0),
    "vad_filter": (dict(language="en"), dict(vad_filter=True), "gap"),
    "vad_all_silence": (dict(language="en"), dict(vad_filter=True), "silence"),
    # language detected on the first window, initial prompt seeded
    "detect_and_prompt": (dict(initial_prompt="hello there"), {}, 12.0),
    # the fallback cascade with failing gates, deterministic at T = 0
    "fallback": (dict(language="en", temperatures=(0.0, 0.0), log_prob_threshold=-1.0,
                      no_speech_threshold=None), {}, 12.0),
}


def case_audio(kind):
    if kind == "gap":
        return with_gap()
    if kind == "silence":
        return np.zeros(16000 * 8, np.float32)
    return speech_like(kind, 1)


def options(mod_options, opts):
    return mod_options(**{**GREEDY, **opts})


@pytest.mark.parametrize("case", list(CASES))
def test_transcriber_matches_jax(case):
    opts, kw, kind = CASES[case]
    je, te = engines()
    audio = case_audio(kind)
    jsegs, jinfo = jtr.Transcriber(je).transcribe(audio, options(JOptions, opts), **kw)
    tsegs, tinfo = ttr.Transcriber(te).transcribe(audio, options(TOptions, opts), **kw)
    assert_same_segments(jsegs, tsegs)
    assert_same_info(jinfo, tinfo)
    if kind == "silence":
        assert tsegs == []
    else:
        assert tsegs, "random weights still give visible text"
    if case == "vad_filter":
        # timestamps are restored to the original timeline: no segment
        # starts inside the silence the VAD removed
        first, second = get_speech_timestamps(audio, VadOptions())
        gap = (first["end"] / 16000, second["start"] / 16000)
        assert tsegs and not any(gap[0] < s.start < gap[1] for s in tsegs)
    if opts.get("word_timestamps"):
        words = [w for s in tsegs for w in s.words]
        assert words and all(s.start <= w.start <= w.end <= s.end + 1e-6
                             for s in tsegs for w in s.words)


def test_speculative_transcriber_matches_jax():
    """A self-draft SpeculativeDecoder on the seek loop: the T = 0 windows
    decode speculatively, token-exact against the JAX package and against
    the port's plain seek loop."""
    je, te = engines()
    audio = speech_like(35.0, 2)
    opts = dict(language="en")
    jsegs, _ = jtr.Transcriber(je, JSpec(je, je, k=4)).transcribe(audio, options(JOptions, opts))
    spec = TSpec(te, te, k=4)
    tsegs, _ = ttr.Transcriber(te, spec).transcribe(audio, options(TOptions, opts))
    assert_same_segments(jsegs, tsegs)
    assert spec.stats["windows"] >= 2 and spec.acceptance_rate() > 0.5
    plain, _ = ttr.Transcriber(te).transcribe(audio, options(TOptions, opts))
    assert_same_segments(plain, tsegs)


def test_detect_language_matches_jax():
    """Multi-segment detection (two windows, a threshold no window clears:
    the plurality vote) and the single-window probe."""
    je, te = engines()
    audio = speech_like(40.0, 4)
    for kw in (dict(language_detection_segments=2, language_detection_threshold=1.0),
               dict(language_detection_segments=1)):
        jl, jp, jall = jtr.Transcriber(je).detect_language(audio, **kw)
        tl, tp, tall = ttr.Transcriber(te).detect_language(audio, **kw)
        assert tl == jl and abs(tp - jp) <= 1e-5
        assert [k for k, _ in tall] == [k for k, _ in jall]
        np.testing.assert_allclose([p for _, p in tall], [p for _, p in jall], atol=1e-5)
        assert abs(sum(p for _, p in tall) - 1.0) <= 1e-3


def test_multilingual_per_window_detection_matches_jax():
    """options.multilingual re-detects the language on every window and
    splices it into that window's prompt; language_detection_segments > 1
    runs the up-front multi-window probe."""
    je, te = engines()
    audio = speech_like(35.0, 5)
    opts = dict(multilingual=True, language_detection_segments=2)
    jsegs, jinfo = jtr.Transcriber(je).transcribe(audio, options(JOptions, opts))
    tsegs, tinfo = ttr.Transcriber(te).transcribe(audio, options(TOptions, opts))
    assert_same_segments(jsegs, tsegs)
    assert_same_info(jinfo, tinfo)


@pytest.mark.parametrize("kind", ["plain", "words", "vad"])
def test_batched_transcriber_matches_jax(kind):
    """Files of 5, 35 and 12 s through one batched pipeline (the 35 s file
    keeps seeking after the others are done; the batch pads to a bucket)."""
    je, te = engines()
    audios = [speech_like(5.0, 6), speech_like(35.0, 7), speech_like(12.0, 8)]
    opts = dict(language="en", word_timestamps=kind == "words")
    kw = dict(vad_filter=True) if kind == "vad" else {}
    if kind == "vad":
        audios[2] = with_gap(9)
    jout = jtr.BatchedTranscriber(je).transcribe(audios, options(JOptions, opts), **kw)
    tout = ttr.BatchedTranscriber(te).transcribe(audios, options(TOptions, opts), **kw)
    assert len(tout) == len(jout) == 3
    for (jsegs, jinfo), (tsegs, tinfo) in zip(jout, tout):
        assert_same_segments(jsegs, tsegs)
        assert_same_info(jinfo, tinfo)
    assert any(segs for segs, _ in tout)


def test_batched_transcriber_takes_more_files_than_its_largest_bucket():
    """Three files on an engine whose largest batch is 2: the third waits
    for a free row and is transcribed as alone."""
    small = copy.copy(engines()[1])
    small.batch_buckets = (1, 2)
    audios = [speech_like(5.0, 6), speech_like(12.0, 7), speech_like(3.0, 8)]
    opts = options(TOptions, dict(language="en"))
    out = ttr.BatchedTranscriber(small).transcribe(audios, opts)
    assert len(out) == 3
    alone = ttr.BatchedTranscriber(small).transcribe(audios[2:], opts)
    assert_same_segments(alone[0][0], out[2][0])


@pytest.mark.parametrize("seconds", [0.5, 30.0, 30.01, 65.0])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_full_matches_jax(n_mels, seconds):
    audio = (np.random.default_rng(int(seconds * 100)).standard_normal(int(16000 * seconds))
             * 0.1).astype(np.float32)
    ref = jmel.log_mel_full(audio, n_mels=n_mels)
    out = tmel.log_mel_full(audio, n_mels=n_mels, device="cpu")
    assert out.shape == ref.shape == ((len(audio) + 160) // 160, n_mels)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_chip_smoke_float32_mel_matches_jax(n_mels):
    """The float32 torch.stft form of log_mel_full that chip_smoke holds the
    card's features against agrees with the JAX package's log_mel_full and
    with the port's within 1e-4."""
    audio = speech_like(35.0, 4)
    ref = jmel.log_mel_full(audio, n_mels=n_mels)
    plain = chip_smoke.log_mel_full_f32(audio, n_mels)
    assert plain.shape == ref.shape and plain.dtype == np.float32
    np.testing.assert_allclose(plain, ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tmel.log_mel_full(audio, n_mels=n_mels, device="cpu"), plain,
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("words, ok", [
    ([(0.3, 1.2), (1.5, 2.0), (2.5, 3.7)], True),  # edge words within 0.71 s
    ([(0.28, 1.2), (1.5, 2.0)], False),  # the first word starts too early
    ([(1.0, 1.2), (2.5, 3.72)], False),  # the last word ends too late
    ([(1.0, 1.2), (1.5, 3.1), (2.9, 3.0)], False),  # an inner word leaves the segment
    ([(1.5, 2.0), (1.2, 1.4)], False),  # out of order
])
def test_chip_smoke_word_check(words, ok):
    """chip_smoke's check of the offline CLI's word timings: inner words
    inside their segment, a segment's edge words at most 0.71 s past it."""
    segments = [{"start": 1.0, "end": 3.0,
                 "words": [{"start": a, "end": b} for a, b in words]}]
    if ok:
        assert chip_smoke.check_offline_words("case", segments) == len(words)
    else:
        with pytest.raises(chip_smoke.PhaseError):
            chip_smoke.check_offline_words("case", segments)


def test_log_mel_full_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tmel.log_mel_full(np.zeros(1600, np.float32))


def test_pad_or_trim_frames_and_prepare_mel_match_jax():
    je, te = engines()
    rng = np.random.default_rng(11)
    for n in (10, 3000, 3500):
        feats = rng.standard_normal((n, 80)).astype(np.float32)
        np.testing.assert_array_equal(tmel.pad_or_trim_frames(feats),
                                      jmel.pad_or_trim_frames(feats))
    feats = tmel.log_mel_full(speech_like(20.0, 12), device="cpu")
    window = tmel.pad_or_trim_frames(feats)[None]
    jenc, jcross = je.prepare_mel(jnp.asarray(window))
    tenc, tcross = te.prepare_mel(window)
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), atol=1e-4, rtol=0)
    assert set(tcross) == {"kv8", "scale"}
    assert tuple(tcross["kv8"].shape) == jcross["kv8"].shape
    diff = np.abs(tcross["kv8"].numpy().astype(np.int32)
                  - np.asarray(jcross["kv8"]).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
