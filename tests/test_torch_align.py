"""The port's word alignment against the JAX package's.

decode_with_cross_attn (the teacher-forced pass that returns the
cross-attention maps) and WhisperEngine.align_words, on the same parameters
(JAX init_params carried over with from_jax_params) and the same cross-KV
(the JAX engine's, converted), on the CPU in float32 with float, int8 and
int4 cross-KV. Stated tolerances: logits within 1e-4 of max|logit|, maps
within 1e-5 (probabilities; float32 sums in another order); the same words,
each start and end within one frame (0.02 s) of JAX's, probabilities
within 1e-4.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_model import small_configs, to_torch_tree
from whisperlive_tpu.engine.engine import WhisperEngine as JEngine
from whisperlive_tpu.models import whisper as jw
from whisperlive_tpu_torch.engine.engine import WhisperEngine as TEngine
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.models.bridge import from_jax_params

torch.set_num_threads(2)

MODES = {
    "float": dict(decoder_int8=False, cross_kv_bits=16),
    "int8": dict(decoder_int8=True, cross_kv_bits=8),
    "int4": dict(decoder_int8=True, cross_kv_bits=4),
}
SHORT = dict(n_mels=80, n_vocab=51865, n_audio_ctx=100, n_audio_state=64, n_audio_head=4,
             n_audio_layer=2, n_text_ctx=48, n_text_state=64, n_text_head=4, n_text_layer=2)


@functools.lru_cache(maxsize=None)
def make_engines(mode, short=False):
    """(JAX engine, port engine) on the same parameters: the narrow test
    model, or (short) the JAX align tests' 100-position, 48-token one."""
    if short:
        jcfg, tcfg = jw.WhisperConfig(**SHORT), tw.WhisperConfig(**SHORT)
    else:
        jcfg, tcfg = small_configs()
    jp = jw.init_params(jcfg, 0)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    je = JEngine(jcfg, jp, compute_dtype=jnp.float32, batch_buckets=(1, 2),
                 **(dict(prompt_buckets=(16, 48)) if short else {}), **MODES[mode])
    te = TEngine(tcfg, tp, batch_buckets=(1, 2), device="cpu", **MODES[mode])
    if short:  # the JAX align tests' buckets for a 48-token context
        te.prompt_buckets = (16, 48)
    return je, te


@functools.lru_cache(maxsize=None)
def short_cross(mode):
    """The short model's cross-KV from a random mel (JAX prepare_mel), and
    the same tensors for the port."""
    je, _ = make_engines(mode, short=True)
    mel = np.random.default_rng(0).standard_normal((1, 2 * SHORT["n_audio_ctx"], 80))
    _, cross = je.prepare_mel(jnp.asarray(mel.astype(np.float32)))
    return cross, to_torch_tree(cross)


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_with_cross_attn_matches_jax(mode):
    je, te = make_engines(mode)
    audio = np.zeros((2, 480000), np.float32)
    audio[:, :64000] = np.random.default_rng(1).standard_normal((2, 64000)) * 0.1
    _, jcross = je.prepare(audio)
    tcross = to_torch_tree(jcross)
    toks = np.random.default_rng(2).integers(0, 50000, (2, 16)).astype(np.int32)
    clen = np.array([1500, 700], np.int32)
    jl, jm = jw.decode_with_cross_attn(je.params, je.cfg, jnp.asarray(toks), jcross,
                                       cross_len=jnp.asarray(clen))
    tl, tm = tw.decode_with_cross_attn(te.params, te.cfg, torch.from_numpy(toks), tcross,
                                       cross_len=torch.from_numpy(clen))
    jl, jm = np.asarray(jl), np.asarray(jm)
    cfg = te.cfg
    assert tl.shape == (2, 16, cfg.n_vocab) and tl.dtype == torch.float32
    assert tm.shape == (cfg.n_text_layer, 2, cfg.n_text_head, 16, cfg.n_audio_ctx)
    assert tm.dtype == cfg.dtype
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4 * np.abs(jl).max(), rtol=0)
    np.testing.assert_allclose(tm.numpy(), jm, atol=1e-5, rtol=0)
    assert not tm[:, 1, :, :, 700:].any()  # past cross_len: no attention mass
    # the engine's pass cuts rows and positions on the device before the copy
    logits, maps = te.align_maps(te.gather_cross(tcross, [1]), toks[1:], 700, 9, 300)
    np.testing.assert_array_equal(maps, tm[:, 1:, :, :9, :150].numpy())
    np.testing.assert_array_equal(logits, tl[1:, :9].numpy())


def assert_same_words(ref, out):
    assert [w.word for w in out] == [w.word for w in ref]
    for a, b in zip(ref, out):
        assert abs(a.start - b.start) <= 0.02 and abs(a.end - b.end) <= 0.02
        assert b.probability == pytest.approx(a.probability, abs=1e-4)


@pytest.mark.parametrize("mode", list(MODES))
def test_align_words_matches_jax(mode):
    """Port of tests/test_align.py::test_engine_align_words_shapes."""
    je, te = make_engines(mode, short=True)
    jcross, tcross = short_cross(mode)
    text = te.tokenizer.encode(" hello world how are you")
    assert text == je.tokenizer.encode(" hello world how are you")
    n = 2 * SHORT["n_audio_ctx"]
    ref = je.align_words(jcross, 0, text, num_frames=n)
    out = te.align_words(tcross, 0, text, num_frames=n)
    assert out, "no word timings returned"
    assert_same_words(ref, out)
    for w in out:
        assert 0.0 <= w.start <= w.end and 0.0 <= w.probability <= 1.0
    assert "".join(w.word for w in out).strip().startswith("hello")
    raw = te.align_words(tcross, 0, text, num_frames=n, merge=False)
    assert_same_words(je.align_words(jcross, 0, text, num_frames=n, merge=False), raw)


def test_align_single_word_matches_jax():
    """Port of tests/test_align.py::test_engine_align_single_word."""
    je, te = make_engines("float", short=True)
    jcross, tcross = short_cross("float")
    text = te.tokenizer.encode(" hi")
    out = te.align_words(tcross, 0, text, num_frames=2 * SHORT["n_audio_ctx"])
    assert len(out) == 1 and out[0].word == " hi"
    assert_same_words(je.align_words(jcross, 0, text, num_frames=200), out)
    assert te.align_words(tcross, 0, [te.spec.eot], num_frames=200) == []


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_align_window_item_matches_jax(mode):
    """Text aligned against the second item of a two-item 30 s window
    batch (each engine's own prepare), with a language and timestamps in
    the hypothesis (dropped before the pass)."""
    je, te = make_engines(mode)
    audio = np.zeros((2, 480000), np.float32)
    audio[1, :96000] = np.random.default_rng(4).standard_normal(96000) * 0.1
    _, jcross = je.prepare(audio)
    words = te.tokenizer.encode(" the quick brown fox, jumps over the lazy dog.")
    text = [je.spec.timestamp_begin] + words + [je.spec.timestamp_begin + 150]
    ref = je.align_words(jcross, 1, text, 600, language="en")
    out = te.align_words(te.prepare(audio)[1], 1, text, 600, language="en")
    assert out
    assert_same_words(ref, out)
