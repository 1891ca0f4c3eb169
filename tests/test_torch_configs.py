"""The published Whisper configurations in the port, against the JAX package.

Every name in the port's WHISPER_CONFIGS (and the "turbo" alias) must equal
the JAX config field by field. Then five of them, each at its own width,
heads, mel bins and vocabulary (small: the server CLI's default; tiny.en:
the narrowest, English-only; base; medium; large-v3-turbo: 128 mels and a
4-layer decoder), cut to 1 encoder layer, min(2, L) decoder layers (all 4
of turbo's) and 64 encoder positions. One JAX init_params tree per
configuration, carried over with from_jax_params, builds the JAX engine
and the port's (device="cpu"), both with decoder_int8=True,
cross_kv_bits=8. For each configuration the window route's
transcribe_batch and an 8-slot continuous pool give the same greedy tokens
on both engines, and the same language detection (within 1e-4), which an
English-only model never runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlive_tpu.engine import continuous as jcont
from whisperlive_tpu.engine.engine import TranscribeOptions as JOptions
from whisperlive_tpu.engine.engine import WhisperEngine as JEngine
from whisperlive_tpu.models import whisper as jw
from whisperlive_tpu_torch.engine import continuous as tcont
from whisperlive_tpu_torch.engine.engine import TranscribeOptions as TOptions
from whisperlive_tpu_torch.engine.engine import WhisperEngine as TEngine
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.models.bridge import from_jax_params
from whisperlive_tpu_torch.ops.mel import HOP_LENGTH

torch.set_num_threads(2)

CONFIGS = ("small", "tiny.en", "base", "medium", "large-v3-turbo")
N_AUDIO_CTX = 64
N_SAMPLES = 2 * N_AUDIO_CTX * HOP_LENGTH  # the audio that fills the cut encoder
GREEDY = dict(temperatures=(0.0,), log_prob_threshold=None, no_speech_threshold=None,
              compression_ratio_threshold=None, max_new_tokens=8)
# the JAX config's runtime settings, which the port's config does not carry
RUNTIME_FIELDS = {"dtype", "fused_encoder_attention"}


@pytest.mark.parametrize("name", sorted(tw.WHISPER_CONFIGS))
def test_config_equals_jax_field_by_field(name):
    want, got = jw.WHISPER_CONFIGS[name], tw.WHISPER_CONFIGS[name]
    fields = {f.name for f in dataclasses.fields(want)} - RUNTIME_FIELDS
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
    assert got.tp == 1 and got.head_dim == want.head_dim


def test_catalogs_hold_the_same_names():
    assert set(tw.WHISPER_CONFIGS) == set(jw.WHISPER_CONFIGS)
    assert tw.WHISPER_CONFIGS["turbo"] == tw.WHISPER_CONFIGS["large-v3-turbo"]


def cut(cfgs: dict, name: str):
    full = cfgs[name]
    layers = full.n_text_layer if name == "large-v3-turbo" else min(2, full.n_text_layer)
    return full.replace(n_audio_layer=1, n_text_layer=layers, n_audio_ctx=N_AUDIO_CTX)


@pytest.fixture(scope="module", params=CONFIGS)
def engines(request):
    """(name, JAX engine, port engine) of one cut configuration, built once
    for the module and dropped before the next configuration's."""
    name = request.param
    jcfg, tcfg = cut(jw.WHISPER_CONFIGS, name), cut(tw.WHISPER_CONFIGS, name)
    jp = jw.init_params(jcfg, 0)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    kw = dict(batch_buckets=(2,), decoder_int8=True, cross_kv_bits=8)
    je = JEngine(jcfg, jp, compute_dtype=jnp.float32, **kw)
    del jp
    te = TEngine(tcfg, tp, device="cpu", **kw)
    assert (te.cfg.n_mels, te.cfg.n_vocab, te.cfg.n_text_head) == (
        jcfg.n_mels, jcfg.n_vocab, jcfg.n_text_head)
    assert te.tokenizer.spec.multilingual == je.tokenizer.spec.multilingual == (
        not name.endswith(".en"))
    yield name, je, te
    del je, te


def speech_like(seconds, seed):
    t = np.arange(int(16000 * seconds)) / 16000.0
    rng = np.random.default_rng(seed)
    f0 = 140 + 40 * np.sin(2 * np.pi * 2.1 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
    sig = sig * (0.55 + 0.45 * np.sin(2 * np.pi * 3.7 * t)) + 0.02 * rng.standard_normal(t.shape)
    return (0.12 * sig / np.max(np.abs(sig))).astype(np.float32)


def clips():
    """Two clips in the cut encoder's window: a full one and a half one."""
    audio = np.zeros((2, N_SAMPLES), np.float32)
    audio[0] = speech_like(N_SAMPLES / 16000, 1)
    audio[1, :N_SAMPLES // 2] = speech_like(N_SAMPLES / 32000, 2)
    return audio


def count_detection(te):
    """Counts the port engine's language-detection prefills."""
    calls = []
    detect = te._detect
    te._detect = lambda cross: calls.append(1) or detect(cross)
    return calls


def test_window_route_matches_jax(engines):
    """transcribe_batch: item 0 knows its language (English), item 1's is
    detected (a multilingual model) or English (an English-only one)."""
    name, je, te = engines
    audio = clips()
    p, s = je.build_prompt(JOptions(language="en", **GREEDY))
    args = (audio, [p, p], [s, s], [True, False])
    jres, jlang, _ = je.transcribe_batch(*args, JOptions(language=None, **GREEDY))
    calls = count_detection(te)
    try:
        tres, tlang, _ = te.transcribe_batch(*args, TOptions(language=None, **GREEDY))
    finally:
        del te._detect
    assert [list(r.tokens) for r in tres] == [list(r.tokens) for r in jres]
    assert all(len(r.tokens) > 0 for r in tres)
    for a, b in zip(jres, tres):
        assert abs(a.avg_logprob - b.avg_logprob) <= 1e-4
    assert [lang for lang, _ in tlang] == [lang for lang, _ in jlang]
    for (_, pa), (_, pb) in zip(jlang, tlang):
        assert abs(pa - pb) <= 1e-4
    if name.endswith(".en"):
        assert not calls and [lang for lang, _ in tlang] == ["en", "en"]
    else:
        assert calls


def pool_run(mod, eng, options_cls):
    """An 8-slot pool: two windows inserted into slots 2 and 5 (the first's
    language known, the second's not), stepped until both finish. Returns
    (the insert's language probabilities, each window's tokens)."""
    cb = mod.ContinuousEngine(eng, n_slots=8, prompt_pad=16, ring=32, steps_per_chunk=4)
    cb.init_state()
    p, s = eng.build_prompt(options_cls(language="en", **GREEDY), language="en")
    slots = (2, 5)
    probs = cb.insert(clips(), [p, p], [s, s], [True, False], list(slots), [0.0, 0.0],
                      [True, True], [1.0, 1.0], [GREEDY["max_new_tokens"]] * 2)
    out = {}
    for _ in range(10):
        status = cb.step()
        for slot in slots:
            if slot not in out and status[slot, 1] > 0.5:
                out[slot] = [int(t) for t in cb.harvest(slot, 0, int(status[slot, 2]))]
        if len(out) == len(slots):
            return np.asarray(probs), [out[slot] for slot in slots]
    raise AssertionError(f"the pool did not finish: {sorted(out)}")


def test_continuous_pool_matches_jax(engines):
    name, je, te = engines
    jprobs, jtokens = pool_run(jcont, je, JOptions)
    calls = count_detection(te)
    try:
        tprobs, ttokens = pool_run(tcont, te, TOptions)
    finally:
        del te._detect
    assert ttokens == jtokens and all(ttokens)
    assert tprobs.shape == jprobs.shape
    np.testing.assert_allclose(tprobs, jprobs, atol=1e-4)
    assert not calls  # the pool detects inside its insert, not through _detect
    if name.endswith(".en"):
        assert tprobs.shape == (2, 1) and not tprobs.any()
    else:
        assert tprobs.shape[1] == len(te.tokenizer.spec.language_codes)
