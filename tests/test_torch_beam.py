"""The port's beam search against the JAX package's.

Narrow model (tests/test_torch_model.py small_configs), the JAX parameters
carried over with from_jax_params, both engines on the CPU in float32 with
float weights and cross-KV, or decoder_int8=True with cross_kv_bits=8 or 4.
The "eot" parameters make EOT's embedding row a copy of a common token's,
scaled by 1.05, so that lanes finish by EOT at different steps (with random
weights EOT is otherwise never chosen) and the loop stops before its
budget. Stated tolerances: tokens, gen_len and the best lane exact;
sum_logprob within rel 1e-4 (float32 sums in another order) at every
width, int8 and int4 included; no_speech_prob within 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_model import small_configs
from whisperlive_tpu.engine.engine import TranscribeOptions as JOptions
from whisperlive_tpu.engine.engine import WhisperEngine as JEngine
from whisperlive_tpu.models import whisper as jw
from whisperlive_tpu_torch.engine.engine import TranscribeOptions as TOptions
from whisperlive_tpu_torch.engine.engine import WhisperEngine as TEngine
from whisperlive_tpu_torch.engine.engine import beam_lanes
from whisperlive_tpu_torch.models.bridge import from_jax_params
from whisperlive_tpu_torch.ops import decoding as tdec

torch.set_num_threads(2)

EOT = 50257
COMMON = 28498  # a token the seed-0 narrow model decodes often
MODES = {
    "float": dict(decoder_int8=False, cross_kv_bits=16),
    "int8": dict(decoder_int8=True, cross_kv_bits=8),
    "int4": dict(decoder_int8=True, cross_kv_bits=4),
}
BEAM = dict(language="en", temperatures=(0.0,), log_prob_threshold=None,
            no_speech_threshold=None, compression_ratio_threshold=None)


@functools.lru_cache(maxsize=None)
def make_engines(mode, eot_params=False):
    """(JAX engine, port engine) on the same parameters, built once."""
    jcfg, tcfg = small_configs()
    params = jax.tree.map(lambda x: np.array(x), jw.init_params(jcfg, 0))
    if eot_params:
        params["decoder"]["embed"][EOT] = params["decoder"]["embed"][COMMON] * 1.05
    je = JEngine(jcfg, jax.tree.map(jnp.asarray, params), batch_buckets=(2,), **MODES[mode])
    te = TEngine(tcfg, from_jax_params(params), batch_buckets=(2,), device="cpu",
                 **MODES[mode])
    return je, te


def window_audio(seed=0):
    rng = np.random.default_rng(seed)
    audio = np.zeros((2, 480000), np.float32)
    audio[0, :48000] = rng.standard_normal(48000) * 0.1
    audio[1, :80000] = rng.standard_normal(80000) * 0.1
    return audio


@functools.lru_cache(maxsize=None)
def prepared(mode, eot_params=False):
    je, te = make_engines(mode, eot_params)
    audio = window_audio()
    return je.prepare(audio)[1], te.prepare(audio)[1]


def raw_beam(eng, cross, opts, port):
    """The engine's beam program itself: (sampled, gen_len, sum_logprob,
    no_speech_prob) as numpy, at the batch's bucket of 2 rows."""
    p, s = eng.build_prompt(opts)
    arr, plen = eng._pad_prompts([p, p])
    requested = opts.max_new_tokens
    cache_len = min(arr.shape[1] + 128, 448)
    rules = (opts.no_repeat_ngram_size, True, -1)
    if port:
        t = eng._tensor
        args = (cross, t(arr), t(plen), t(np.asarray([s, s], np.int32)),
                eng.suppress_mask_for(opts), t(np.ones(2, bool)), 1.0, requested, cache_len,
                *rules)
        out = eng._decode_beam(args, beam_lanes(opts), opts.length_penalty)
        return [x.numpy() for x in out]
    out = eng._decode_beam_fn(
        eng.params, cross, jnp.asarray(arr), jnp.asarray(plen), jnp.asarray([s, s]),
        eng.suppress_mask_for(opts), jnp.ones(2, bool), jnp.ones(2, jnp.float32),
        np.int32(requested), beam_lanes(opts), jnp.float32(opts.length_penalty), cache_len,
        *rules,
    )
    return [np.asarray(x) for x in out]


def assert_same(ref, out):
    tok_r, gen_r, sum_r, ns_r = ref
    tok_o, gen_o, sum_o, ns_o = out
    np.testing.assert_array_equal(gen_o, gen_r)
    for i, g in enumerate(gen_r):
        np.testing.assert_array_equal(tok_o[i, :g], tok_r[i, :g])
    np.testing.assert_allclose(sum_o, sum_r, rtol=1e-4)
    np.testing.assert_allclose(ns_o, ns_r, atol=1e-5)


@pytest.mark.parametrize("eot_params", [False, True], ids=["budget", "eot"])
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_beam_matches_jax(mode, eot_params):
    je, te = make_engines(mode, eot_params)
    jc, tc = prepared(mode, eot_params)
    opts = dict(BEAM, beam_size=3, max_new_tokens=24)
    ref = raw_beam(je, jc, JOptions(**opts), port=False)
    out = raw_beam(te, tc, TOptions(**opts), port=True)
    assert_same(ref, out)
    if eot_params:  # some item stopped on EOT before the budget
        assert (ref[1] < 24).any()
    # and through decode_batch, as the scheduler calls it
    p, s = je.build_prompt(JOptions(**opts))
    jres = je.decode_batch(jc, [p, p], [s, s], JOptions(**opts))
    tres = te.decode_batch(tc, [p, p], [s, s], TOptions(**opts))
    for a, b in zip(jres, tres):
        assert list(a.tokens) == list(b.tokens)
        assert b.avg_logprob == pytest.approx(a.avg_logprob, rel=1e-4)


def test_beam_k1_equals_greedy():
    """One lane: the beam program is the greedy decode."""
    _, te = make_engines("int8")
    _, tc = prepared("int8")
    opts = TOptions(**BEAM, beam_size=1, max_new_tokens=20)
    beam = raw_beam(te, tc, opts, port=True)
    p, s = te.build_prompt(opts)
    greedy = te.decode_batch(tc, [p, p], [s, s], opts)
    for i, r in enumerate(greedy):
        toks = beam[0][i, : beam[1][i]]
        toks = toks[:-1] if len(toks) and toks[-1] == te.spec.eot else toks
        assert list(toks) == list(r.tokens)
        assert beam[2][i] / (len(r.tokens) + 1) == pytest.approx(r.avg_logprob, rel=1e-5)


def test_beam_patience_widens_lanes():
    """patience=1.0 is the default program (identical results); patience=2
    runs ceil(3 * 2) = 6 lanes, matches JAX and keeps the budget."""
    je, te = make_engines("float")
    jc, tc = prepared("float")
    base = dict(BEAM, beam_size=3, max_new_tokens=10)
    assert beam_lanes(TOptions(**base, patience=2.0)) == 6
    assert beam_lanes(TOptions(**base, patience=0.5)) == 3
    p, s = te.build_prompt(TOptions(**base))
    (r1,) = te.decode_batch(tc, [p], [s], TOptions(**base, patience=1.0))
    (r_default,) = te.decode_batch(tc, [p], [s], TOptions(**base))
    np.testing.assert_array_equal(r1.tokens, r_default.tokens)
    ref = raw_beam(je, jc, JOptions(**base, patience=2.0), port=False)
    out = raw_beam(te, tc, TOptions(**base, patience=2.0), port=True)
    assert_same(ref, out)
    (r2,) = te.decode_batch(tc, [p], [s], TOptions(**base, patience=2.0))
    assert len(r2.tokens) <= 10 and np.isfinite(r2.avg_logprob)


@pytest.mark.parametrize("eot_params", [False, True], ids=["budget", "eot"])
def test_beam_chunked_matches_monolithic_and_jax(eot_params, monkeypatch):
    """Preemptible (chunked) beam decodes are token-exact against the
    monolithic one for any chunk, a chunk that does not divide the decode
    and decodes that stop on EOT inside a segment included, and so against
    JAX's chunked program."""
    je, te = make_engines("int8", eot_params)
    jc, tc = prepared("int8", eot_params)
    opts = dict(BEAM, beam_size=3, max_new_tokens=24)
    p, s = te.build_prompt(TOptions(**opts))
    assert te.beam_chunk == 0
    base = raw_beam(te, tc, TOptions(**opts), port=True)
    for chunk in (1, 5, 64):
        monkeypatch.setattr(te, "beam_chunk", chunk)
        got = raw_beam(te, tc, TOptions(**opts), port=True)
        for a, b in zip(base, got):
            np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(je, "beam_chunk", 5)
    ref = je.decode_batch(jc, [p, p], [s, s], JOptions(**opts))
    out = te.decode_batch(tc, [p, p], [s, s], TOptions(**opts))
    assert [list(r.tokens) for r in out] == [list(r.tokens) for r in ref]
    if eot_params:
        assert (base[1] < 24).any()


@pytest.mark.parametrize("case", ["plain_ties", "frozen_lanes", "step0_penalty", "random"])
def test_top_k_tie_order_matches_jax(case):
    """torch.topk promises no order among equal values; the port's top_k
    gives jax.lax.top_k's: descending, the lower index first."""
    neg = float(np.finfo(np.float32).min)
    rng = np.random.default_rng(3)
    if case == "plain_ties":
        x = np.array([[1, 3, 3, 2, 3, 0, 3], [5, 5, 5, 5, 5, 5, 5]], np.float32)
        k = 4
    elif case == "frozen_lanes":  # finished lanes: EOT at the frozen score, the rest f32-min
        x = np.full((2, 3 * 50), neg, np.float32)
        x[0, [7, 57, 107]] = -2.5
        x[1, 7] = -1.0
        k = 3
    elif case == "step0_penalty":  # lanes > 0 at cand + f32-min: -inf and near-min ties
        lp = np.log(rng.dirichlet(np.ones(40), size=3)).astype(np.float32)
        lp[:, ::5] = neg
        with np.errstate(over="ignore"):  # f32-min + f32-min = -inf, as on the card
            x = (lp + np.array([0.0, neg, neg], np.float32)[:, None]).reshape(1, -1)
        k = 3
    else:
        x = rng.integers(-3, 3, (4, 64)).astype(np.float32)
        k = 5
    vals, idx = tdec.top_k(torch.from_numpy(x), k)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
