"""The port's mel, model and decoding functions against the JAX package.

Small configuration (80 mels, vocab 51865, 1500 encoder positions, width
128, 2 heads of 64, 2 + 2 layers, 448 text positions); the JAX parameters
are made by the JAX init_params and carried over with from_jax_params, and
every input is made with numpy. Stated tolerances: mel, encoder states,
cross-KV and logits max abs <= 1e-4 (float32 sums in another order);
int8 codes identical; greedy decoding rules token-exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlive_tpu.models import whisper as jw
from whisperlive_tpu.ops import decoding as jdec
from whisperlive_tpu.ops import mel as jmel
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.models.bridge import from_jax_params
from whisperlive_tpu_torch.ops import decoding as tdec
from whisperlive_tpu_torch.ops import mel as tmel

torch.set_num_threads(2)

ATOL = 1e-4
DIMS = dict(
    n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
    n_audio_layer=2, n_text_ctx=448, n_text_state=128, n_text_head=2, n_text_layer=2,
)


def small_configs():
    """(JAX config, port config) of the test model."""
    return jw.WhisperConfig(**DIMS), tw.WhisperConfig(**DIMS)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()
    return np.asarray(x)


def to_torch_tree(tree):
    """JAX array tree (cross-KV or params) -> the port's tensors."""
    return {k: (to_torch_tree(v) if isinstance(v, dict) else
                None if v is None else from_jax_params({"x": np.asarray(v)})["x"])
            for k, v in tree.items()}


def speech_batch(b=2, seconds=(3.0, 7.5), seed=0):
    rng = np.random.default_rng(seed)
    audio = np.zeros((b, jmel.N_SAMPLES), np.float32)
    for i in range(b):
        n = int(16000 * seconds[i % len(seconds)])
        audio[i, :n] = rng.standard_normal(n) * 0.1
    return audio


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = small_configs()
    jp = jw.init_params(jcfg, 0)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax(n_mels):
    audio = speech_batch()
    ref = jmel.log_mel_spectrogram(jnp.asarray(audio), n_mels=n_mels)
    out = tmel.log_mel_spectrogram(torch.from_numpy(audio), n_mels=n_mels)
    assert out.shape == (2, jmel.N_FRAMES, n_mels)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL, rtol=0)


def test_bridge_keeps_layouts(model):
    _, _, jp, tp = model
    assert tuple(tp["encoder"]["conv1"]["w"].shape) == (128, 80, 3)  # [out, in, k]
    np.testing.assert_array_equal(
        tp["encoder"]["conv1"]["w"].numpy(), np.transpose(np.asarray(jp["encoder"]["conv1"]["w"]),
                                                          (2, 1, 0)))
    # stacked layer axis and [d_in, d_out] linears are kept as they are
    np.testing.assert_array_equal(
        tp["decoder"]["layers"]["mlp"]["fc1"]["w"].numpy(),
        np.asarray(jp["decoder"]["layers"]["mlp"]["fc1"]["w"]))
    bf = from_jax_params({"w": np.asarray(jnp.arange(4, dtype=jnp.bfloat16))})
    assert bf["w"].dtype == torch.bfloat16 and bf["w"].tolist() == [0, 1, 2, 3]


@pytest.fixture(scope="module")
def encoded(model):
    jcfg, tcfg, jp, tp = model
    mel = np.array(jmel.log_mel_spectrogram(jnp.asarray(speech_batch()), n_mels=80))
    jenc = jw.encode(jp, jcfg, jnp.asarray(mel))
    with torch.inference_mode():
        tenc = tw.encode(tp, tcfg, torch.from_numpy(mel))
    return jenc, tenc


def test_encode_matches_jax(encoded):
    jenc, tenc = encoded
    assert tenc.shape == jenc.shape
    np.testing.assert_allclose(to_np(tenc), np.asarray(jenc), atol=ATOL, rtol=0)


def test_cross_kv_and_quantization_match_jax(model, encoded):
    jcfg, tcfg, jp, tp = model
    jenc, _ = encoded
    jcross = jw.compute_cross_kv(jp, jcfg, jenc)
    tcross = tw.compute_cross_kv(tp, tcfg, torch.from_numpy(np.array(jenc)))
    assert tcross["scale"] is None
    np.testing.assert_allclose(to_np(tcross["kv"]), np.asarray(jcross["kv"]), atol=ATOL, rtol=0)

    # the quantizer on the same float cross-KV: identical codes and scales
    # (torch.round and jnp.round both round half to even)
    j8 = jw.quantize_cross_kv(jcross)
    t8 = tw.quantize_cross_kv(to_torch_tree(jcross))
    assert tuple(t8["kv8"].shape) == j8["kv8"].shape  # [L, 1, B, H, T, 2*hd]
    np.testing.assert_array_equal(t8["kv8"].numpy(), np.asarray(j8["kv8"]))
    assert t8["scale"].dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(t8["scale"]), np.asarray(j8["scale"], np.float32))

    # each side quantizing its own float cross-KV: a code may differ only by
    # one, where float32 sums in another order put a value on the other side
    # of a rounding boundary; at most 1e-4 of the codes
    own = tw.quantize_cross_kv(tcross)["kv8"].numpy().astype(np.int32)
    diff = np.abs(own - np.asarray(j8["kv8"]).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4


def test_quantize_decoder_weights_matches_jax(model):
    _, _, jp, tp = model
    jq = jax.tree.map(np.asarray, jw.quantize_decoder_weights(jp))
    tq = tw.quantize_decoder_weights(tp)
    assert tq["encoder"] is tp["encoder"]
    np.testing.assert_array_equal(tq["decoder"]["embed8"].numpy(), jq["decoder"]["embed8"])
    np.testing.assert_array_equal(to_np(tq["decoder"]["embed_s"]),
                                  jq["decoder"]["embed_s"].astype(np.float32))
    for part in ("attn", "cross_attn"):
        for name in ("q", "k", "v", "o"):
            j, t = jq["decoder"]["layers"][part][name], tq["decoder"]["layers"][part][name]
            assert set(t) == set(j)
            np.testing.assert_array_equal(t["w8"].numpy(), j["w8"])
            np.testing.assert_array_equal(to_np(t["s"]), j["s"].astype(np.float32))
    np.testing.assert_array_equal(tq["decoder"]["layers"]["mlp"]["fc2"]["w8"].numpy(),
                                  jq["decoder"]["layers"]["mlp"]["fc2"]["w8"])
    # a quantized JAX tree carries over as it is: the same int8 codes and
    # bf16 scales the port's own quantizer produces
    bridged = from_jax_params(jq)
    assert torch.equal(bridged["decoder"]["embed8"], tq["decoder"]["embed8"])
    assert torch.equal(bridged["decoder"]["embed_s"], tq["decoder"]["embed_s"])
    fc1 = bridged["decoder"]["layers"]["mlp"]["fc1"]
    assert fc1["w8"].dtype == torch.int8 and fc1["s"].dtype == torch.bfloat16
    assert torch.equal(fc1["s"], tq["decoder"]["layers"]["mlp"]["fc1"]["s"])


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_decode_prefill_and_step_match_jax(model, encoded, quantized):
    jcfg, tcfg, jp, tp = model
    jenc, _ = encoded
    jcross = jw.compute_cross_kv(jp, jcfg, jenc)
    if quantized:
        jp, tp = jw.quantize_decoder_weights(jp), tw.quantize_decoder_weights(tp)
        jcross = jw.quantize_cross_kv(jcross)
    tcross = to_torch_tree(jcross)
    rng = np.random.default_rng(1)
    b, p, c = 2, 16, 48
    tokens = rng.integers(0, 50000, (b, p)).astype(np.int32)
    prompt_len = np.array([5, 16], np.int32)
    sot_idx = np.array([1, 0], np.int32)

    j_last, j_sot, j_kv = jw.decode_prefill(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(prompt_len),
        jw.init_self_kv(jcfg, b, c), jcross, sot_idx=jnp.asarray(sot_idx))
    t_kv = tw.init_self_kv(tcfg, b, c)
    with torch.inference_mode():
        t_last, t_sot = tw.decode_prefill(
            tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(prompt_len), t_kv, tcross,
            sot_idx=torch.from_numpy(sot_idx))
    for out, ref in ((t_last, j_last), (t_sot, j_sot), (t_kv, j_kv)):
        np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL, rtol=0)

    for step in range(3):
        token = rng.integers(0, 50000, (b,)).astype(np.int32)
        pos = prompt_len + step
        j_logits, j_kv = jw.decode_step(
            jp, jcfg, jnp.asarray(token), jnp.asarray(pos), jnp.int32(p + step),
            jnp.asarray(prompt_len), p, j_kv, jcross)
        with torch.inference_mode():
            t_logits = tw.decode_step(
                tp, tcfg, torch.from_numpy(token), torch.from_numpy(pos), p + step,
                torch.from_numpy(prompt_len), p, t_kv, tcross)
        assert t_logits.dtype == torch.float32 and t_logits.shape == (b, DIMS["n_vocab"])
        np.testing.assert_allclose(to_np(t_logits), np.asarray(j_logits), atol=ATOL, rtol=0)
        np.testing.assert_allclose(to_np(t_kv), np.asarray(j_kv), atol=ATOL, rtol=0)


def test_cast_params_policy(model):
    _, _, _, tp = model
    cast = tw.cast_params(tw.quantize_decoder_weights(tp), torch.bfloat16, "cpu")
    dec = cast["decoder"]
    assert dec["layers"]["attn_ln"]["scale"].dtype == torch.float32
    assert dec["layers"]["mlp"]["fc1"]["w8"].dtype == torch.int8
    assert dec["layers"]["mlp"]["fc1"]["s"].dtype == torch.bfloat16
    assert dec["layers"]["mlp"]["fc1"]["b"].dtype == torch.bfloat16
    assert cast["encoder"]["conv1"]["w"].dtype == torch.bfloat16


def test_init_params_tree_matches_jax():
    jcfg, tcfg = small_configs()
    jshapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(lambda: jw.init_params(jcfg, 0)))
    tp = tw.init_params(tcfg, 0)

    def walk(j, t, path=()):
        assert set(j) == set(t), path
        for k in j:
            if isinstance(j[k], dict):
                walk(j[k], t[k], path + (k,))
            elif k == "w" and path[-1].startswith("conv"):
                assert tuple(t[k].shape) == tuple(reversed(j[k])), path
            else:
                assert tuple(t[k].shape) == tuple(j[k]), path + (k,)

    walk(jshapes, tp)


# ---------------------------------------------------------------------------
# decoding rules and sampler
# ---------------------------------------------------------------------------

SPEC = dict(n_vocab=51865, eot=50257, blank=220, no_speech=50362, timestamp_begin=50364)


def states(step, seed):
    """The same sampler state for both sides, with timestamps in history."""
    rng = np.random.default_rng(seed)
    b, g = 3, 12
    sampled = rng.integers(0, 50000, (b, g)).astype(np.int32)
    sampled[0, :step] = 50364 + np.arange(step) * 3  # only timestamps
    sampled[1, max(step - 1, 0)] = 50400  # text then a timestamp
    fields = dict(
        sampled=sampled,
        prompt_len=np.array([3, 5, 7], np.int32),
        gen_len=np.full((b,), step, np.int32),
        last_ts=np.array([50364 + max(step - 1, 0) * 3, 50400 if step else 50363, 50363],
                         np.int32),
        finished=np.array([False, False, step > 3]),
        sum_logprob=rng.standard_normal(b).astype(np.float32),
    )
    j = jdec.SamplerState(step=jnp.int32(step), **{k: jnp.asarray(v) for k, v in fields.items()})
    t = tdec.SamplerState(step=step, **{k: torch.from_numpy(v) for k, v in fields.items()})
    return j, t


@pytest.mark.parametrize("step", [0, 1, 2, 5])
def test_decoding_rules_and_greedy_sampler_match_jax(step):
    rng = np.random.default_rng(step)
    logits = (rng.standard_normal((3, SPEC["n_vocab"])) * 3).astype(np.float32)
    logits[:, SPEC["timestamp_begin"]:] += 2.0  # make the timestamp rules bite
    js, ts = states(step, step)
    jspec, tspec = jdec.DecodingSpec(**SPEC), tdec.DecodingSpec(**SPEC)
    suppress_ids = [1, 2, 7, 50358, 50359]
    jmask = jdec.build_suppress_mask(SPEC["n_vocab"], suppress_ids)
    tmask = tdec.build_suppress_mask(SPEC["n_vocab"], suppress_ids)
    ts_on = np.array([True, True, False])
    prompts = rng.integers(0, 50000, (3, 6)).astype(np.int32)
    plen = np.array([2, 6, 4], np.int32)

    jl = jdec.apply_logit_rules(jspec, jnp.asarray(logits), js, jmask, jnp.asarray(ts_on),
                                suppress_blank=jnp.asarray([True, False, True]),
                                max_initial_ts_idx=jnp.asarray([50, 10, 0]))
    tl = tdec.apply_logit_rules(tspec, torch.from_numpy(logits), ts, tmask,
                                torch.from_numpy(ts_on),
                                suppress_blank=torch.tensor([True, False, True]),
                                max_initial_ts_idx=torch.tensor([50, 10, 0]))
    np.testing.assert_array_equal(to_np(tl), np.asarray(jl))

    jl = jdec.apply_repetition_penalty(jl, js, jnp.full((3,), 1.3), jnp.asarray(prompts),
                                       jnp.asarray(plen))
    tl = tdec.apply_repetition_penalty(tl, ts, 1.3, torch.from_numpy(prompts),
                                       torch.from_numpy(plen))
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=1e-6, atol=0)
    assert tdec.apply_repetition_penalty(tl, ts, 1.0) is tl

    jh = jdec.right_align_prompt(jnp.asarray(prompts), jnp.asarray(plen))
    th = tdec.right_align_prompt(torch.from_numpy(prompts), torch.from_numpy(plen))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    jl = jdec.apply_no_repeat_ngram(jl, js, 3, prompt_hist=jh)
    tl = tdec.apply_no_repeat_ngram(tl, ts, 3, prompt_hist=th)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=1e-6, atol=0)

    jtok, jlp = jdec.sample_next(jl, jnp.zeros((3,)), jax.random.PRNGKey(0))
    ttok, tlp = tdec.sample_next(tl, torch.zeros(3), torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5, rtol=0)

    jn = jdec.advance_state(jspec, js, jtok, jlp)
    tn = tdec.advance_state(tspec, ts, ttok, tlp)
    assert tn.step == int(jn.step)
    for name in ("sampled", "prompt_len", "gen_len", "last_ts", "finished"):
        np.testing.assert_array_equal(getattr(tn, name).numpy(), np.asarray(getattr(jn, name)))
    np.testing.assert_allclose(tn.sum_logprob.numpy(), np.asarray(jn.sum_logprob), atol=1e-5)


def test_no_repeat_ngram_on_sampled_tokens_only():
    js, ts = states(5, 3)
    sampled = np.array([[5, 6, 7, 5, 6] + [0] * 7] * 3, np.int32)
    js = js._replace(sampled=jnp.asarray(sampled))
    ts = ts._replace(sampled=torch.from_numpy(sampled))
    logits = np.zeros((3, SPEC["n_vocab"]), np.float32)
    jl = jdec.apply_no_repeat_ngram(jnp.asarray(logits), js, 2)
    tl = tdec.apply_no_repeat_ngram(torch.from_numpy(logits), ts, 2)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # the last token 6 was followed by 7 before: 7 is banned, nothing else
    assert (tl.numpy()[:, 7] == tdec.NEG_INF).all()
    assert (tl.numpy() == tdec.NEG_INF).sum() == 3


def test_temperature_sampling_follows_the_distribution():
    """T > 0 draws from softmax(logits / T) with the caller's generator (its
    numbers differ from JAX's, so only the distribution is compared)."""
    logits = torch.log(torch.tensor([[0.7, 0.2, 0.1]])).repeat(4000, 1)
    tok, lp = tdec.sample_next(logits, torch.ones(4000), torch.Generator().manual_seed(0))
    freq = np.bincount(tok.numpy(), minlength=3) / 4000
    np.testing.assert_allclose(freq, [0.7, 0.2, 0.1], atol=0.03)
    np.testing.assert_allclose(lp.numpy(), np.log([0.7, 0.2, 0.1])[tok.numpy()], atol=1e-6)
    again, _ = tdec.sample_next(logits, torch.ones(4000), torch.Generator().manual_seed(0))
    assert torch.equal(tok, again)
