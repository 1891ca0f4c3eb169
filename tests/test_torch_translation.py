"""The port's translation path against the JAX package's.

models/m2m100.py against whisperlive_tpu/models/m2m100.py on the same HF
state dict (a random `transformers` M2M100 model, as tests/test_m2m100.py
builds it) at TINY and at a wider config, float32 on the CPU. Stated
tolerances (float32 sums in another order): encoder states 1e-4 and
teacher-forced logits 1e-3, absolute at transformers' init, and relative
to max|ref| on larger weights whose generations vary (at transformers'
init every row repeats one token). On those, greedy and beam-5 tokens are
exact on 8 bucket-padded sources, with a forced target-language bos and
without, and beam search equals HF generate. The
SMALL100 tokenizer's ids and decodes equal the JAX one's on a toy
SentencePiece-BPE dir; TorchTranslator on a toy SMALL100 checkpoint dir
translates as JAXTranslator does; the worker's cases of
tests/test_translation.py; make_translator raises on a broken dir.
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisperlive_tpu import small100_tokenizer as jtok
from whisperlive_tpu import translation as jtranslation
from whisperlive_tpu.models import m2m100 as jm
from whisperlive_tpu_torch import small100_tokenizer as ttok
from whisperlive_tpu_torch.models import m2m100 as tm
from whisperlive_tpu_torch.models import safetensors_io
from whisperlive_tpu_torch.translation import (
    IdentityTranslator,
    TorchTranslator,
    TranslationWorker,
    make_translator,
)

torch.set_num_threads(2)

TINY = dict(
    vocab_size=512, d_model=64, encoder_layers=2, decoder_layers=2,
    encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=128,
    decoder_ffn_dim=128, max_position_embeddings=64, pad_token_id=1, bos_token_id=0,
    eos_token_id=2, decoder_start_token_id=2, scale_embedding=True, activation_function="relu",
)
WIDE = dict(TINY, vocab_size=1000, d_model=128, encoder_layers=3, decoder_layers=2,
            encoder_attention_heads=8, decoder_attention_heads=8, encoder_ffn_dim=256,
            decoder_ffn_dim=256, max_position_embeddings=128)
CONFIGS = {"tiny": TINY, "wide": WIDE}
# the EOS embedding row's scale a config needs for some rows to end early
EOS_SCALE = {"tiny": 1.5, "wide": 3.0}


def hf_model(config, seed=0, eos_scale=None):
    """A random model at transformers' init or, given eos_scale, one whose
    generations vary: at transformers' init every row repeats one token, so
    the projections are drawn at 8/sqrt(fan_in) and the shared embedding at
    0.5, its EOS row scaled by eos_scale."""
    from transformers import M2M100Config as HFConfig
    from transformers import M2M100ForConditionalGeneration

    torch.manual_seed(seed)
    model = M2M100ForConditionalGeneration(HFConfig(**config)).eval()
    if eos_scale is None:
        return model
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 2 and name != "model.shared.weight":
                p.normal_(0, 8 / p.shape[1] ** 0.5)
        shared = model.model.shared.weight
        shared.normal_(0, 0.5)
        shared[config["eos_token_id"]] *= eos_scale
    return model


def _both(name, varied):
    config = CONFIGS[name]
    sd = hf_model(config, eos_scale=EOS_SCALE[name] if varied else None).state_dict()
    jc, tc = jm.config_from_hf(config), tm.config_from_hf(config)
    return jc, jm.params_from_state_dict(sd, jc), tc, tm.params_from_state_dict(sd, tc)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def both(request):
    """(JAX cfg, JAX params, port cfg, port params) from one HF state dict at
    transformers' init."""
    return _both(request.param, varied=False)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def varied(request):
    """The same from weights whose generations vary."""
    return _both(request.param, varied=True)


def padded_sources(vocab, n=8, t=12, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(3, vocab, (n, t)).astype(np.int32)
    for i in range(n):
        src[i, t - i:] = 1  # row i carries i pad positions
    return src


def test_config_and_positions_match_jax():
    for config in CONFIGS.values():
        a, b = tm.config_from_hf(config), jm.config_from_hf(config)
        assert {k: v for k, v in vars(a).items() if k != "dtype"} == \
            {k: v for k, v in vars(b).items() if k != "dtype"}
    assert tm.M2M100Config().vocab_size == jm.M2M100Config().vocab_size == 128112
    np.testing.assert_array_equal(tm.sinusoidal_positions(66, 64), jm.sinusoidal_positions(66, 64))
    np.testing.assert_array_equal(tm.sinusoidal_positions(10, 7, 1),
                                  jm.sinusoidal_positions(10, 7, 1))


def test_params_match_jax(both):
    jc, jp, tc, tp = both
    flat = safetensors_io.flatten_tree(tp)
    ref = safetensors_io.flatten_tree({"x": jp})

    assert sorted(flat) == sorted(k[len("x/"):] for k in ref)
    for k, v in flat.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref["x/" + k]), err_msg=k)


def test_encoder_and_logits_match_jax(both):
    """At transformers' init: absolute tolerances."""
    _check_encoder_and_logits(*both, scale=False)


def test_encoder_and_logits_match_jax_varied(varied):
    """On the larger weights the states grow: tolerances relative to max|ref|."""
    _check_encoder_and_logits(*varied, scale=True)


def _check_encoder_and_logits(jc, jp, tc, tp, scale):
    src = padded_sources(jc.vocab_size)
    mask = src != jc.pad_token_id
    tgt = np.random.default_rng(1).integers(3, jc.vocab_size, (8, 6)).astype(np.int32)
    tgt[:, 0] = jc.eos_token_id
    enc_j = jm.encode(jp, jc, jnp.asarray(src), jnp.asarray(mask))
    enc_t = tm.encode(tp, tc, torch.from_numpy(src), torch.from_numpy(mask))
    enc_tol = 1e-4 * (np.abs(np.asarray(enc_j)).max() if scale else 1.0)
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j), atol=enc_tol, rtol=0)
    logits_j = np.asarray(jm.decode(jp, jc, jnp.asarray(tgt), enc_j, jnp.asarray(mask)))
    tol = 1e-3 * (np.abs(logits_j).max() if scale else 1.0)
    logits_t = tm.decode(tp, tc, torch.from_numpy(tgt), enc_t, torch.from_numpy(mask))
    assert logits_t.dtype == torch.float32 and logits_t.shape == (8, 6, jc.vocab_size)
    np.testing.assert_allclose(logits_t.numpy(), logits_j, atol=tol, rtol=0)
    # the cached decoder (prefix, then one step) gives the teacher-forced logits
    cross = tm._compute_cross_kv(tp, tc, enc_t)
    self_kv = torch.zeros((tc.decoder_layers, 2, 8, 8, tc.heads, tc.d_model // tc.heads))
    pos = torch.arange(5)[None].expand(8, 5)
    cached, self_kv = tm._cached_forward(tp, tc, torch.from_numpy(tgt[:, :5]), pos, 0, self_kv,
                                         cross, torch.from_numpy(mask))
    step, _ = tm._cached_forward(tp, tc, torch.from_numpy(tgt[:, 5:]), pos[:, :1] + 5, 5,
                                 self_kv, cross, torch.from_numpy(mask))
    np.testing.assert_allclose(torch.cat([cached, step], 1).numpy(), logits_j, atol=tol, rtol=0)


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("method", ["greedy", "beam5"])
def test_generation_token_exact(varied, method, forced):
    jc, jp, tc, tp = varied
    src = padded_sources(jc.vocab_size, seed=2)
    bos = np.full(8, 10, np.int32) if forced else None
    kw = dict(max_new=16)
    if method == "greedy":
        ref = jm.generate_greedy(jp, jc, jnp.asarray(src), None if bos is None
                                 else jnp.asarray(bos), **kw)
        ours = tm.generate_greedy(tp, tc, torch.from_numpy(src), None if bos is None
                                  else torch.from_numpy(bos), **kw)
    else:
        ref = jm.generate_beam(jp, jc, jnp.asarray(src), None if bos is None
                               else jnp.asarray(bos), beam_size=5, **kw)
        ours = tm.generate_beam(tp, tc, torch.from_numpy(src), None if bos is None
                                else torch.from_numpy(bos), beam_size=5, **kw)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape == (8, 16)
    np.testing.assert_array_equal(ours.numpy(), ref)
    # the rows are not one repeated token, and some end early
    assert np.mean([len(set(row)) for row in ref.tolist()]) > 3
    assert (ref == jc.eos_token_id).any()


def test_beam_matches_hf_generate():
    """generate_beam reproduces HF generate(num_beams=K, early_stopping=True)
    token for token, as the JAX test holds the JAX model."""
    model = hf_model(TINY, eos_scale=EOS_SCALE["tiny"])
    cfg = tm.config_from_hf(TINY)
    params = tm.params_from_state_dict(model.state_dict(), cfg)
    tokens = np.random.default_rng(3).integers(3, cfg.vocab_size, (2, 7))
    with torch.no_grad():
        ref = model.generate(torch.from_numpy(tokens), num_beams=3, early_stopping=True,
                             length_penalty=1.0, max_new_tokens=16, do_sample=False).numpy()
    ours = tm.generate_beam(params, cfg, torch.from_numpy(tokens), None, max_new=16,
                            beam_size=3).numpy()
    for i in range(2):
        assert [int(t) for t in ours[i] if t != 1] == [int(t) for t in ref[i, 1:] if t != 1]


# ---------------------------------------------------------------------------
# Tokenizer and translator
# ---------------------------------------------------------------------------

U = "▁"
PIECES = [
    ("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3), (U, -1.0, 1),
    ("h", -2.0, 1), ("e", -2.0, 1), ("l", -2.0, 1), ("o", -2.0, 1),
    ("w", -2.0, 1), ("r", -2.0, 1), ("d", -2.0, 1),
    ("he", -0.5, 1), ("ll", -0.6, 1), ("hell", -0.4, 1),
    ("hello", -0.2, 1), (U + "hello", -0.1, 1),
    (U + "w", -0.9, 1), ("or", -0.8, 1), ("ld", -0.85, 1),
    (U + "world", -0.15, 1), ("orld", -0.7, 1), (U + "worl", -3.0, 1),
]


def write_small100_dir(path, with_model=True):
    """A toy SMALL100 checkpoint dir: SentencePiece model, vocab.json,
    tokenizer_config.json and, with_model, a random model sized to the
    tokenizer's vocabulary (config.json, model.safetensors)."""
    os.makedirs(path, exist_ok=True)
    ttok.write_spm_model(os.path.join(path, "sentencepiece.bpe.model"), PIECES)
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for p, _, t in PIECES:
        if t == 1 and p not in vocab:
            vocab[p] = len(vocab)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "SMALL100Tokenizer"}, f)
    if with_model:
        # positions for a source bucket and 200 new tokens
        config = dict(TINY, vocab_size=len(vocab) + len(ttok.FAIRSEQ_LANGUAGE_CODES) + 8,
                      decoder_layers=1, max_position_embeddings=256)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f)
        sd = {k: v.contiguous() for k, v in hf_model(config, 4, 1.5).state_dict().items()}
        safetensors_io.save_file(sd, os.path.join(path, "model.safetensors"))
    return str(path)


@pytest.fixture(scope="module")
def small100_dir(tmp_path_factory):
    return write_small100_dir(tmp_path_factory.mktemp("small100"))


def test_tokenizer_ids_match_jax(small100_dir):
    ours = ttok.load_checkpoint_tokenizer(small100_dir)
    ref = jtok.load_checkpoint_tokenizer(small100_dir)
    assert isinstance(ours, ttok.SMALL100Tokenizer) and ttok.is_small100_checkpoint(small100_dir)
    for lang in ("de", "fr", "zu"):
        ours.tgt_lang = ref.tgt_lang = lang
        for text in ("hello world", "held", "zzz hello", ""):
            assert ours.encode(text) == ref.encode(text)
            assert ours.encode_target(text) == ref.encode_target(text)
            assert ours(text) == ref(text)
    ids = list(range(ours.vocab_size))
    assert ours.decode(ids) == ref.decode(ids)
    assert ours.decode(ids, skip_special_tokens=False) == ref.decode(ids, skip_special_tokens=False)
    assert ours.vocab_size == ref.vocab_size
    pieces = ttok.read_spm_model(os.path.join(small100_dir, "sentencepiece.bpe.model"))
    assert pieces == jtok.read_spm_model(os.path.join(small100_dir, "sentencepiece.bpe.model"))


@pytest.mark.parametrize("beam", ["1", "5"])
def test_translator_matches_jax_translator(small100_dir, beam, monkeypatch):
    monkeypatch.setenv("WL_TRANSLATE_BEAM", beam)
    ours = TorchTranslator(small100_dir, device="cpu")
    ref = jtranslation.JAXTranslator(small100_dir)
    assert ours.is_small100 and ours.beam_size == int(beam)
    assert ours.cfg.dtype == torch.float32 and ours.params["embed"].device.type == "cpu"
    for text, lang in (("hello world", "fr"), ("hello", "de"), ("world hello hello", "fr")):
        assert ours.translate(text, lang) == ref.translate(text, lang)
    out = ours.generate(torch.full((1, 16), 1).index_fill_(1, torch.tensor([0, 1, 2]), 5), "fr")
    assert out.shape == (1, 200)


def test_translator_runs_on_the_card_by_default(small100_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchTranslator(small100_dir)


def test_make_translator_raises_on_a_broken_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)  # fails before the card
    broken = write_small100_dir(tmp_path / "broken", with_model=False)
    with open(os.path.join(broken, "config.json"), "w") as f:
        json.dump(TINY, f)  # a config without model weights
    with pytest.raises(FileNotFoundError):
        make_translator(broken)
    with pytest.raises(FileNotFoundError):
        make_translator(str(tmp_path / "missing"))


def test_identity_fallback_when_no_model():
    t = make_translator(None)
    assert isinstance(t, IdentityTranslator)
    assert t.translate("bonjour", "en") == "bonjour"


# ---------------------------------------------------------------------------
# The worker's cases of tests/test_translation.py
# ---------------------------------------------------------------------------


class UpperTranslator:
    def translate(self, text, target_language):
        return f"[{target_language}] {text.upper()}"


class BoomTranslator:
    def translate(self, text, target_language):
        raise RuntimeError("model exploded")


class FakeClient:
    uid = "u1"

    def __init__(self):
        self.sent = []

    async def send(self, payload):
        self.sent.append(payload)


def _drive(translator, target, segments, want, send_original=False):
    async def main():
        client = FakeClient()
        w = TranslationWorker(client, target, translator, send_original=send_original)
        for seg in segments:
            w.queue.put(seg)
        w.poke()
        for _ in range(150):
            if sum(len(m["translated_segments"]) for m in client.sent) >= want:
                break
            await asyncio.sleep(0.02)
        await w.stop()
        return client.sent

    return asyncio.run(main())


def test_worker_translates_and_sends():
    sent = _drive(UpperTranslator(), "de", [{"start": "0.000", "end": "1.000", "text": "hello",
                                             "completed": True}], 1)
    assert sent, "nothing sent"
    msg = sent[0]
    assert msg["uid"] == "u1"
    segs = msg["translated_segments"]
    assert segs[0]["text"] == "[de] HELLO"
    assert segs[0]["start"] == "0.000"  # original timing preserved


def test_worker_survives_translator_error():
    sent = _drive(BoomTranslator(), "fr", [{"start": "0.000", "end": "1.000", "text": "hi",
                                            "completed": True}], 1)
    # error isolated: original text passes through
    assert sent and sent[0]["translated_segments"][0]["text"] == "hi"


def test_worker_batches_queue():
    segs = [{"start": f"{i}.000", "end": f"{i + 1}.000", "text": f"s{i}", "completed": True}
            for i in range(5)]
    sent = _drive(UpperTranslator(), "es", segs, 5)
    texts = [s["text"] for m in sent for s in m["translated_segments"]]
    assert texts == [f"[es] S{i}" for i in range(5)]


def test_worker_send_original_and_default_language():
    sent = _drive(UpperTranslator(), None, [{"start": "0.000", "end": "1.000", "text": "hi",
                                             "completed": True}], 1, send_original=True)
    seg = sent[0]["translated_segments"][0]
    assert seg["text"] == "[fr] HI" and seg["original_text"] == "hi"
