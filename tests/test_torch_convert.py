"""The port's checkpoint loading against the JAX package's and transformers'.

A `transformers` WhisperForConditionalGeneration with random weights (vocab
51865, width 64, 4 heads, 2 + 2 layers, 80 mels, 1500 encoder positions),
saved with safe_serialization=True, is the checkpoint; nothing is
downloaded. Stated tolerances: the converted tree bit-equal to
from_jax_params of the JAX package's load_hf_checkpoint (every leaf, dtype
included); the encoder within 5e-3 of transformers' (the convert CLI's
--verify bound) and the decoder's logits within 1e-3 of max|logit|; the
safetensors reader and writer byte-exact against the `safetensors` package.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from whisperlive_tpu.models import convert as jconvert
from whisperlive_tpu_torch import loader
from whisperlive_tpu_torch.models import convert as tconvert
from whisperlive_tpu_torch.models import safetensors_io
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.models.bridge import from_jax_params

torch.set_num_threads(2)

HF_DIMS = dict(vocab_size=51865, num_mel_bins=80, d_model=64, encoder_layers=2,
               encoder_attention_heads=4, decoder_layers=2, decoder_attention_heads=4,
               encoder_ffn_dim=256, decoder_ffn_dim=256, max_source_positions=1500,
               max_target_positions=448)


def hf_checkpoint(path, seed=1, **dims):
    """A random transformers Whisper saved as safetensors under `path`."""
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    torch.manual_seed(seed)
    model = WhisperForConditionalGeneration(HFConfig(**{**HF_DIMS, **dims})).eval()
    model.save_pretrained(str(path), safe_serialization=True)
    return str(path), model


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    return hf_checkpoint(tmp_path_factory.mktemp("hf") / "whisper-tiny-random")


def assert_trees_equal(a, b):
    da, db = safetensors_io.flatten_tree(a), safetensors_io.flatten_tree(b)
    assert da.keys() == db.keys()
    for k, x in da.items():
        y = db[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), k


def test_hf_checkpoint_converts_bit_equal_to_jax(hf_dir):
    path, _ = hf_dir
    cfg, tree = tconvert.load_hf_checkpoint(path)
    jcfg, jtree = jconvert.load_hf_checkpoint(path)
    for f in ("n_mels", "n_vocab", "n_audio_ctx", "n_audio_state", "n_audio_head",
              "n_audio_layer", "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert_trees_equal(tree, from_jax_params(jax.tree.map(np.asarray, jtree)))
    # the layouts: [d_in, d_out] linears on a stacked layer axis, torch convs
    assert tuple(tree["decoder"]["layers"]["mlp"]["fc1"]["w"].shape) == (2, 64, 256)
    assert tuple(tree["encoder"]["conv1"]["w"].shape) == (64, 80, 3)
    assert "b" not in tree["encoder"]["layers"]["attn"]["k"]


def test_whisper_conversion_unchanged_by_the_k_bias_option(hf_dir):
    """k_bias (M2M100's key-projection bias) defaults off: Whisper's tree is
    bit for bit what the blocks give with k_bias=False, and the JAX
    converter's leaves, with no key bias anywhere."""
    path, model = hf_dir
    sd = {k[len("model."):]: v for k, v in model.state_dict().items() if k.startswith("model.")}
    _, tree = tconvert.load_hf_checkpoint(path)
    for side, n, cross in (("encoder", 2, False), ("decoder", 2, True)):
        explicit = tconvert._stack([tconvert._block(sd, f"{side}.layers.{i}", cross, k_bias=False)
                                    for i in range(n)])
        assert_trees_equal(tree[side]["layers"], explicit)
        for attn in ("attn", "cross_attn") if cross else ("attn",):
            assert "b" not in tree[side]["layers"][attn]["k"]


def test_k_bias_reads_the_key_bias_as_jax():
    """With k_bias=True the key projections carry their bias, leaf for leaf
    as the JAX converter's _block_params(k_bias=True)."""
    rng = np.random.default_rng(5)
    d, f = 8, 16
    sd = {}
    for attn in ("self_attn", "encoder_attn"):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"l.{attn}.{proj}.weight"] = torch.from_numpy(rng.standard_normal((d, d),
                                                                                 np.float32))
            sd[f"l.{attn}.{proj}.bias"] = torch.from_numpy(rng.standard_normal(d, np.float32))
    for ln in ("self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm"):
        sd[f"l.{ln}.weight"] = torch.ones(d)
        sd[f"l.{ln}.bias"] = torch.zeros(d)
    sd["l.fc1.weight"], sd["l.fc1.bias"] = torch.ones(f, d), torch.zeros(f)
    sd["l.fc2.weight"], sd["l.fc2.bias"] = torch.ones(d, f), torch.zeros(d)
    ours = tconvert._block(sd, "l", cross=True, k_bias=True)
    ref = jconvert._block_params(sd, "l", cross=True, k_bias=True)
    flat, jflat = safetensors_io.flatten_tree(ours), safetensors_io.flatten_tree(
        jax.tree.map(lambda x: torch.from_numpy(np.asarray(x)), ref))
    assert flat.keys() == jflat.keys()
    for k in flat:
        assert torch.equal(flat[k], jflat[k]), k
    assert torch.equal(ours["attn"]["k"]["b"], sd["l.self_attn.k_proj.bias"])
    assert torch.equal(ours["cross_attn"]["k"]["b"], sd["l.encoder_attn.k_proj.bias"])


def test_encoder_and_logits_match_transformers(hf_dir):
    from whisperlive_tpu_torch.cli.convert import VERIFY_TOL, verify_encoder

    path, model = hf_dir
    cfg, tree = tconvert.load_hf_checkpoint(path)
    err = verify_encoder(path, cfg, tree)
    assert err is not None and err < VERIFY_TOL

    rng = np.random.default_rng(3)
    mel = torch.from_numpy(rng.standard_normal((1, 3000, 80)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 50000, (1, 12)).astype(np.int64))
    with torch.inference_mode():
        ref = model(input_features=mel.transpose(1, 2), decoder_input_ids=tokens).logits
        enc = tw.encode(tree, cfg, mel)
        cross = tw.compute_cross_kv(tree, cfg, enc)
        logits, _ = tw.decode_with_cross_attn(tree, cfg, tokens.int(), cross)
    assert logits.shape == ref.shape
    scale = float(ref.abs().max())
    assert float((logits - ref).abs().max()) <= 1e-3 * scale


def test_encoder_positions_default_to_sinusoids(hf_dir):
    path, _ = hf_dir
    cfg, _ = tconvert.load_hf_checkpoint(path)
    sd = safetensors_io.load_dir(path)
    del sd["model.encoder.embed_positions.weight"]
    tree = tconvert.params_from_state_dict(sd, cfg)
    np.testing.assert_array_equal(tree["encoder"]["pos"].numpy(), tw.sinusoids(1500, 64))
    # WhisperModel state dicts carry bare keys
    bare = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    assert_trees_equal(tconvert.params_from_state_dict(bare, cfg), tree)


def sample_tensors(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal(7).astype(np.float16),
        "bf16": rng.standard_normal((2, 3)).astype(jax.numpy.bfloat16),
        "i8": rng.integers(-128, 127, (4, 3)).astype(np.int8),
        "i64": rng.integers(-2**40, 2**40, 5).astype(np.int64),
        "odd": rng.integers(-128, 127, 3).astype(np.int8),  # 3 bytes: misaligns the rest
    }


def as_numpy(t):
    return t.view(torch.int16).numpy().view(jax.numpy.bfloat16) if t.dtype == torch.bfloat16 \
        else t.numpy()


def test_reader_matches_safetensors(tmp_path):
    import safetensors.numpy

    arrays = sample_tensors()
    path = str(tmp_path / "model.safetensors")
    safetensors.numpy.save_file(arrays, path)
    ours = safetensors_io.load_file(path)
    ref = safetensors.numpy.load_file(path)
    assert ours.keys() == ref.keys()
    for k, a in ref.items():
        assert as_numpy(ours[k]).dtype == a.dtype
        np.testing.assert_array_equal(as_numpy(ours[k]), a)


def test_sharded_index_matches_safetensors(tmp_path):
    import safetensors.numpy

    arrays = sample_tensors(1)
    shards = {"model-00001-of-00002.safetensors": ["f32", "bf16", "odd"],
              "model-00002-of-00002.safetensors": ["f16", "i8", "i64"]}
    weight_map = {}
    for file, names in shards.items():
        safetensors.numpy.save_file({n: arrays[n] for n in names}, str(tmp_path / file))
        weight_map.update(dict.fromkeys(names, file))
    with open(tmp_path / safetensors_io.INDEX_FILE, "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    ours = safetensors_io.load_dir(str(tmp_path))
    assert ours.keys() == arrays.keys()
    for k, a in arrays.items():
        np.testing.assert_array_equal(as_numpy(ours[k]), a)
    weight_map["missing"] = "model-00001-of-00002.safetensors"
    with open(tmp_path / safetensors_io.INDEX_FILE, "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    with pytest.raises(ValueError, match="missing"):
        safetensors_io.load_dir(str(tmp_path))


def test_writer_round_trip(tmp_path):
    import safetensors.numpy

    tensors = {k: from_jax_params({"x": a})["x"] for k, a in sample_tensors(2).items()}
    tensors["empty"] = torch.zeros((0, 4))
    path = str(tmp_path / "w.safetensors")
    safetensors_io.save_file(tensors, path, metadata={"format": "pt"})
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
    assert (8 + n) % 8 == 0
    ref = safetensors.numpy.load_file(path)
    back = safetensors_io.load_file(path)
    for k, t in tensors.items():
        np.testing.assert_array_equal(ref[k], as_numpy(t))
        assert back[k].dtype == t.dtype and torch.equal(back[k], t)
        if t.numel():
            assert back[k].data_ptr() % t.element_size() == 0  # aligned views


@pytest.mark.parametrize("code, np_dtype, t_dtype",
                         [("F64", np.float64, torch.float64), ("I32", np.int32, torch.int32)])
def test_other_dtypes_refused(tmp_path, code, np_dtype, t_dtype):
    """Only F32, F16, BF16, I8 and I64 are read and written."""
    import safetensors.numpy

    path = str(tmp_path / "x.safetensors")
    safetensors.numpy.save_file({"x": np.zeros(3, np_dtype)}, path)
    with pytest.raises(ValueError, match=f"unsupported dtype {code}"):
        safetensors_io.load_file(path)
    with pytest.raises(ValueError, match="unsupported dtype"):
        safetensors_io.save_file({"x": torch.zeros(3, dtype=t_dtype)}, path)


def test_converted_dir_round_trip(hf_dir, tmp_path):
    path, _ = hf_dir
    cfg, tree = tconvert.load_hf_checkpoint(path)
    tok = tmp_path / "tokenizer.json"
    tok.write_text("{}")
    out = str(tmp_path / "converted")
    tconvert.save_converted(out, cfg, tree, extra_meta={"distill_enc_ctx": 512},
                            tokenizer_file=str(tok))
    assert sorted(os.listdir(out)) == ["config.json", "params.safetensors", "tokenizer.json"]
    cfg2, tree2 = tconvert.load_converted(out)
    assert cfg2 == cfg
    assert_trees_equal(tree2, tree)
    assert loader.draft_distill_ctx(out) == 512
    assert loader.draft_distill_ctx(path) is None and loader.draft_distill_ctx(None) is None


def test_orbax_dir_is_refused(hf_dir, tmp_path):
    path, _ = hf_dir
    jcfg, jtree = jconvert.load_hf_checkpoint(path)
    out = str(tmp_path / "orbax")
    jconvert.save_converted(out, jcfg, jtree)
    for load in (tconvert.load_converted,
                 lambda d: loader.resolve_model("tiny", d, device="cpu")):
        with pytest.raises(ValueError, match="orbax.*HF checkpoint"):
            load(out)
    with pytest.raises(ValueError, match="neither"):
        tconvert.load_converted(str(tmp_path))


def test_loader_resolves_sizes_and_dirs(hf_dir, monkeypatch):
    with pytest.raises(SystemExit, match="unknown model size"):
        loader.resolve_model("huge", None, device="cpu")
    cfg, params, tok = loader.resolve_model("tiny", None, device="cpu", seed=3)
    assert cfg == tw.WHISPER_CONFIGS["tiny"] and tok is None
    assert_trees_equal(params, tw.init_params(cfg, 3, torch.float32, "cpu"))
    _, bf, _ = loader.resolve_model("tiny", None, dtype=torch.bfloat16, device="cpu")
    assert bf["decoder"]["embed"].dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="cuda"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        loader.resolve_model("tiny", None)
    monkeypatch.undo()
    # a dir without tokenizer.json never reaches the `tokenizers` package
    path, _ = hf_dir
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    cfg, tree, tok = loader.resolve_model("tiny", path, device="cpu")
    assert tok is None and cfg.n_audio_state == 64
    eng = loader.load_engine("tiny", path, device="cpu")
    assert eng.cfg.n_audio_state == 64 and eng.device.type == "cpu"
    assert torch.equal(eng.params["decoder"]["embed"], tree["decoder"]["embed"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shards", [1, 2])
def test_chip_smoke_writer_inverts_the_converter(tmp_path, dtype, shards):
    """chip_smoke's HF writer (the inverse mapping) round-trips a port tree
    bit for bit through load_hf_checkpoint; transformers reads its float32
    output as the same model."""
    cfg = tw.WhisperConfig(**dict(n_mels=80, n_vocab=51865, n_audio_ctx=1500,
                                  n_audio_state=64, n_audio_head=4, n_audio_layer=2,
                                  n_text_ctx=448, n_text_state=64, n_text_head=4,
                                  n_text_layer=2))
    src = tw.init_params(cfg, 5, dtype, "cpu")
    path = str(tmp_path / "hf")
    chip_smoke.write_hf_checkpoint(src, cfg, path, n_shards=shards)
    assert os.path.exists(os.path.join(path, safetensors_io.INDEX_FILE)) == (shards > 1)
    cfg2, tree = tconvert.load_hf_checkpoint(path)
    assert cfg2 == cfg
    assert_trees_equal(tree, src)
    if dtype == torch.float32 and shards == 1:
        from transformers import WhisperForConditionalGeneration

        model = WhisperForConditionalGeneration.from_pretrained(path).eval()
        mel = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (1, 3000, 80)).astype(np.float32))
        with torch.inference_mode():
            ref = model.model.encoder(mel.transpose(1, 2)).last_hidden_state
            ours = tw.encode(src, cfg, mel)
        assert float((ours - ref).abs().max()) < 1e-4
