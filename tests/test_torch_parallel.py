"""Tensor parallelism of the port against the JAX package's mesh.

The JAX side runs as tests/test_parallel.py runs it: on this process's
eight virtual CPU devices, EngineShardings.create(tp=2) (a dp = 4 x tp = 2
mesh). The port's side is two processes (tests/torch_parallel_worker.py,
tp = 2 over gloo on the CPU) on the same JAX init_params weights, carried
across as numpy; each rank slices them with parallel.mesh.shard_params.
Model: 2 + 2 layers, width 64, 4 heads. Stated tolerances, the
reference's: encode atol 1e-5 / rtol 1e-5; decode-step logits atol 2e-4 /
rtol 1e-4 (float32 sums in another order); engine tokens exact and
avg_logprob within 1e-4, at float and at decoder_int8 with int8 cross-KV.
The slicing rules and the int8 slices are exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_worker as tpw
from whisperlive_tpu.engine.engine import TranscribeOptions as JOptions
from whisperlive_tpu.engine.engine import WhisperEngine as JEngine
from whisperlive_tpu.models import whisper as jw
from whisperlive_tpu.parallel.mesh import EngineShardings as JShardings
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.models.bridge import _to_tensor
from whisperlive_tpu_torch.parallel import mesh as tmesh

DIMS = dict(n_mels=80, n_vocab=512, n_audio_ctx=32, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_text_ctx=16, n_text_state=64, n_text_head=4, n_text_layer=2)
ENGINE_DIMS = dict(DIMS, n_vocab=51865, n_audio_ctx=50, n_text_ctx=64)
ENGINE_OPTS = dict(language="en", temperatures=(0.0,), log_prob_threshold=None,
                   no_speech_threshold=None, compression_ratio_threshold=None, max_new_tokens=8)
QUANT = {"float": dict(decoder_int8=False, cross_kv_bits=16),
         "int8": dict(decoder_int8=True, cross_kv_bits=8)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _jax_slices(leaf, tp: int) -> dict:
    """{model index: numpy shard} of a JAX array laid out on the mesh."""
    out = {}
    for shard in leaf.addressable_shards:
        sliced = [(ax, sl) for ax, sl in enumerate(shard.index)
                  if sl.start not in (None, 0) or (sl.stop not in (None, leaf.shape[ax]))]
        if not sliced:
            out.setdefault("whole", np.asarray(shard.data))
            continue
        (ax, sl), = sliced
        out[(sl.start or 0) // (leaf.shape[ax] // tp)] = np.asarray(shard.data)
    return out


def _check_slices(jax_tree, torch_full, tp: int = 2) -> int:
    """Every leaf of the port's per-rank slices against the JAX shards."""
    checked = 0
    for rank in range(tp):
        mine = tmesh.shard_params(torch_full, tmesh.EngineShardings(tp=tp, rank=rank))
        for path, leaf in _walk(jax_tree):
            got = _get(mine, path)
            slices = _jax_slices(leaf, tp)
            want = slices.get("whole", slices.get(rank))
            assert want is not None, path
            axis = tmesh.param_spec(path, got)
            assert (axis is None) == ("whole" in slices), path
            np.testing.assert_array_equal(got.float().numpy() if got.dtype == torch.bfloat16
                                          else got.numpy(),
                                          np.asarray(want, np.float32) if got.dtype ==
                                          torch.bfloat16 else want, err_msg=str(path))
            checked += 1
    return checked


def test_param_slices_match_jax_shards():
    """Each rank's slice of every leaf equals the JAX shard of the same
    model index (q/k/v/fc1 by output columns, o/fc2 by input rows, the
    rest whole)."""
    cfg = jw.WhisperConfig(**DIMS)
    params = jw.init_params(cfg, seed=1)
    sh = JShardings.create(tp=2)
    sharded = jax.device_put(params, sh.param_shardings(params))
    full = {k: v for k, v in _walk(_np_tree(params))}
    torch_full = {}
    for path, arr in full.items():
        node = torch_full
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.from_numpy(np.array(arr))
    assert _check_slices(sharded, torch_full) > 40


def test_int8_slices_match_jax_engine_shards():
    """The quantized decoder is quantized whole, then sliced: every w8 / s
    / b slice equals the JAX tp = 2 engine's quantized shard (a row shard
    quantized alone would get other scales)."""
    cfg = jw.WhisperConfig(**ENGINE_DIMS)
    params = jw.init_params(cfg, seed=0)
    je = JEngine(cfg, params, compute_dtype=jnp.float32, batch_buckets=(1,),
                 shardings=JShardings.create(tp=2), **QUANT["int8"])
    full = tw.quantize_decoder_weights(
        jax.tree.map(lambda a: _to_tensor(np.asarray(a)), jax.tree.map(np.asarray, params)))
    jdec = {"decoder": {"layers": je.params["decoder"]["layers"]}}
    checked = _check_slices(jdec, {"decoder": {"layers": full["decoder"]["layers"]}})
    assert checked >= 2 * 30
    w8 = [p for p, _ in _walk(jdec) if p[-1] == "w8"]
    assert len(w8) == 10


def test_validate_refuses_tp_not_dividing_heads():
    cfg = tw.WhisperConfig(**DIMS)
    with pytest.raises(ValueError, match="must divide attention heads"):
        tmesh.EngineShardings(tp=3, dp=1, rank=0).validate(cfg)
    tmesh.EngineShardings(tp=2, dp=1, rank=1).validate(cfg)
    with pytest.raises(ValueError, match="outside"):
        tmesh.EngineShardings(tp=2, dp=1, rank=2)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """Two ranks (tp = 2) once: encode, a decode step and the engine at
    float and int8; returns both ranks' outputs and the inputs."""
    d = tmp_path_factory.mktemp("tp_model")
    rng = np.random.default_rng(0)
    inputs = dict(
        mel=rng.standard_normal((2, 2 * DIMS["n_audio_ctx"], 80)).astype(np.float32),
        tok=np.asarray([3, 5], np.int32), pos=np.asarray([2, 2], np.int32),
        plen=np.asarray([2, 2], np.int32),
        engine_mel=np.random.default_rng(7).standard_normal(
            (1, 2 * ENGINE_DIMS["n_audio_ctx"], 80)).astype(np.float32),
    )
    np.savez(d / "inputs.npz", **inputs)
    tpw.save_params(d / "params.npz", _np_tree(jw.init_params(jw.WhisperConfig(**DIMS), 1)))
    tpw.save_params(d / "engine_params.npz",
                    _np_tree(jw.init_params(jw.WhisperConfig(**ENGINE_DIMS), 0)))
    tpw.run_ranks("tp_model", 2, str(d), dict(tp=2, dims=DIMS, engine_dims=ENGINE_DIMS))
    return [dict(np.load(d / f"out{r}.npz")) for r in range(2)], inputs


def _jax_tp_encode_and_step(inputs):
    cfg = jw.WhisperConfig(**DIMS)
    params = jw.init_params(cfg, seed=1)
    sh = JShardings.create(tp=2)
    sh.validate(cfg)
    sp = jax.device_put(params, sh.param_shardings(params))
    mel = jnp.asarray(inputs["mel"])
    enc = np.asarray(jax.jit(lambda p, m: jw.encode(p, cfg, m))(sp, mel))
    tok, pos, plen = (jnp.asarray(inputs[k]) for k in ("tok", "pos", "plen"))

    def f(p, m, tok, pos):
        e = jw.encode(p, cfg, m)
        cross = jw.compute_cross_kv(p, cfg, e)
        kv = jw.init_self_kv(cfg, 2)
        return jw.decode_step(p, cfg, tok, pos, jnp.int32(4), plen, 4, kv, cross)[0]

    return enc, np.asarray(jax.jit(f)(sp, mel, tok, pos))


def test_ranks_agree(tp_run):
    outs, _ = tp_run
    for key in outs[0]:
        np.testing.assert_array_equal(outs[0][key], outs[1][key], err_msg=key)


def test_tp_encode_and_decode_step_match_jax_mesh(tp_run):
    outs, inputs = tp_run
    enc, logits = _jax_tp_encode_and_step(inputs)
    np.testing.assert_allclose(outs[0]["encode"], enc, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(outs[0]["logits"], logits, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_tp_engine_matches_jax_mesh_engine(tp_run, mode):
    outs, inputs = tp_run
    cfg = jw.WhisperConfig(**ENGINE_DIMS)
    je = JEngine(cfg, jw.init_params(cfg, seed=0), compute_dtype=jnp.float32,
                 batch_buckets=(1,), shardings=JShardings.create(tp=2), **QUANT[mode])
    opts = JOptions(**ENGINE_OPTS)
    _, cross = je.prepare_mel(jnp.asarray(inputs["engine_mel"]))
    p, s = je.build_prompt(opts)
    (res,) = je.decode_batch(cross, [p], [s], opts, seed=3)
    np.testing.assert_array_equal(outs[0][f"{mode}_tokens"], np.asarray(res.tokens))
    assert len(res.tokens) > 0
    assert float(outs[0][f"{mode}_avg_logprob"]) == pytest.approx(res.avg_logprob, abs=1e-4)
