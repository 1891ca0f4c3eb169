"""The port's continuous scheduler over a [dp, tp] grid against the JAX
scheduler on its mesh.

The JAX side is tests/test_continuous.py's: the scheduler over an engine
whose weights are sharded on this process's eight virtual CPU devices
(EngineShardings.create(tp=2): dp = 4 x tp = 2). The port's side is one
process per rank (tests/torch_parallel_worker.py, gloo on the CPU): rank
0 runs the ContinuousScheduler over a MultihostContinuousEngine and
publishes every device op on the op log, the other ranks replay it. Model:
80 mels, vocab 51865, 1500 encoder positions, width 64, 4 heads, 2 + 2
layers, float32, the same JAX init_params weights. Token streams are
exact: at tp = 2 (two ranks, two slots) and at dp = 2 x tp = 2 (four
ranks, four slots, the rows sharded over the data group).
"""

import json
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_worker as tpw
from whisperlive_tpu.engine.continuous import ContinuousScheduler as JScheduler
from whisperlive_tpu.engine.engine import TranscribeOptions as JOptions
from whisperlive_tpu.engine.engine import WhisperEngine as JEngine
from whisperlive_tpu.engine.scheduler import BatchRequest as JRequest
from whisperlive_tpu.models import whisper as jw
from whisperlive_tpu.parallel.mesh import EngineShardings as JShardings
from whisperlive_tpu_torch.engine import continuous as tcont
from whisperlive_tpu_torch.engine.engine import WhisperEngine as TEngine
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.parallel.mesh import EngineShardings

DIMS = dict(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)
MAX_NEW = 20
OPTS = JOptions(language="en", temperatures=(0.0,), log_prob_threshold=None,
                no_speech_threshold=None, compression_ratio_threshold=None,
                max_new_tokens=MAX_NEW)
POOL = dict(steps_per_chunk=4, prompt_pad=16, ring=64)
CASES = {
    # (tp, dp, slots, audio seeds): the two scheduler tests of test_continuous.py
    "tp2": (2, 1, 2, (11,)),
    "dp2xtp2": (2, 2, 4, (20, 21, 22, 23)),
}
INT8 = dict(decoder_int8=True, cross_kv_bits=8)
INT4 = dict(decoder_int8=True, cross_kv_bits=4)
DRAFT_DIMS = dict(DIMS, n_text_layer=1)
# the speculative and int4 pools under tp = 2 (the reference's --tp wiring;
# off phase 12's path on the card): (quantization, a draft, spec_k)
SPEC_CASES = {"int8_spec": (INT8, True, 2), "int4_plain": (INT4, False, 4),
              "int4_spec": (INT4, True, 3)}


def _audios(seeds):
    return [(np.random.default_rng(s).standard_normal(32000) * 0.1).astype(np.float32)
            for s in seeds]


def _jax_tokens(n_slots, seeds):
    cfg = jw.WhisperConfig(**DIMS)
    eng = JEngine(cfg, jw.init_params(cfg, 0), compute_dtype=jnp.float32,
                  batch_buckets=(1, 2), shardings=JShardings.create(tp=2))
    sched = JScheduler(eng, n_slots=n_slots, **POOL)
    sched.start()
    try:
        futs = [sched.submit(JRequest(audio=a, options=OPTS, uid=f"r{i}"))
                for i, a in enumerate(_audios(seeds))]
        return [list(map(int, f.result(timeout=300).raw_tokens)) for f in futs]
    finally:
        sched.stop()


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jw.init_params(jw.WhisperConfig(**DIMS), 0))


@pytest.mark.parametrize("case", sorted(CASES))
def test_continuous_scheduler_over_ranks_matches_jax_mesh(case, jax_params, tmp_path):
    tp, dp, n_slots, seeds = CASES[case]
    np.savez(tmp_path / "audio.npz", *_audios(seeds))
    tpw.save_params(tmp_path / "params.npz", jax_params)
    spec = dict(tp=tp, dp=dp, dims=DIMS, max_new=MAX_NEW, pool=dict(POOL, n_slots=n_slots))
    tpw.run_ranks("continuous", tp * dp, str(tmp_path), spec)
    outs = [json.loads((tmp_path / f"out{r}.json").read_text()) for r in range(tp * dp)]
    lead = outs[0]
    assert lead["dp_sharded"] == (dp > 1)
    assert lead["status_rows"] == n_slots and lead["status_active"] == 0
    assert all(o["ops"] == outs[1]["ops"] for o in outs[1:])
    # init, an insert per wave, steps, releases and the closing step
    assert outs[1]["ops"] >= 5 and lead["op_log"]["ops"] == outs[1]["ops"] + 1  # and the hello
    assert lead["tokens"] == _jax_tokens(n_slots, seeds)
    assert any(len(t) > 0 for t in lead["tokens"])


def _jax_plain_tokens(quant, seeds):
    """The JAX package's unsharded plain pool at the same quantization: a
    greedy speculative pool is token-exact against it."""
    cfg = jw.WhisperConfig(**DIMS)
    eng = JEngine(cfg, jw.init_params(cfg, 0), compute_dtype=jnp.float32, batch_buckets=(1, 2),
                  **quant)
    sched = JScheduler(eng, n_slots=2, **POOL)
    sched.start()
    try:
        futs = [sched.submit(JRequest(audio=a, options=OPTS, uid=f"r{i}"))
                for i, a in enumerate(_audios(seeds))]
        return [list(map(int, f.result(timeout=300).raw_tokens)) for f in futs]
    finally:
        sched.stop()


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_and_int4_pools_over_tp2_match_jax(case, jax_params, tmp_path):
    """A speculative pool (its draft sliced over the same grid, the verify
    window through K6's and K5's window form's plain versions) and an int4
    pool over tp = 2: the tokens of the JAX package's plain pool at the
    same quantization."""
    quant, draft, spec_k = SPEC_CASES[case]
    seeds = (11, 12)
    np.savez(tmp_path / "audio.npz", *_audios(seeds))
    tpw.save_params(tmp_path / "params.npz", jax_params)
    # a verify round takes spec_k + 2 ring columns: the ring holds a
    # window's MAX_NEW rounds even at no acceptance (the random draft's)
    ring = (spec_k + 2) * (MAX_NEW + 2) if draft else POOL["ring"]
    spec = dict(tp=2, dp=1, dims=DIMS, max_new=MAX_NEW, quant=quant,
                pool=dict(POOL, n_slots=2, spec_k=spec_k, ring=ring))
    if draft:
        tpw.save_params(tmp_path / "draft_params.npz", jax.tree.map(
            np.asarray, jw.init_params(jw.WhisperConfig(**DRAFT_DIMS), 1)))
        spec["draft_dims"] = DRAFT_DIMS
    tpw.run_ranks("continuous", 2, str(tmp_path), spec)
    lead = json.loads((tmp_path / "out0.json").read_text())
    assert lead["tokens"] == _jax_plain_tokens(quant, seeds)
    assert all(len(t) > 0 for t in lead["tokens"])


def test_slots_not_dividing_dp_stay_unsharded(caplog):
    """A pool whose slots do not divide dp keeps every slot on every data
    replica (with the reference's warning); one that does shards them."""
    cfg = tw.WhisperConfig(**DIMS)
    eng = TEngine(cfg, tw.init_params(cfg, 0), device="cpu", batch_buckets=(1,),
                  shardings=EngineShardings(tp=1, dp=2, rank=1))
    with caplog.at_level(logging.WARNING, logger=tcont.__name__):
        cb = tcont.ContinuousEngine(eng, n_slots=3, **POOL)
    assert not cb.dp_sharded and cb.local_slots == 3 and cb.slot_base == 0
    assert any("do not divide dp=2" in r.message for r in caplog.records)
    cb = tcont.ContinuousEngine(eng, n_slots=4, **POOL)
    assert cb.dp_sharded and cb.local_slots == 2 and cb.slot_base == 2
    assert [cb.owner(s) for s in range(4)] == [0, 0, 1, 1]
    cb.init_state()
    assert cb.state["active"].shape[0] == 2 and isinstance(cb.state["sampled"], torch.Tensor)
