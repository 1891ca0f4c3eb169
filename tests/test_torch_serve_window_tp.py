"""The window route under tensor parallelism, on the op log of a one-host
two-rank server, against the JAX package's one-process tp = 2 mesh.

The port's side runs once for the module: two processes (gloo on the CPU,
tests/torch_parallel_worker.py "window"), each building the same float and
int8 engines (width 64, 4 heads, 2 + 2 layers, 1500 encoder positions; the
int8 one with a 1-decoder-layer draft), their MultihostWindowEngines and a
plain and a speculative slot pool. Rank 0 serves every case through the
window scheduler and the backend while rank 1 replays the op log. The
reference is the JAX BatchScheduler / TpuBackend on JAX engines with
EngineShardings.create(tp=2) over the 8 virtual CPU devices, on the same
init_params weights. Bars (tests/test_torch_serve_multihost.py's): tokens
exact, avg_logprob within 1e-4, word boundaries within 0.02 s and
probabilities within 0.01.
"""

import asyncio
import dataclasses
import json
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import serve_multihost_worker as smw
import torch_parallel_worker as tpw
from whisperlive_tpu.engine.continuous import ContinuousScheduler as JPool
from whisperlive_tpu.engine.engine import TranscribeOptions as JOptions
from whisperlive_tpu.engine.engine import WhisperEngine as JEngine
from whisperlive_tpu.engine.scheduler import BatchRequest as JRequest
from whisperlive_tpu.engine.scheduler import BatchScheduler as JWindow
from whisperlive_tpu.engine.speculative import SpeculativeDecoder as JSpec
from whisperlive_tpu.models.whisper import init_params as j_init_params
from whisperlive_tpu.parallel.mesh import EngineShardings as JShardings
from whisperlive_tpu.serving import backends as jbackends
from whisperlive_tpu.serving import rest as jrest
from whisperlive_tpu.serving.session import SessionOptions as JSession

DIMS = dict(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)
DRAFT_DIMS = dict(DIMS, n_text_layer=1)
SPEC = dict(tp=2, dp=1, dims=DIMS, draft_dims=DRAFT_DIMS, max_new=12, spec_k=3, beam=3,
            beam_chunk=4, batch_s=(3.0, 2.0), rest_s=32.0,
            pool=dict(n_slots=2, steps_per_chunk=4, prompt_pad=48, ring=64),
            spec_pool=dict(n_slots=2, steps_per_chunk=4, prompt_pad=48, ring=60))


def reference(jp, jdp) -> dict:
    """Every case of the window scenario through the JAX package on its
    tp = 2 mesh, in the worker's order."""
    cfg = smw.serving_config()
    sh = JShardings.create(tp=2)

    def engine(c, params, quant):
        kw = dict(decoder_int8=True, cross_kv_bits=8) if quant else dict(
            decoder_int8=False, cross_kv_bits=16)
        eng = JEngine(c, params, compute_dtype=jnp.float32, batch_buckets=(1, 2),
                      tokenizer=smw.visible_tokenizer(cfg), shardings=sh, **kw)
        eng.enable_beam_chunk(SPEC["beam_chunk"])
        return eng

    eng, eng8 = engine(cfg, jp, False), engine(cfg, jp, True)
    draft8 = engine(dataclasses.replace(cfg, n_text_layer=1), jdp, True)
    greedy = JOptions(language="en", temperatures=(0.0,), log_prob_threshold=None,
                      no_speech_threshold=None, compression_ratio_threshold=None,
                      max_new_tokens=SPEC["max_new"])
    session = JSession(language="en", use_vad=False)
    win = JWindow(eng, max_batch_size=2, batch_window_ms=200)
    win8 = JWindow(eng8, max_batch_size=2, batch_window_ms=200)
    spec_dec = JSpec(eng8, draft8, k=SPEC["spec_k"])
    win8s = JWindow(eng8, max_batch_size=2, spec_decoder=spec_dec)
    main = JPool(eng, **SPEC["pool"])
    spec8 = JPool(eng8, draft_engine=draft8, spec_k=SPEC["spec_k"], **SPEC["spec_pool"])
    audios = [tpw.window_audio(s, 10 + i) for i, s in enumerate(SPEC["batch_s"])]
    out = {}

    def record(res):
        return {"tokens": list(map(int, res.raw_tokens)),
                "avg_logprob": [s.avg_logprob for s in res.segments],
                "words": smw.serialize_words(res)}

    def batch_of(sched, opts, audios, start=False):
        futs = [sched.submit(JRequest(audio=a, options=opts, uid=f"b{i}"))
                for i, a in enumerate(audios)]
        if start:
            sched.start()
        return [record(f.result(timeout=300)) for f in futs]

    try:
        out["batch"] = batch_of(win, greedy, audios, start=True)
        out["batch8"] = batch_of(win8, greedy, audios, start=True)
        out["fallback"] = batch_of(win, dataclasses.replace(
            greedy, temperatures=(0.0, 0.0), log_prob_threshold=-1.0), audios)
        out["words"] = batch_of(win, dataclasses.replace(greedy, word_timestamps=True),
                                audios[:1])
        for cs in (main, spec8):
            cs.start()

        class Ngram(jbackends.TpuBackend):
            def _adjust_options(self, topts, chunk):
                return dataclasses.replace(topts, no_repeat_ngram_size=3)

        ngram = Ngram(win, continuous_scheduler=main)
        out["ngram"] = record(asyncio.run(ngram.transcribe(audios[1], session, language="en",
                                                           uid="ng")))
        plain = jbackends.TpuBackend(win, continuous_scheduler=main)
        segs, _ = asyncio.run(jrest._transcribe_full(
            plain, tpw.window_audio(SPEC["rest_s"], 30), session, "en"))
        out["rest"] = [[s["start"], s["end"], s["tokens"]] for s in segs]
        hybrid = jbackends.TpuBackend(win, continuous_scheduler=main, beam_size=SPEC["beam"],
                                      beam_mode="refresh")
        out["hybrid"] = dict(record(asyncio.run(hybrid.transcribe(
            audios[0], session, language="en", uid="beam", window_anchor_s=0.0))),
            session=[list(map(int, main.submit(JRequest(audio=a, options=greedy, uid=f"l{i}"))
                          .result(timeout=300).raw_tokens)) for i, a in enumerate(audios)])
        win8s.start()
        out["spec"] = batch_of(win8s, greedy, audios[:1])[0]
        mixed = jbackends.TpuBackend(win8, spec_scheduler=spec8)
        out["mixed"] = record(asyncio.run(mixed.transcribe(audios[1], session, language="en",
                                                           uid="mx")))
    finally:
        for sched in (win, win8, win8s, main, spec8):
            sched.stop()
    return out


@pytest.fixture(scope="module")
def window_run(tmp_path_factory):
    """(leader's output, follower's output, the JAX reference's): the two
    ranks run in their processes while the reference runs here."""
    d = tmp_path_factory.mktemp("window_tp")
    cfg = smw.serving_config()
    jp = j_init_params(cfg, 0)
    jdp = j_init_params(dataclasses.replace(cfg, n_text_layer=1), 1)
    tpw.save_params(d / "params.npz", jax.tree.map(np.asarray, jp))
    tpw.save_params(d / "draft_params.npz", jax.tree.map(np.asarray, jdp))
    ranks = {}
    t = threading.Thread(target=lambda: ranks.update(
        outs=tpw.run_ranks("window", 2, str(d), SPEC, timeout=600)))
    t.start()
    saved = (jbackends._DISABLE_GATES, jbackends.STREAMING_MAX_NEW_TOKENS)
    jbackends._DISABLE_GATES, jbackends.STREAMING_MAX_NEW_TOKENS = True, SPEC["max_new"]
    try:
        ref = reference(jp, jdp)
    finally:
        jbackends._DISABLE_GATES, jbackends.STREAMING_MAX_NEW_TOKENS = saved
        t.join(timeout=660)
    assert "outs" in ranks, "the two ranks did not finish"
    lead, follower = (json.loads((d / f"out{r}.json").read_text()) for r in range(2))
    return lead, follower, ref


def same(live: dict, ref: dict) -> None:
    assert live["tokens"] == ref["tokens"]
    assert any(live["tokens"]), "no token decoded: the case proves nothing"
    np.testing.assert_allclose(live["avg_logprob"], ref["avg_logprob"], atol=1e-4)
    assert len(live["words"]) == len(ref["words"])
    for (ls, le, lw, lp), (rs, re_, rw, rp) in zip(live["words"], ref["words"]):
        assert lw == rw
        assert abs(ls - rs) <= 0.021 and abs(le - re_) <= 0.021
        assert abs(lp - rp) <= 0.01


@pytest.mark.parametrize("case", ["batch", "batch8", "fallback"])
def test_window_batches_token_exact(window_run, case):
    """A batch of two windows (float, int8 decoder and cross-KV) and the
    gate-failing batch retried on its gathered cross-KV."""
    lead, _, ref = window_run
    assert len(lead[case]) == len(ref[case]) == 2
    for live, want in zip(lead[case], ref[case]):
        same(live, want)
    if case == "fallback":
        assert all(max(r["avg_logprob"]) < -1.0 for r in ref[case])  # the retry ran


def test_word_timestamps_on_the_window_route(window_run):
    lead, _, ref = window_run
    assert ref["words"][0]["words"], "the reference produced no words"
    same(lead["words"][0], ref["words"][0])


def test_no_repeat_ngram_routes_to_the_window_scheduler(window_run):
    lead, _, ref = window_run
    assert lead["ngram"]["window"]
    same(lead["ngram"], ref["ngram"])


def test_rest_file_through_both_routes(window_run):
    """A 32 s file: its 30 s window over the pool's cap on the window
    scheduler, the rest on the pool."""
    lead, _, ref = window_run
    assert lead["rest"] == ref["rest"]
    assert len(lead["rest"]) >= 1 and max(s[1] for s in lead["rest"]) > 0.0


def test_hybrid_beam_beside_a_live_session(window_run):
    """A beamed full re-decode holds the dispatch order for its whole decode
    while the pool's session waits: both finish, each token-exact."""
    lead, _, ref = window_run
    hybrid = lead["hybrid"]
    assert hybrid["finished"] and hybrid["stats"] == {"greedy_partials": 0, "beamed_fulls": 1}
    same(hybrid, ref["hybrid"])
    assert hybrid["session"] == ref["hybrid"]["session"]


def test_window_speculation_and_the_mixed_pool(window_run):
    lead, _, ref = window_run
    assert lead["spec"]["windows"] == 1
    same(lead["spec"], ref["spec"])
    assert lead["mixed"]["routes"]["spec_fulls"] == 1
    same(lead["mixed"], ref["mixed"])


def test_follower_replayed_the_whole_stream(window_run):
    """The follower replayed every op the leader published (read before the
    stop; all but the hello), and both freed every handle."""
    lead, follower, _ = window_run
    assert follower["ops"] > 30
    assert lead["op_log"]["ops"] == follower["ops"] + 1
    assert lead["handles"] == follower["handles"] == [0, 0]
