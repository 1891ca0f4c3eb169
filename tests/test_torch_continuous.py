"""The port's continuous-batching path against the JAX package's.

Narrow model (80 mels, vocab 51865, 1500 encoder positions, width 64, 4
heads, 2 + 2 layers); the JAX parameters come from the JAX init_params and
are carried over with from_jax_params, every input is made with numpy, and
both sides run on the CPU in float32, once with float decoder weights and
cross-KV and once with decoder_int8=True, cross_kv_bits=8. Stated
tolerances: K5's plain version against the JAX kernel in interpret mode
1e-5 of max|ref| on active rows (float32 sums in another order); decode-step logits 1e-4 of max|logit| on active rows
(float32 sums in another order); the ring rules exact; the slot pool, the
scheduler and the backend token-exact.
"""

import asyncio
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlive_tpu.engine import continuous as jcont
from whisperlive_tpu.engine import tokenizer as jtok
from whisperlive_tpu.engine.engine import TranscribeOptions as JOptions
from whisperlive_tpu.engine.engine import WhisperEngine as JEngine
from whisperlive_tpu.engine.scheduler import BatchRequest as JRequest
from whisperlive_tpu.engine.scheduler import BatchScheduler as JWindow
from whisperlive_tpu.models import whisper as jw
from whisperlive_tpu.ops import attention as jattn
from whisperlive_tpu.ops import decoding as jdec
from whisperlive_tpu.serving import backends as jbackends
from whisperlive_tpu_torch.engine import continuous as tcont
from whisperlive_tpu_torch.engine import tokenizer as ttok
from whisperlive_tpu_torch.engine.engine import TranscribeOptions as TOptions
from whisperlive_tpu_torch.engine.engine import WhisperEngine as TEngine
from whisperlive_tpu_torch.engine.scheduler import BatchRequest as TRequest
from whisperlive_tpu_torch.engine.scheduler import BatchScheduler as TWindow
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.models.bridge import from_jax_params
from whisperlive_tpu_torch.ops import attention as tattn
from whisperlive_tpu_torch.ops import decoding as tdec
from whisperlive_tpu_torch.ops import ring_rules
from whisperlive_tpu_torch.parallel.mesh import EngineShardings
from whisperlive_tpu_torch.serving import backends as tbackends
from whisperlive_tpu_torch.serving.session import SessionOptions

torch.set_num_threads(2)

DIMS = dict(
    n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
    n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)
GREEDY = dict(language="en", temperatures=(0.0,), log_prob_threshold=None,
              no_speech_threshold=None, compression_ratio_threshold=None, max_new_tokens=20)


class JVisible(jtok.WhisperTokenizer):
    """Text tokens decode to visible words, so segments carry text."""

    def decode(self, tokens):
        return "".join(f" t{int(t)}" for t in tokens if int(t) < self.spec.eot)


class TVisible(ttok.WhisperTokenizer):
    decode = JVisible.decode


@functools.lru_cache(maxsize=None)
def make_engines(mode):
    """(JAX engine, port engine) on the same parameters, built once per mode."""
    quant = mode == "int8"
    kw = dict(decoder_int8=quant, cross_kv_bits=8 if quant else 16)
    jcfg, tcfg = jw.WhisperConfig(**DIMS), tw.WhisperConfig(**DIMS)
    jp = jw.init_params(jcfg, 0)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    je = JEngine(jcfg, jp, compute_dtype=jnp.float32, batch_buckets=(1, 2),
                 tokenizer=JVisible(jtok.TokenSpec(51865, multilingual=True)), **kw)
    te = TEngine(tcfg, tp, batch_buckets=(1, 2), device="cpu",
                 tokenizer=TVisible(ttok.TokenSpec(51865, multilingual=True)), **kw)
    return je, te


@pytest.fixture(params=["float", "int8"])
def engines(request):
    return make_engines(request.param)


def audio_of(seconds, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)


# ---------------------------------------------------------------------------
# K5: the plain version against the JAX kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["mixed_lengths", "half_active", "len0_active"])
def test_k5_plain_version_matches_jax_kernel(case):
    rng = np.random.default_rng(5)
    b, h, t, hd = 6, 4, 64, 64
    q = rng.standard_normal((b, h, hd)).astype(np.float32) * 0.05
    kvp = rng.integers(-127, 128, (b, h, t, 2 * hd)).astype(np.int8)
    lengths = np.array([64, 17, 1, 64, 33, 8], np.int32)
    active = np.ones(b, bool)
    if case == "half_active":
        active[1::2] = False
    elif case == "len0_active":
        lengths[2] = 0
        active[[0, 4]] = False
    ref = np.asarray(jattn.cross_attention_int8(
        jnp.asarray(q), jnp.asarray(kvp), lengths=jnp.asarray(lengths),
        active=jnp.asarray(active), interpret=True))
    args = (torch.from_numpy(q), torch.from_numpy(kvp), torch.from_numpy(lengths),
            torch.from_numpy(active))
    out = tattn.cross_attention_int8_skip(*args).numpy()
    via_k4_entry = tattn.cross_attention_int8(*args).numpy()
    scale = np.abs(ref[active]).max()
    np.testing.assert_allclose(out[active], ref[active], atol=1e-5 * scale, rtol=0)
    np.testing.assert_array_equal(via_k4_entry, out)
    assert not out[~active].any()  # the port's inactive rows are zero
    if case == "len0_active":  # every position masked: a uniform softmax
        v = kvp[2, :, :, hd:].astype(np.float32).mean(axis=1)
        np.testing.assert_allclose(out[2], v, atol=1e-3)
    with pytest.raises(ValueError, match="lengths"):
        tattn.cross_attention_int8(args[0], args[1], None, args[3])


# ---------------------------------------------------------------------------
# decode_step_masked with cross_len and active
# ---------------------------------------------------------------------------


def test_decode_step_masked_matches_jax(engines):
    je, te = engines
    rng = np.random.default_rng(7)
    b, c, t = 4, 24, 48
    cfg = je.cfg
    enc = rng.standard_normal((b, t, cfg.n_audio_state)).astype(np.float32)
    jcross = jw.compute_cross_kv(je.params, je.cfg, jnp.asarray(enc))
    tcross = tw.compute_cross_kv(te.params, te.cfg, torch.from_numpy(enc))
    if te.cross_kv_bits == 8:
        jcross, tcross = jw.quantize_cross_kv(jcross), tw.quantize_cross_kv(tcross)
    self_kv = rng.standard_normal((cfg.n_text_layer, 2, b, c, cfg.n_text_head, 16)).astype(
        np.float32)
    token = np.array([50, 700, 9000, 3], np.int32)
    pos = np.array([5, 9, 2, 7], np.int32)
    mask = rng.random((b, c)) < 0.6
    cross_len = np.array([48, 20, 0, 31], np.int32)
    active = np.array([True, True, True, False])
    jlog, jkv = jw.decode_step_masked(
        je.params, je.cfg, jnp.asarray(token), jnp.asarray(pos), 11, jnp.asarray(mask),
        jnp.asarray(self_kv), jcross, cross_len=jnp.asarray(cross_len),
        active=jnp.asarray(active))
    tkv = torch.from_numpy(self_kv.copy())
    tlog = tw.decode_step_masked(
        te.params, te.cfg, torch.from_numpy(token), torch.from_numpy(pos), 11,
        torch.from_numpy(mask), tkv, tcross, cross_len=torch.from_numpy(cross_len),
        active=torch.from_numpy(active))
    jlog = np.asarray(jlog)
    scale = np.abs(jlog[active]).max()
    np.testing.assert_allclose(tlog.numpy()[active], jlog[active], atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(tkv.numpy()[:, :, active][:, :, :, 11],
                               np.asarray(jkv)[:, :, active][:, :, :, 11], atol=1e-4, rtol=0)
    # every other cache column is untouched
    untouched = np.delete(np.arange(c), 11)
    np.testing.assert_array_equal(tkv.numpy()[:, :, :, untouched], self_kv[:, :, :, untouched])


# ---------------------------------------------------------------------------
# ring rules
# ---------------------------------------------------------------------------


def _rule_inputs(seed):
    rng = np.random.default_rng(seed)
    b, v, g = 6, 51865, 16
    spec_j = jdec.DecodingSpec(n_vocab=v, eot=50257, blank=220, no_speech=50362,
                               timestamp_begin=50364)
    spec_t = tdec.DecodingSpec(**dataclasses.asdict(spec_j))
    tb = spec_j.timestamp_begin
    logits = rng.standard_normal((b, v)).astype(np.float32) * 3
    logits[:, tb:] += 2.0  # let the timestamp rules bite
    sampled = rng.integers(0, v, (b, g)).astype(np.int32)
    sampled[:, ::3] = tb + rng.integers(0, 100, (b, (g + 2) // 3))
    return dict(
        spec=(spec_j, spec_t), logits=logits, sampled=sampled,
        gen_len=np.array([0, 1, 2, 5, 0, 9], np.int32),
        last_ts=np.array([tb - 1, tb + 3, tb - 1, tb + 40, tb + 7, tb + 12], np.int32),
        suppress=rng.random(v) < 0.01, ts_enabled=np.array([1, 1, 1, 1, 0, 1], bool),
        has_prefix=np.array([0, 1, 1, 0, 1, 0], bool),
        pfx_last_ts=np.array([0, 1, 0, 0, 1, 1], bool),
        pfx_penult_ts=np.array([1, 0, 1, 0, 1, 0], bool),
        join_step=np.array([0, 3, 10, 13, 20, 2], np.int32),
        penalty=np.array([1.0, 1.3, 1.0, 2.0, 1.1, 1.0], np.float32),
        prompt_toks=rng.integers(0, v, (b, 12)).astype(np.int32),
        prompt_len=np.array([3, 12, 0, 5, 7, 1], np.int32),
    )


@pytest.mark.parametrize("gstep", [0, 1, 7, 23])
def test_ring_rules_match_jax(gstep):
    x = _rule_inputs(gstep)
    spec_j, spec_t = x["spec"]
    J, T = (lambda a: jnp.asarray(a)), torch.from_numpy
    names = ("gen_len", "last_ts", "suppress", "ts_enabled", "has_prefix", "pfx_last_ts",
             "pfx_penult_ts")
    ref = jcont.apply_logit_rules_ring(
        spec_j, J(x["logits"]), J(x["sampled"]), jnp.int32(gstep),
        *(J(x[n]) for n in names))
    out = ring_rules.apply_logit_rules_ring(
        spec_t, T(x["logits"]), T(x["sampled"]), gstep, *(T(x[n]) for n in names))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

    first = x["gen_len"] == 0
    lw, pw = x["pfx_last_ts"], x["pfx_penult_ts"]
    ref = jcont.apply_logit_rules_tracked(
        spec_j, J(x["logits"]), J(x["suppress"]), J(x["ts_enabled"]), J(first), J(lw), J(pw),
        J(x["last_ts"]))
    out = ring_rules.apply_logit_rules_tracked(
        spec_t, T(x["logits"]), T(x["suppress"]), T(x["ts_enabled"]), T(first), T(lw), T(pw),
        T(x["last_ts"]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

    ring = x["sampled"].shape[1]
    valid_j = jcont._ring_valid(jnp.int32(gstep), J(x["join_step"]), ring)
    valid_t = ring_rules.ring_valid(gstep, T(x["join_step"]), ring)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    for penalty in (x["penalty"], np.ones_like(x["penalty"])):
        ref = jcont.apply_repetition_penalty_ring(
            J(x["logits"]), J(x["sampled"]), valid_j, J(penalty),
            prompt_toks=J(x["prompt_toks"]), prompt_len=J(x["prompt_len"]))
        out = ring_rules.apply_repetition_penalty_ring(
            T(x["logits"]), T(x["sampled"]), valid_t, T(penalty),
            prompt_toks=T(x["prompt_toks"]), prompt_len=T(x["prompt_len"]))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# ContinuousEngine: the slot pool
# ---------------------------------------------------------------------------


def _strip(eng, toks):
    return [int(t) for t in toks if t != eng.spec.eot]


def _poison(mod, cb):
    """Fill the cross region with ones: an unmasked stale tail would then
    change the tokens."""
    if mod is jcont:
        cb.state["cross_kv"] = jax.tree.map(
            lambda a: jnp.ones_like(a) if a is not None else a, cb.state["cross_kv"])
    else:
        for leaf in cb.state["cross_kv"].values():
            if leaf is not None:
                leaf.fill_(1)


def _pool_run(mod, eng, opts_cls):
    """One slot-pool history, the same on both sides (mirrors
    tests/test_continuous.py): window A is inserted at the reduced 512-
    position context into a poisoned cross region; window B joins slot 1
    while A is mid-flight, at the full context; A's slot is released and
    reused by window C after the global step has wrapped the ring; A idles
    finished while B still steps. Returns each window's hypothesis, read
    from the harvest and from the status row."""
    cb = mod.ContinuousEngine(eng, n_slots=2, prompt_pad=16, ring=32, steps_per_chunk=3,
                              cross_ctx=640)
    cb.init_state()
    _poison(mod, cb)
    p, s = eng.build_prompt(opts_cls(**GREEDY), language="en")
    out, joins, gstep = {}, {}, 0

    def insert(name, slot, seconds, seed, enc_ctx, budget):
        joins[name] = (slot, gstep)
        cb.insert(np.stack([audio_of(seconds, seed)]), [p], [s], [True], [slot], [0.0],
                  [True], [1.0], [budget], enc_ctx=enc_ctx)

    def run_until(names):
        nonlocal gstep
        for _ in range(100):
            status = cb.step()
            gstep += cb.steps_per_chunk
            for name in names:
                slot, join = joins[name]
                if name not in out and status[slot, 1] > 0.5:
                    gen = int(status[slot, 2])
                    out[name] = _strip(eng, cb.harvest(slot, join, gen))
                    out[name + "_status"] = _strip(eng, cb.unroll_row(status[slot], join, gen))
            if all(n in out for n in names):
                return
        raise AssertionError(f"{names} never finished")

    insert("a", 0, 3.0, 1, 512, 20)
    cb.step()
    cb.step()
    gstep += 2 * cb.steps_per_chunk
    insert("b", 1, 2.0, 2, 1500, 28)
    run_until(["a", "b"])
    cb.release([0])
    insert("c", 0, 4.0, 3, 512, 20)
    run_until(["c"])
    assert gstep > cb.ring  # the ring wrapped while slots held hypotheses
    return out


@functools.lru_cache(maxsize=None)
def pool_runs(mode):
    je, te = make_engines(mode)
    return _pool_run(jcont, je, JOptions), _pool_run(tcont, te, TOptions)


@pytest.mark.parametrize("window", ["a", "b", "c"],
                         ids=["reduced_context", "midflight_join", "slot_reuse_ring_wrap"])
@pytest.mark.parametrize("mode", ["float", "int8"])
def test_continuous_engine_token_exact_vs_jax(mode, window):
    ref, out = pool_runs(mode)
    assert out[window] == ref[window]
    assert out[window + "_status"] == out[window]
    assert len(out[window]) > 0


def test_continuous_state_stays_finite_and_zero_on_free_rows():
    """int8 pool: the free slot's rows never receive non-finite values, and
    the status reports it inactive."""
    _, te = make_engines("int8")
    cb = tcont.ContinuousEngine(te, n_slots=3, prompt_pad=16, ring=32, steps_per_chunk=4,
                                cross_ctx=640)
    cb.init_state()
    p, s = te.build_prompt(TOptions(**GREEDY), language="en")
    cb.insert(np.stack([audio_of(2.0, 8)]), [p], [s], [True], [1], [0.0], [True], [1.0], [6],
              enc_ctx=512)
    status = cb.step()
    assert status.shape == (3, 6 + 32)
    assert status[1, 0] == 1.0 and status[0, 0] == 0.0 and status[2, 0] == 0.0
    assert torch.isfinite(cb.state["logits"][1]).all()
    assert torch.isfinite(cb.state["self_kv"]).all()
    assert int(cb.state["idle_row_steps"]) == cb.steps_per_chunk
    assert cb.gstep == 4 and int(cb.state["cross_len"][1]) == 512


# ---------------------------------------------------------------------------
# The captured step's arithmetic: the global step on the device
# ---------------------------------------------------------------------------


def _leaves(state):
    out = {}
    for name, x in state.items():
        for sub, leaf in (x.items() if isinstance(x, dict) else [("", x)]):
            if leaf is not None:
                out[f"{name}/{sub}" if sub else name] = leaf
    return out


def _device_gstep_history(on_device: bool, prefix: bool):
    """A pool history driven through step_chunk with the global step a host
    int or a [1] device tensor: two windows join, one slot is released and
    reused, and the global step wraps the 16-column ring. Returns the state
    after every chunk."""
    from whisperlive_tpu_torch.engine.continuous_step import step_chunk

    _, te = make_engines("int8")
    cb = tcont.ContinuousEngine(te, n_slots=3, prompt_pad=16, ring=16, steps_per_chunk=5,
                                cross_ctx=640)
    cb.init_state()
    p, s = te.build_prompt(TOptions(**GREEDY), language="en")
    snaps = []

    def insert(slot, seconds, seed, budget):
        pfx = dict(last_ts=[te.spec.timestamp_begin + 20], has_prefix=[True],
                   pfx_last_ts=[True], pfx_penult_ts=[False]) if prefix else {}
        cb.insert(np.stack([audio_of(seconds, seed)]), [p], [s], [True], [slot], [0.0],
                  [True], [1.0], [budget], enc_ctx=512, **pfx)

    def chunk():
        g = torch.full((1,), cb.gstep, dtype=torch.int64) if on_device else cb.gstep
        step_chunk(te, cb.state, g, cb.steps_per_chunk, cb.ring, cb.prompt_pad,
                   cb.suppress_mask, False, False, cb._gen)
        if on_device:
            assert int(g) == cb.gstep + cb.steps_per_chunk
        cb.gstep += cb.steps_per_chunk
        snaps.append({k: v.clone() for k, v in _leaves(cb.state).items()})

    insert(0, 2.0, 31, 12)
    chunk()
    insert(2, 1.5, 32, 14)
    chunk()
    chunk()
    cb.release([0])
    insert(0, 2.5, 33, 12)
    for _ in range(3):
        chunk()
    assert cb.gstep > cb.ring
    return snaps


@pytest.mark.parametrize("prefix", [False, True], ids=["fresh", "prefix"])
def test_device_gstep_step_equals_host_gstep_step(prefix):
    """The captured step's form (global step, ring columns and cache slot on
    the device, read and written through index ops) gives the host-int
    step's state bit for bit, over chunks that wrap the ring with an insert
    and a release between them."""
    host = _device_gstep_history(False, prefix)
    dev = _device_gstep_history(True, prefix)
    assert len(host) == len(dev)
    for h, d in zip(host, dev):
        assert h.keys() == d.keys()
        for name in h:
            assert torch.equal(h[name], d[name]), name
    assert int((host[-1]["gen_len"] > 0).sum()) >= 2


GRAPH_RULE = {
    "greedy": ({}, True), "cpu": ({"device": "cpu"}, False), "sampling": ({"sampling": True}, False),
    "penalty": ({"penalty": True}, False), "lanes": ({"lanes": 2}, False),
    "spec_k": ({"spec_k": 4}, False), "tp2": ({"tp": 2}, False),
}


@pytest.mark.parametrize("case", list(GRAPH_RULE))
def test_graph_engages_only_for_the_fixed_greedy_step(case):
    """The CUDA graph replays a chunk only where it is one fixed program: on
    the card, tp = 1, one lane, no draft, no row at T > 0 and no repetition
    penalty. The engine's device and tp are stood in for, the rest are the
    pool's own attributes and the host's flags."""
    import types

    kw, want = GRAPH_RULE[case]
    _, te = make_engines("float")
    cb = tcont.ContinuousEngine(te, n_slots=2, prompt_pad=16, ring=32, steps_per_chunk=2)
    cb.eng = types.SimpleNamespace(device=torch.device(kw.get("device", "cuda")),
                                   cfg=types.SimpleNamespace(tp=kw.get("tp", 1)))
    cb.beam_width = kw.get("lanes", 1)
    cb.spec_k = kw.get("spec_k", 0)
    assert cb.graphable(kw.get("sampling", False), kw.get("penalty", False)) is want


def test_cpu_pool_steps_eagerly_and_counts_it():
    _, te = make_engines("int8")
    cs = tcont.ContinuousScheduler(te, n_slots=2, steps_per_chunk=3, prompt_pad=16, ring=32)
    cb = cs.cb
    cb.init_state()
    p, s = te.build_prompt(TOptions(**GREEDY), language="en")
    cb.insert(np.stack([audio_of(2.0, 34)]), [p], [s], [True], [1], [0.0], [True], [1.0], [6],
              enc_ctx=512)
    cb.step()
    cb.step()
    assert not cb.last_graph and cb._graph is None
    assert cb.graph_stats == {"graph_steps": 0, "eager_steps": 6, "graph_captures": 0}
    # the scheduler's counters are numbers (the benchmark subtracts every key)
    assert {"graph_steps", "eager_steps", "graph_captures"} <= cs.tick_stats.keys()
    assert all(isinstance(v, (int, float)) for v in cs.tick_stats.values())


@pytest.mark.parametrize("lanes", [1, 2], ids=["greedy", "beam2"])
def test_init_state_empties_the_pool_in_place(lanes):
    """A second init_state keeps every state tensor's storage (a captured
    step stays valid through warm-up and error recovery) and gives a fresh
    state's values."""
    from whisperlive_tpu_torch.engine import continuous_state as cstate

    _, te = make_engines("int8")
    cb = tcont.ContinuousEngine(te, n_slots=2, prompt_pad=16, ring=32, steps_per_chunk=3,
                                cross_ctx=640, beam_width=lanes)
    cb.init_state()
    ptrs = {k: v.data_ptr() for k, v in _leaves(cb.state).items()}
    p, s = te.build_prompt(TOptions(**GREEDY), language="en")
    cb.insert(np.stack([audio_of(2.0, 35)]), [p], [s], [True], [0], [0.0], [True], [1.2], [6],
              enc_ctx=512)
    cb.step()
    assert cb.gstep > 0 and bool(cb.state["active"].any())
    cb.init_state()
    assert cb.gstep == 0
    # a beam pool's step swaps self_kv and its spare: the same two buffers
    after = {k: v.data_ptr() for k, v in _leaves(cb.state).items()}
    assert sorted(after.values()) == sorted(ptrs.values())
    assert lanes > 1 or after == ptrs
    fresh = _leaves(cstate.init_state(te.cfg, te.spec, cb.n_rows, 16, 32, 640, te.cross_kv_bits,
                                      te.device, lanes=lanes))
    got = _leaves(cb.state)
    assert got.keys() == fresh.keys()
    for name, x in fresh.items():
        assert torch.equal(got[name], x), name


# ---------------------------------------------------------------------------
# ContinuousScheduler end to end
# ---------------------------------------------------------------------------


def _scheduler_run(mod, eng, opts_cls, req_cls):
    sched = mod.ContinuousScheduler(eng, n_slots=2, steps_per_chunk=4, prompt_pad=16, ring=64)
    retry = opts_cls(language="en", temperatures=(0.0, 0.0), log_prob_threshold=0.0,
                     no_speech_threshold=None, compression_ratio_threshold=None,
                     max_new_tokens=8)
    detect = opts_cls(**dict(GREEDY, language=None, max_new_tokens=8))
    plain = opts_cls(**dict(GREEDY, max_new_tokens=12))
    sched.start()
    try:
        out = []
        for i, opts in enumerate((retry, detect, plain)):  # one at a time: same waves
            req = req_cls(audio=audio_of(2.0 + 0.5 * i, 10 + i), options=opts, uid=f"r{i}")
            r = sched.submit(req).result(timeout=180)
            out.append(dict(
                raw=r.raw_tokens, lang=r.language, lang_prob=r.language_prob,
                segs=[(g.start, g.end, g.text, g.temperature, tuple(g.tokens))
                      for g in r.segments],
                dur=r.duration, adv=r.advance_s,
            ))
        return out
    finally:
        sched.stop()


def test_continuous_scheduler_matches_jax(engines):
    je, te = engines
    ref = _scheduler_run(jcont, je, JOptions, JRequest)
    out = _scheduler_run(tcont, te, TOptions, TRequest)
    for a, b in zip(ref, out):
        assert abs(a.pop("lang_prob") - b.pop("lang_prob")) <= 1e-4
        assert a == b
    assert ref[0]["raw"] == ()  # the retry ran and still failed: no prefix seed
    assert ref[1]["lang"] in je.tokenizer.spec.language_codes
    assert any(r["segs"] for r in ref)


def test_continuous_scheduler_refuses_unported_options():
    """Beam lanes (not with a draft) and word timestamps are taken: such
    requests queue instead of failing. Shardings are taken too
    (parallel/mesh.py): a tensor-parallel degree that does not divide the
    heads is refused, int8 or int4."""
    _, te = make_engines("float")
    assert tcont.ContinuousEngine(te, n_slots=2, beam_width=2).n_rows == 4
    with pytest.raises(ValueError, match="beam_width=1"):
        tcont.ContinuousEngine(te, n_slots=2, beam_width=2, draft_engine=te, spec_k=4)
    sched = tcont.ContinuousScheduler(te, n_slots=2)  # never started
    for opts in (TOptions(word_timestamps=True), TOptions(beam_size=3)):
        fut = sched.submit(TRequest(audio=np.zeros(16000, np.float32), options=opts))
        assert not fut.done() and sched._queue.qsize() > 0
    cfg = tw.WhisperConfig(**DIMS)
    params = tw.init_params(cfg)
    with pytest.raises(ValueError, match="must divide attention heads"):
        TEngine(cfg, params, device="cpu", shardings=EngineShardings(tp=3))
    with pytest.raises(ValueError, match="must divide attention heads"):
        TEngine(cfg, params, device="cpu", cross_kv_bits=4, shardings=EngineShardings(tp=3))
    with pytest.raises(ValueError, match="cross_kv_bits"):
        TEngine(cfg, params, device="cpu", cross_kv_bits=3)


# ---------------------------------------------------------------------------
# TorchBackend: routing and the incremental prefix, against TpuBackend
# ---------------------------------------------------------------------------


@pytest.fixture
def greedy_gates_off(monkeypatch):
    for mod in (jbackends, tbackends):
        monkeypatch.setattr(mod, "_DISABLE_GATES", True)
        monkeypatch.setattr(mod, "STREAMING_MAX_NEW_TOKENS", 24)


def _backend_run(mod_cont, backend_cls, window_cls, eng, **kw):
    cs = mod_cont.ContinuousScheduler(eng, n_slots=2, steps_per_chunk=4, prompt_pad=64,
                                      ring=64)
    submitted = []
    submit = cs.submit
    cs.submit = lambda req: submitted.append(tuple(req.prefix_tokens)) or submit(req)
    backend = backend_cls(window_cls(eng), model_name="test", continuous_scheduler=cs, **kw)
    long_audio = audio_of(6.0, 21)
    opts = SessionOptions(language="en", use_vad=False)

    async def stream():
        out = []
        for n in (2.0, 3.0, 4.0, 5.0):  # the tail grows, the anchor stays
            r = await backend.transcribe(long_audio[: int(16000 * n)], opts, language="en",
                                         uid="s", window_anchor_s=0.0)
            out.append((r.raw_tokens, [(g.start, g.end, g.text) for g in r.segments]))
        # a moved anchor evicts the cached hypothesis
        r = await backend.transcribe(long_audio[16000:], opts, language="en", uid="s",
                                     window_anchor_s=1.0)
        out.append((r.raw_tokens, [(g.start, g.end, g.text) for g in r.segments]))
        return out

    cs.start()
    try:
        return asyncio.run(stream()), submitted, backend
    finally:
        cs.stop()


def test_backend_incremental_prefix_matches_jax(greedy_gates_off):
    je, te = make_engines("float")
    ref, jsub, _ = _backend_run(jcont, jbackends.TpuBackend, JWindow, je)
    out, tsub, backend = _backend_run(tcont, tbackends.TorchBackend, TWindow, te)
    assert out == ref
    assert tsub == jsub
    assert any(tsub[1:4]) and tsub[0] == () and tsub[4] == ()
    assert backend.cadence_spacing_s("s") == 0.0  # the pool never saturated
    # routing: another suppress set, n-gram bans and over-cap windows take
    # the window path
    cs = backend.continuous_scheduler
    assert backend._pick_scheduler(TOptions(), 3.0) is cs
    assert backend._pick_scheduler(TOptions(suppress_tokens=(5,)), 3.0) is backend.scheduler
    assert backend._pick_scheduler(TOptions(no_repeat_ngram_size=3), 3.0) is backend.scheduler
    assert backend._pick_scheduler(TOptions(), cs.max_window_s + 0.1) is backend.scheduler
    backend.release("s")
    assert "s" not in backend._prefix_cache


def test_cli_builds_continuous_by_default():
    from whisperlive_tpu_torch.cli.run_server import build_parser, create_backend, stop_backend

    args = build_parser().parse_args(
        ["--model", "tiny", "--device", "cpu", "--no_warmup", "--continuous_slots", "2"])
    assert args.continuous_batching and args.steps_per_chunk == 8
    assert args.continuous_cross_ctx is None
    backend = create_backend(args)
    try:
        cs = backend.continuous_scheduler
        assert isinstance(cs, tcont.ContinuousScheduler)
        assert cs.cb.n_slots == 2 and cs.cb.cross_ctx == 640
        assert cs.cb.enc_buckets == (512, 1500)
    finally:
        stop_backend(backend)
    args = build_parser().parse_args(
        ["--model", "tiny", "--device", "cpu", "--no_warmup", "--no_continuous_batching"])
    backend = create_backend(args)
    try:
        assert backend.continuous_scheduler is None
    finally:
        stop_backend(backend)
