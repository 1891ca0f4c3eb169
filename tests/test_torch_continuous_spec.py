"""The port's speculative continuous batching against the JAX package's.

Narrow target (80 mels, vocab 51865, 1500 encoder positions, width 64, 4
heads, 2 + 2 layers, int8 decoder weights) and a distil-shaped draft (1
decoder layer, other random weights), from the JAX init_params carried over
with from_jax_params, on the CPU in float32 with int8 and int4 cross-KV.
Every comparison is token-exact: the port's speculative slot pool against
the JAX package's over the same history (a window at the reduced 512-
position context, a second joining mid-flight at the full context, a
released slot reused by a third), and against the port's plain pool over
the same history, with the random draft and with the target as its own
draft; a forced-prefix continuation against the plain pool's; and the
scheduler end to end against the JAX scheduler.
"""

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_speculative import GREEDY, engines
from whisperlive_tpu.engine import continuous as jcont
from whisperlive_tpu.engine.engine import TranscribeOptions as JOptions
from whisperlive_tpu.engine.scheduler import BatchRequest as JRequest
from whisperlive_tpu_torch.engine import continuous as tcont
from whisperlive_tpu_torch.engine.engine import TranscribeOptions as TOptions
from whisperlive_tpu_torch.engine.scheduler import BatchRequest as TRequest

torch.set_num_threads(2)

RING = 128  # rounded up to 130 = 26 rounds of k+2 = 5: the budget of 20 fits


def audio_of(seconds, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)


def _strip(eng, toks):
    return [int(t) for t in toks if t != eng.spec.eot]


def _history(mod, eng, draft, opts_cls):
    """One slot-pool history; returns each window's hypothesis from the
    harvest and from the status row, and the pool."""
    kw = {} if draft is None else dict(draft_engine=draft, spec_k=3)
    cb = mod.ContinuousEngine(eng, n_slots=2, prompt_pad=16, ring=RING, steps_per_chunk=2,
                              cross_ctx=640, **kw)
    cb.init_state()
    per_chunk = getattr(cb, "gstep_per_chunk", cb.steps_per_chunk)
    p, s = eng.build_prompt(opts_cls(**GREEDY), language="en")
    out, joins, gstep = {}, {}, 0

    def insert(name, slot, seconds, seed, enc_ctx):
        joins[name] = (slot, gstep)
        cb.insert(np.stack([audio_of(seconds, seed)]), [p], [s], [True], [slot], [0.0], [True],
                  [1.0], [20], enc_ctx=enc_ctx)

    def run_until(names):
        nonlocal gstep
        for _ in range(200):
            status = cb.step()
            gstep += per_chunk
            for name in names:
                slot, join = joins[name]
                if name not in out and status[slot, 1] > 0.5:
                    gen = int(status[slot, 2])
                    out[name] = _strip(eng, cb.harvest(slot, join, gen))
                    out[name + "_status"] = _strip(eng, cb.unroll_row(status[slot], join, gen))
                    out[name + "_gen"] = gen
            if all(n in out for n in names):
                return
        raise AssertionError(f"{names} never finished")

    insert("a", 0, 3.0, 1, 512)
    cb.step()
    gstep += per_chunk
    insert("b", 1, 2.0, 2, 1500)
    run_until(["a", "b"])
    cb.release([0])
    insert("c", 0, 4.0, 3, 512)
    run_until(["c"])
    return out, cb


@functools.lru_cache(maxsize=None)
def histories(bits, draft_kind):
    (je, te), (jd, td) = engines(bits)
    if draft_kind == "self":
        jd, td = je, te
    ref, _ = _history(jcont, je, jd, JOptions)
    out, cb = _history(tcont, te, td, TOptions)
    plain, _ = _history(tcont, te, None, TOptions)
    return ref, out, plain, cb


@pytest.mark.parametrize("draft_kind", ["distil", "self"])
@pytest.mark.parametrize("bits", [8, 4])
def test_spec_pool_token_exact_vs_jax_and_plain(bits, draft_kind):
    ref, out, plain, cb = histories(bits, draft_kind)
    assert cb.ring == 130 and cb.status_width == 6 + 2 * 130 and cb.gstep_per_chunk == 10
    for w in ("a", "b", "c"):
        assert out[w] == ref[w] == plain[w], w
        assert out[w + "_status"] == out[w]
        assert out[w + "_gen"] == plain[w + "_gen"]  # one committed ring column per token
        assert len(out[w]) > 4
    # the state stays finite, also on the rows of free and finished slots
    assert torch.isfinite(cb.state["self_kv"]).all() and torch.isfinite(cb.state["d_self_kv"]).all()


def test_spec_prefix_continuation_matches_plain():
    """A forced prefix (incremental partial decoding) continues token-exactly
    through verify rounds."""
    (_, te), (_, td) = engines(8)
    opts = TOptions(**GREEDY)
    p, s = te.build_prompt(opts, language="en")
    a = audio_of(3.0, 1)
    ts_begin = te.spec.timestamp_begin
    tails = {}
    for draft in (None, td):
        kw = {} if draft is None else dict(draft_engine=draft, spec_k=3)
        cb = tcont.ContinuousEngine(te, n_slots=1, prompt_pad=32, ring=RING, steps_per_chunk=2,
                                    cross_ctx=1500, **kw)
        cb.init_state()
        cb.insert(np.stack([a]), [p], [s], [True], [0], [0.0], [True], [1.0], [20])
        for _ in range(100):
            status = cb.step()
            if status[0, 1] > 0.5:
                break
        full = _strip(te, cb.harvest(0, 0, int(status[0, 2])))
        prefix = full[:4]
        cb.init_state()
        cb.insert(np.stack([a]), [p + prefix], [s], [True], [0], [0.0], [True], [1.0], [16],
                  last_ts=[next((t for t in reversed(prefix) if t >= ts_begin), ts_begin - 1)],
                  has_prefix=[True], pfx_last_ts=[prefix[-1] >= ts_begin],
                  pfx_penult_ts=[prefix[-2] >= ts_begin])
        for _ in range(100):
            status = cb.step()
            if status[0, 1] > 0.5:
                break
        tails[draft is None] = (full, _strip(te, cb.harvest(0, 0, int(status[0, 2]))))
    assert tails[True] == tails[False]
    full, tail = tails[False]
    assert tail == full[4:4 + len(tail)] and len(tail) > 0


def _scheduler_run(mod, eng, draft, opts_cls, req_cls):
    sched = mod.ContinuousScheduler(eng, n_slots=2, steps_per_chunk=2, prompt_pad=16, ring=RING,
                                    draft_engine=draft, spec_k=3)
    sched.start()
    try:
        futs = [sched.submit(req_cls(audio=audio_of(2.0 + 0.5 * i, 10 + i),
                                     options=opts_cls(**dict(GREEDY, max_new_tokens=12)),
                                     uid=f"u{i}"))
                for i in range(3)]
        res = [f.result(timeout=300) for f in futs]
        return [(r.raw_tokens, [(g.start, g.end, g.text) for g in r.segments]) for r in res], sched
    finally:
        sched.stop()


def test_spec_scheduler_and_acceptance_stats_match_jax():
    (je, te), (jd, td) = engines(8)
    ref, jsched = _scheduler_run(jcont, je, jd, JOptions, JRequest)
    out, tsched = _scheduler_run(tcont, te, td, TOptions, TRequest)
    assert out == ref
    assert tsched.spec_stats == jsched.spec_stats and tsched.spec_stats["windows"] == 3
    assert tsched.acceptance_rate() == pytest.approx(jsched.acceptance_rate())
    assert tsched.acceptance_ema == pytest.approx(jsched.acceptance_ema)
    assert tsched._acc_ema_n == 3 and tsched.acceptance_rate() < 0.3
    plain = tcont.ContinuousScheduler(te, n_slots=1, steps_per_chunk=2, prompt_pad=16, ring=64)
    assert plain.acceptance_rate() == 0.0


def test_spec_pool_refuses_bad_geometry():
    (_, te), _ = engines(8)
    with pytest.raises(ValueError, match="spec_k"):
        tcont.ContinuousEngine(te, n_slots=2, draft_engine=te, spec_k=8)
    with pytest.raises(ValueError, match="beam_width=1"):  # as the JAX pool refuses it
        tcont.ContinuousEngine(te, n_slots=2, beam_width=2, draft_engine=te)
