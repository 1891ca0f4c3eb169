"""Beam lanes and word timestamps on the port's continuous path, against the
JAX package's.

The continuous tests' narrow model (tests/test_torch_continuous.py DIMS),
the JAX parameters carried over with from_jax_params, on the CPU in float32
with float weights and cross-KV, or decoder_int8=True with cross_kv_bits=8
or 4. Stated tolerances: beamed tokens exact (against the JAX pool and the
port's own window beam); aligned words the same, each start and end within
one frame (0.02 s) of JAX's, and within 1e-3 s between the slot-resident
and the window alignment of one hypothesis.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests import test_torch_continuous as tc
from tests.test_torch_int4_routes import pool_engines
from whisperlive_tpu.engine import continuous as jcont
from whisperlive_tpu.engine.scheduler import BatchRequest as JRequest
from whisperlive_tpu.serving import backends as jbackends
from whisperlive_tpu_torch.engine import continuous as tcont
from whisperlive_tpu_torch.engine.scheduler import BatchRequest as TRequest
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.ops import mel as mel_ops
from whisperlive_tpu_torch.serving import backends as tbackends
from whisperlive_tpu_torch.serving.session import SessionOptions

torch.set_num_threads(2)

OPTS = dict(language="en", temperatures=(0.0,), log_prob_threshold=None,
            no_speech_threshold=None, compression_ratio_threshold=None)


def engines(mode):
    return pool_engines() if mode == "int4" else tc.make_engines(mode)


def visible_words(monkeypatch, *engs):
    """Every text token its own word " t<id>" (the tests' byte-level
    tokenizer has no piece for a random model's token ids), on both
    packages' engines alike."""
    for eng in engs:
        eot = eng.spec.eot

        def split(tokens, _eot=eot):
            text = [int(t) for t in tokens if t < _eot]
            return [f" t{t}" for t in text], [[t] for t in text]

        monkeypatch.setattr(eng.tokenizer, "split_to_word_tokens", split)


def window_beam(eng, audio, opts):
    """The window path's beam decode of one window: the reference."""
    buf = np.zeros((1, mel_ops.N_SAMPLES), np.float32)
    buf[0, : len(audio)] = audio
    _, cross = eng.prepare(buf)
    p, s = eng.build_prompt(opts, language="en")
    (ref,) = eng.decode_batch(cross, [p], [s], opts)
    return [int(t) for t in ref.tokens]


def serve(mod, eng, req_cls, opts, audios, **kw):
    sched = mod.ContinuousScheduler(eng, steps_per_chunk=4, prompt_pad=16, ring=64,
                                    cross_ctx=1500, **kw)
    sched.start()
    try:
        futs = [sched.submit(req_cls(audio=a, options=opts, uid=f"b{i}"))
                for i, a in enumerate(audios)]
        return [f.result(timeout=300) for f in futs]
    finally:
        sched.stop()


@pytest.mark.parametrize("mode", ["float", "int8", "int4"])
def test_continuous_beam_token_parity(mode):
    """Port of tests/test_continuous.py::test_continuous_beam_token_parity:
    a slot's K lanes at T = 0 reproduce the window path's beam search token
    for token, and the JAX pool's."""
    je, te = engines(mode)
    k = 3
    audio = tc.audio_of(3.0, 40)
    jopts = tc.JOptions(**OPTS, max_new_tokens=16, beam_size=k)
    topts = tc.TOptions(**OPTS, max_new_tokens=16, beam_size=k)
    (jr,) = serve(jcont, je, JRequest, jopts, [audio], n_slots=2, beam_width=k)
    (tr,) = serve(tcont, te, TRequest, topts, [audio], n_slots=2, beam_width=k)
    out = [int(t) for t in tr.raw_tokens]
    assert out == [int(t) for t in jr.raw_tokens]
    assert out == window_beam(te, audio, topts) and len(out) > 0


def test_continuous_beam_two_slots_and_reuse():
    """Port of tests/test_continuous.py::test_continuous_beam_two_slots_and_reuse:
    two beamed slots decode together and a released slot's lanes serve a
    third request cleanly."""
    je, te = tc.make_engines("int8")
    k = 2
    audios = [tc.audio_of(2.0, 41), tc.audio_of(3.0, 42), tc.audio_of(2.5, 43)]
    topts = tc.TOptions(**OPTS, max_new_tokens=12, beam_size=k)
    jres = serve(jcont, je, JRequest, tc.JOptions(**OPTS, max_new_tokens=12, beam_size=k),
                 audios, n_slots=2, beam_width=k)
    tres = serve(tcont, te, TRequest, topts, audios, n_slots=2, beam_width=k)
    for a, jr, tr in zip(audios, jres, tres):
        assert [int(t) for t in tr.raw_tokens] == [int(t) for t in jr.raw_tokens]
        assert [int(t) for t in tr.raw_tokens] == window_beam(te, a, topts)


def test_continuous_beam_sampling_retry_best_of():
    """Port of tests/test_continuous.py::test_continuous_beam_sampling_retry_best_of:
    a beamed request that fails the gates retries at T > 0, its K lanes
    sample independently and the harvest keeps the best-scoring lane."""
    _, te = tc.make_engines("float")
    k = 2
    opts = tc.TOptions(language="en", temperatures=(0.0, 0.8), log_prob_threshold=0.0,
                       no_speech_threshold=None, compression_ratio_threshold=None,
                       max_new_tokens=40, beam_size=k)
    sched = tcont.ContinuousScheduler(te, n_slots=1, steps_per_chunk=4, prompt_pad=16, ring=64,
                                      beam_width=k, cross_ctx=1500)
    winners = []
    step = sched.cb.step

    def recorded_step():
        status = step()
        st = sched.cb.state
        if status[0, 1] > 0.5 and float(st["temperature"][0]) > 0:
            score = st["sum_logprob"] / st["gen_len"].float().clamp(min=1.0)
            winners.append((int(status[0, 5]), int(torch.argmax(score)), status[0, 3],
                            float(st["sum_logprob"][int(status[0, 5])])))
        return status

    sched.cb.step = recorded_step
    sched.start()
    try:
        r = sched.submit(TRequest(audio=tc.audio_of(2.0, 44), options=opts, uid="bo")).result(
            timeout=300)
    finally:
        sched.stop()
    assert winners, "the T > 0 retry never finished"
    lane, best, status_sum, lane_sum = winners[-1]
    assert lane == best and status_sum == pytest.approx(lane_sum)
    for seg in r.segments:
        assert seg.temperature == pytest.approx(0.8)


def test_beam_pool_passes_no_active(monkeypatch):
    """Beam lanes gather across rows, so a beam pool runs the cross-attention
    without `active` (K4, not K5), as the JAX pool does. The case the gate
    is for: a lane finishes (EOT) while its slot still expands. With the
    write mask passed as `active`, that lane's row would read no cross-KV
    (K5 returns zeros): its logits and the self-KV it writes would depart
    from the JAX pool's. That is the fault the gate guards against. The
    tokens do not show it: a finished lane proposes only EOT, so its
    children are finished too and never read that state; the harvest is
    the same either way. Stated tolerance: the gated pool's logits within
    1e-4 of max|JAX| on every row."""
    je, te = tc.make_engines("int8")
    k = 3
    p, s = te.build_prompt(tc.TOptions(**OPTS), language="en")
    audio = np.stack([tc.audio_of(2.0, 45)])
    pool = dict(n_slots=2, prompt_pad=16, ring=32, steps_per_chunk=1, cross_ctx=640,
                beam_width=k)
    insert = ([p], [s], [True], [0], [0.0], [True], [1.0], [20])
    eot = te.spec.eot

    jcb = jcont.ContinuousEngine(je, **pool)
    jcb.init_state()
    jcb.insert(audio, *insert, enc_ctx=512)
    jcb.step()  # the first expansion: three lanes from lane 0
    jcb.state["logits"] = jcb.state["logits"].at[1, eot].set(50.0)  # lane 1's EOT now leads
    jcb.step()
    jcb.step()
    jstate = {n: np.asarray(jcb.state[n]) for n in ("logits", "finished", "sampled")}

    decode = tw.decode_step_masked

    def run(pass_active):
        cb = tcont.ContinuousEngine(te, **pool)
        cb.init_state()
        seen = []

        def spy(*args, **kw):
            seen.append(kw.get("active"))
            if pass_active:  # the missing gate: the stepping rows' write mask
                kw["active"] = cb.state["active"] & ~cb.state["finished"]
            return decode(*args, **kw)

        monkeypatch.setattr(tw, "decode_step_masked", spy)
        cb.insert(audio, *insert, enc_ctx=512)
        cb.step()
        cb.state["logits"][1, eot] = 50.0
        status = cb.step()
        finished = cb.state["finished"][:k].clone()
        assert finished.sum() == 1 and status[0, 1] == 0.0  # the slot still expands
        cb.step()
        return seen, finished, {n: cb.state[n].clone() for n in ("logits", "self_kv", "sampled")}

    seen, finished, gated = run(False)
    assert seen and all(a is None for a in seen)
    _, _, skipped = run(True)
    assert finished.tolist() == jstate["finished"][:k].tolist()
    done = int(torch.nonzero(finished)[0])
    live = [r for r in range(k) if r != done]
    ref = torch.tensor(jstate["logits"][:k])
    tol = 1e-4 * ref.abs().max().item()
    # gated: every lane's logits are the JAX pool's; the missing gate moves
    # the finished lane's far outside that tolerance, and its self-KV
    assert (gated["logits"][:k] - ref).abs().max().item() <= tol
    assert (skipped["logits"][done] - ref[done]).abs().max().item() > 100 * tol
    assert not torch.equal(gated["self_kv"][:, :, done], skipped["self_kv"][:, :, done])
    torch.testing.assert_close(gated["logits"][live], skipped["logits"][live], rtol=0, atol=0)
    # ... and no token
    assert torch.equal(gated["sampled"], skipped["sampled"])
    assert gated["sampled"][:k].tolist() == jstate["sampled"][:k].tolist()


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_word_timestamps_on_continuous_path(mode, monkeypatch):
    """Port of tests/test_continuous.py::test_word_timestamps_on_continuous_path:
    the alignment against a slot's resident cross-KV equals the window
    path's for the same tokens (cross cap at the full context), and a
    word-timestamp request through the scheduler gets the JAX package's
    words on the content-capped default pool."""
    je, te = tc.make_engines(mode)
    visible_words(monkeypatch, je, te)
    cb = tcont.ContinuousEngine(te, n_slots=2, prompt_pad=16, ring=64, steps_per_chunk=4,
                                cross_ctx=1500)
    cb.init_state()
    a = tc.audio_of(3.0, 46)
    buf = np.zeros((1, mel_ops.N_SAMPLES), np.float32)
    buf[0, : len(a)] = a
    opts = tc.TOptions(**OPTS, max_new_tokens=16)
    p, s = te.build_prompt(opts, language="en")
    cb.insert(buf, [p], [s], [True], [0], [0.0], [True], [1.0], [16])
    for _ in range(10):
        status = cb.step()
        if status[0, 1] > 0.5:
            break
    toks = [int(t) for t in cb.harvest(0, 0, int(status[0, 2])) if t != te.spec.eot]
    assert any(t < te.spec.eot for t in toks)
    w_cont = te.align_words(cb.state["cross_kv"], 0, toks, 300)
    _, cross = te.prepare(np.concatenate([buf, buf]))
    w_win = te.align_words(cross, 0, toks, 300)
    assert w_cont and [w.word for w in w_cont] == [w.word for w in w_win]
    for x, y in zip(w_cont, w_win):
        assert x.start == pytest.approx(y.start, abs=1e-3)
        assert x.end == pytest.approx(y.end, abs=1e-3)

    def scheduled(mod, eng, req_cls, opts_cls):
        wopts = opts_cls(**OPTS, max_new_tokens=16, word_timestamps=True)
        sched = mod.ContinuousScheduler(eng, n_slots=2, steps_per_chunk=4, prompt_pad=16,
                                        ring=64)
        sched.start()
        try:
            return sched.submit(req_cls(audio=a, options=wopts, uid="wt")).result(timeout=300)
        finally:
            sched.stop()

    ref = scheduled(jcont, je, JRequest, tc.JOptions)
    out = scheduled(tcont, te, TRequest, tc.TOptions)
    assert out.duration == pytest.approx(3.0) and out.segments
    assert [g.text for g in out.segments] == [g.text for g in ref.segments]
    assert any(g.words for g in out.segments)
    for gj, gt in zip(ref.segments, out.segments):
        assert gt.words is not None
        assert [w.word for w in gt.words] == [w.word for w in gj.words]
        for wj, wt in zip(gj.words, gt.words):
            assert abs(wj.start - wt.start) <= 0.02 and abs(wj.end - wt.end) <= 0.02


def test_backend_routes_word_timestamps_and_beams():
    """Port of tests/test_continuous.py::test_backend_routes_word_timestamps_to_continuous:
    word-timestamp requests ride the continuous pool, beamed requests only a
    pool with matching lanes; the JAX backend routes alike."""

    def pools(lanes):
        return SimpleNamespace(max_window_s=12.8, beam_width=lanes,
                               suppress_key=((-1,), True))

    for lanes in (1, 4):
        for backend_cls, opts_cls in ((tbackends.TorchBackend, tc.TOptions),
                                      (jbackends.TpuBackend, tc.JOptions)):
            cont = pools(lanes)
            backend = backend_cls(SimpleNamespace(), continuous_scheduler=cont)
            if lanes == 1:
                assert backend._pick_scheduler(opts_cls(word_timestamps=True), 5.0) is cont
            assert backend._pick_scheduler(opts_cls(beam_size=4), 5.0) is (
                cont if lanes == 4 else backend.scheduler)
            assert backend._pick_scheduler(opts_cls(beam_size=4), 13.0) is backend.scheduler


def test_window_scheduler_runs_beam_and_word_timestamps(monkeypatch):
    """The window scheduler: a beamed request takes the split path (the beam
    program, not the sampling loop of the fused one), a word-timestamp
    request is aligned at resolve, and beam widths form separate batch
    groups (ports of tests/test_scheduler.py:178 and :226); the JAX
    scheduler gives the same results."""
    from whisperlive_tpu.engine.scheduler import BatchScheduler as JWindow
    from whisperlive_tpu_torch.engine.scheduler import BatchScheduler as TWindow

    je, te = tc.make_engines("float")
    visible_words(monkeypatch, je, te)
    routes = []
    monkeypatch.setattr(te, "transcribe_batch",
                        lambda *a, _f=te.transcribe_batch, **kw: routes.append("fused")
                        or _f(*a, **kw))
    monkeypatch.setattr(te, "decode_with_fallback",
                        lambda *a, _f=te.decode_with_fallback, **kw: routes.append("split")
                        or _f(*a, **kw))
    audio = tc.audio_of(2.5, 47)
    kinds = [dict(beam_size=3), dict(word_timestamps=True), {}]
    out = {}
    for name, window, req_cls, opts_cls in (("j", JWindow(je), JRequest, tc.JOptions),
                                            ("t", TWindow(te), TRequest, tc.TOptions)):
        window.start()
        try:
            res = []
            for kw in kinds:
                req = req_cls(audio=audio, options=opts_cls(**OPTS, max_new_tokens=12, **kw))
                r = window.submit(req).result(timeout=300)
                res.append(([int(t) for t in r.raw_tokens],
                            [[(w.word, w.start, w.end) for w in g.words or []]
                             for g in r.segments]))
            out[name] = res
        finally:
            window.stop()
    assert routes == ["split", "split", "fused"]
    assert [r[0] for r in out["t"]] == [r[0] for r in out["j"]]
    assert out["t"][0][0] == window_beam(te, audio, tc.TOptions(**OPTS, max_new_tokens=12,
                                                                 beam_size=3))
    for gj, gt in zip(out["j"][1][1], out["t"][1][1]):
        assert [w[0] for w in gt] == [w[0] for w in gj]
        assert all(abs(a[1] - b[1]) <= 0.02 and abs(a[2] - b[2]) <= 0.02
                   for a, b in zip(gj, gt))
    assert any(out["t"][1][1])
    keys = [TRequest(audio=audio, options=tc.TOptions(**kw)).group_key()
            for kw in (dict(beam_size=1), dict(beam_size=5), dict(beam_size=5, patience=2.0),
                       dict(word_timestamps=True))]
    assert len(set(keys)) == 4
