"""The port's mixed speculative routing against the JAX package's.

Full re-decodes ride a second, speculative continuous pool; short
incremental tails stay on the plain pool; an acceptance-EMA hysteresis
turns the speculative route off below the breakeven and probes it again.
Narrow target and distil-shaped draft as in tests/test_torch_speculative.py
(CPU, float32, int8 decoder weights), at int8 and int4 cross-KV: the same
calls through the port's TorchBackend and the JAX TpuBackend take the same
routes and return the same tokens, which also equal the plain pool's.
"""

import asyncio
import contextlib
import functools

import numpy as np
import pytest
import torch

from tests.test_torch_speculative import engines
from whisperlive_tpu.engine import continuous as jcont
from whisperlive_tpu.engine import scheduler as jsched
from whisperlive_tpu.serving import backends as jbackends
from whisperlive_tpu.serving.session import SessionOptions as JSession
from whisperlive_tpu_torch.engine import continuous as tcont
from whisperlive_tpu_torch.engine import scheduler as tsched
from whisperlive_tpu_torch.serving import backends as tbackends
from whisperlive_tpu_torch.serving.session import SessionOptions as TSession

torch.set_num_threads(2)

_HYP = tuple(range(100, 120))


def speech(seconds, seed=0):
    t = np.arange(int(16000 * seconds)) / 16000.0
    rng = np.random.default_rng(seed)
    f0 = 140 + 40 * np.sin(2 * np.pi * 2.1 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
    sig = sig * (0.55 + 0.45 * np.sin(2 * np.pi * 3.7 * t)) + 0.02 * rng.standard_normal(t.shape)
    return (0.12 * sig / np.max(np.abs(sig))).astype(np.float32)


@contextlib.contextmanager
def stack(bits, port):
    """(backend, routes) of a window scheduler, a plain continuous pool and
    a speculative pool on one engine, every submit recorded."""
    (je, te), (jd, td) = engines(bits)
    eng, draft = (te, td) if port else (je, jd)
    sched_mod, cont, backends = (tsched, tcont, tbackends) if port else (jsched, jcont, jbackends)
    saved = backends._DISABLE_GATES, backends.STREAMING_MAX_NEW_TOKENS
    backends._DISABLE_GATES, backends.STREAMING_MAX_NEW_TOKENS = True, 12
    window = sched_mod.BatchScheduler(eng, max_batch_size=2, batch_window_ms=10)
    plain = cont.ContinuousScheduler(eng, n_slots=2, steps_per_chunk=4, prompt_pad=48, ring=64)
    spec = cont.ContinuousScheduler(eng, draft_engine=draft, spec_k=2, n_slots=2,
                                    steps_per_chunk=2, prompt_pad=48, ring=64)
    backend_cls = tbackends.TorchBackend if port else jbackends.TpuBackend
    backend = backend_cls(window, continuous_scheduler=plain, spec_scheduler=spec)
    routes = []
    for which, s in (("window", window), ("plain", plain), ("spec", spec)):
        submit = s.submit
        s.submit = lambda req, _s=submit, _w=which: routes.append(
            (_w, tuple(req.prefix_tokens))) or _s(req)
        s.start()
    try:
        yield backend, routes
    finally:
        for s in (spec, plain, window):
            s.stop()
        backends._DISABLE_GATES, backends.STREAMING_MAX_NEW_TOKENS = saved


def call(backend, audio, anchor, uid, port=True):
    opts = (TSession if port else JSession)(language="en", use_vad=False)
    return asyncio.run(backend.transcribe(audio, opts, language="en", uid=uid,
                                          window_anchor_s=anchor))


def _session(backend, routes, port):
    """A full re-decode, an incremental tail, a refresh-streak full, and the
    same full re-decode forced onto the plain pool."""
    out = []
    r = call(backend, speech(1.4, 5), 0.0, "f0", port)
    out.append((routes[-1], r.raw_tokens))
    backend._prefix_cache["t0"] = (0.0, _HYP)
    r = call(backend, speech(1.2, 1), 0.0, "t0", port)
    out.append((routes[-1], r.raw_tokens))
    backend.prefix_refresh = 1
    backend._prefix_cache["t1"] = (0.0, _HYP)
    backend._prefix_streak["t1"] = 1
    r = call(backend, speech(1.1, 2), 0.0, "t1", port)
    out.append((routes[-1], r.raw_tokens))
    backend._spec_enabled, backend.spec_probe_s = False, 1e9
    backend._spec_last_probe = __import__("time").monotonic()
    r = call(backend, speech(1.4, 5), 0.0, "p1", port)
    out.append((routes[-1], r.raw_tokens))
    return out, dict(backend.spec_route_stats)


@functools.lru_cache(maxsize=None)
def sessions(bits):
    with stack(bits, port=False) as (backend, routes):
        ref = _session(backend, routes, port=False)
    with stack(bits, port=True) as (backend, routes):
        out = _session(backend, routes, port=True)
    return ref, out


@pytest.mark.parametrize("bits", [8, 4])
def test_mixed_routing_matches_jax(bits):
    ref, out = sessions(bits)
    assert out == ref
    (full, tail, refresh, forced), stats = out
    assert full[0] == ("spec", ()) and refresh[0][0] == "spec"
    assert tail[0][0] == "plain" and len(tail[0][1]) > 0  # the trimmed prefix
    assert forced[0] == ("plain", ())
    assert full[1] == forced[1] and len(full[1]) > 0  # the spec pool's tokens are the plain pool's
    assert stats["spec_fulls"] == 2 and stats["plain_fulls"] == 1


def test_hysteresis_disables_below_breakeven_and_reenables():
    with stack(8, port=True) as (backend, _):
        sched = backend.spec_scheduler
        sched.acceptance_ema, sched._acc_ema_n = 0.05, backend.spec_warm_windows + 1
        backend.spec_probe_s = 1e9
        assert backend._spec_route() is False and backend._spec_enabled is False
        d0 = backend.spec_route_stats["disables"]
        assert backend._spec_route() is False  # no probe due yet
        assert backend.spec_route_stats["disables"] == d0
        backend.spec_probe_s = 0.0  # probe interval elapsed: one window goes through
        assert backend._spec_route() is True and backend.spec_route_stats["probes"] == 1
        backend.spec_probe_s = 1e9
        sched.acceptance_ema = 0.6  # above the upper band: on again
        assert backend._spec_route() is True and backend._spec_enabled is True
        assert backend.spec_route_stats["reenables"] == 1
        sched.acceptance_ema = 0.3  # inside the band: the state holds
        assert backend._spec_route() is True and backend._spec_enabled is True


def test_random_draft_organically_trips_the_breaker():
    with stack(8, port=True) as (backend, routes):
        backend.spec_probe_s = 1e9
        backend.spec_warm_windows = 3
        for i in range(5):
            call(backend, speech(1.0, 10 + i), 0.0, f"h{i}")
            backend.release(f"h{i}")
        assert backend.spec_scheduler._acc_ema_n >= 3
        assert not backend._spec_enabled
        assert routes[-1][0] == "plain"


def test_spec_thresholds_read_from_env(monkeypatch):
    monkeypatch.setenv("WL_SPEC_BREAKEVEN", "0.4")
    monkeypatch.setenv("WL_SPEC_PROBE_S", "5")
    monkeypatch.setenv("WL_SPEC_WARM_WINDOWS", "3")
    (_, te), (_, td) = engines(8)
    plain = tcont.ContinuousScheduler(te, n_slots=2, prompt_pad=16, ring=32)
    spec = tcont.ContinuousScheduler(te, draft_engine=td, n_slots=2, prompt_pad=16, ring=32)
    window = tsched.BatchScheduler(te)
    backend = tbackends.TorchBackend(window, continuous_scheduler=plain, spec_scheduler=spec)
    assert backend.spec_breakeven == 0.4 and backend.spec_reenable == 0.35
    assert backend.spec_probe_s == 5.0 and backend.spec_warm_windows == 3
    monkeypatch.setenv("WL_SPEC_BREAKEVEN", "0.1")  # read once, at construction
    assert backend.spec_breakeven == 0.4


def test_cli_builds_the_speculative_routes():
    from whisperlive_tpu_torch.cli.run_server import build_parser, create_backend, stop_backend
    from whisperlive_tpu_torch.engine.speculative import SpeculativeDecoder

    base = ["--model", "tiny", "--device", "cpu", "--no_warmup", "--continuous_slots", "2",
            "--draft_model", "tiny"]
    args = build_parser().parse_args(base + ["--continuous_spec", "--continuous_spec_mode",
                                             "mixed", "--spec_slots", "2"])
    assert args.spec_k == 4 and args.spec_slots == 2
    backend = create_backend(args)
    try:
        assert isinstance(backend.scheduler.spec_decoder, SpeculativeDecoder)
        assert backend.continuous_scheduler.cb.spec_k == 0
        pool = backend.spec_scheduler.cb
        assert pool.spec_k == 4 and pool.ring == 192 and pool.steps_per_chunk == 4
        assert pool.n_slots == 2 and pool.draft is backend.scheduler.spec_decoder.draft
    finally:
        stop_backend(backend)
    backend = create_backend(build_parser().parse_args(base + ["--continuous_spec"]))
    try:
        assert backend.continuous_scheduler.cb.spec_k == 4 and backend.spec_scheduler is None
    finally:
        stop_backend(backend)
    # --draft_path loads the draft's checkpoint dir: a missing one fails at startup
    with pytest.raises(FileNotFoundError, match="/nonexistent"):
        create_backend(build_parser().parse_args(base + ["--draft_path", "/nonexistent"]))
