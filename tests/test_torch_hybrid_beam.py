"""Hybrid beam serving (beam_mode="refresh") on the port against the JAX
package: greedy incremental partials on the continuous pool, beamed full
re-decodes on the window scheduler in preemptible segments, the beamed
hypothesis re-seeding the prefix cache that the partials extend.

Ports of tests/test_hybrid_beam.py and of
tests/test_spec_mixed.py::test_spec_scheduler_conflicts_with_hybrid_beam on
the continuous tests' narrow model (float32, float weights and cross-KV, on
the CPU): the same calls through TorchBackend and TpuBackend take the same
routes, with the same beam width and forced prefix, and return the same
tokens.
"""

import asyncio
import contextlib

import numpy as np
import pytest
import torch

from tests import test_torch_continuous as tc
from tests.test_torch_spec_mixed import speech
from whisperlive_tpu.engine import continuous as jcont
from whisperlive_tpu.engine import scheduler as jsched
from whisperlive_tpu.serving import backends as jbackends
from whisperlive_tpu.serving.session import SessionOptions as JSession
from whisperlive_tpu_torch.engine import continuous as tcont
from whisperlive_tpu_torch.engine import scheduler as tsched
from whisperlive_tpu_torch.serving import backends as tbackends
from whisperlive_tpu_torch.serving.session import SessionOptions as TSession

torch.set_num_threads(2)

# a carried hypothesis long enough that _trim_prefix (drop the last 4, keep
# >= 8) leaves a prefix
_HYP = tuple(range(100, 120))


@contextlib.contextmanager
def stack(port, monkeypatch):
    """(backend, routes): a window scheduler and a greedy continuous pool on
    one engine behind a beam-3 refresh-mode backend, every submit recorded
    as (route, beam_size, forced prefix)."""
    je, te = tc.make_engines("float")
    eng = te if port else je
    sched_mod, cont, backends = (tsched, tcont, tbackends) if port else (jsched, jcont, jbackends)
    monkeypatch.setattr(backends, "_DISABLE_GATES", True)
    monkeypatch.setattr(backends, "STREAMING_MAX_NEW_TOKENS", 12)
    monkeypatch.delenv("WL_BEAM_CHUNK", raising=False)
    monkeypatch.setattr(eng, "beam_chunk", 0)
    window = sched_mod.BatchScheduler(eng, max_batch_size=2, batch_window_ms=10)
    pool = cont.ContinuousScheduler(eng, n_slots=2, steps_per_chunk=4, prompt_pad=48, ring=64)
    backend_cls = tbackends.TorchBackend if port else jbackends.TpuBackend
    backend = backend_cls(window, continuous_scheduler=pool, beam_size=3, beam_mode="refresh")
    routes = []
    for which, s in (("window", window), ("continuous", pool)):
        submit = s.submit
        s.submit = lambda req, _s=submit, _w=which: routes.append(
            (_w, req.options.beam_size, tuple(req.prefix_tokens))) or _s(req)
        s.start()
    try:
        yield backend, routes
    finally:
        pool.stop()
        window.stop()


def call(backend, audio, anchor, uid, port):
    opts = (TSession if port else JSession)(language="en", use_vad=False)
    return asyncio.run(backend.transcribe(audio, opts, language="en", uid=uid,
                                          window_anchor_s=anchor))


def both(monkeypatch, scenario):
    """scenario(backend, routes, port) -> comparable record, on each stack."""
    out = []
    for port in (False, True):
        with stack(port, monkeypatch) as (backend, routes):
            out.append(scenario(backend, routes, port))
    return out


def test_first_window_full_decode_is_beamed_and_seeds_prefix(monkeypatch):
    def scenario(backend, routes, port):
        assert backend.hybrid_beam
        # the hybrid route runs beamed decodes in preemptible segments
        assert backend.scheduler.engine.beam_chunk == 24
        backend.scheduler.engine.beam_chunk = 5
        result = call(backend, speech(1.0), 0.0, "seed", port)
        assert routes[-1][:2] == ("window", 3)
        assert result is not None and result.raw_tokens
        assert backend._prefix_cache["seed"] == (0.0, result.raw_tokens)
        return routes, result.raw_tokens

    ref, out = both(monkeypatch, scenario)
    assert out == ref


def test_partials_greedy_on_continuous_with_beamed_prefix(monkeypatch):
    def scenario(backend, routes, port):
        backend._prefix_cache["u0"] = (0.0, _HYP)
        backend._prefix_streak["u0"] = 0
        result = call(backend, speech(1.2, seed=1), 0.0, "u0", port)
        assert routes[-1] == ("continuous", 1, backend._trim_prefix(_HYP))
        return routes, result.raw_tokens

    ref, out = both(monkeypatch, scenario)
    assert out == ref


def test_refresh_streak_routes_full_beamed_decode(monkeypatch):
    def scenario(backend, routes, port):
        backend.prefix_refresh = 2
        seen, toks = [], []
        for _ in range(3):
            backend._prefix_cache["u1"] = (0.0, _HYP)
            toks.append(call(backend, speech(1.1, seed=2), 0.0, "u1", port).raw_tokens)
            seen.append(routes[-1][:2])
        assert seen == [("continuous", 1), ("continuous", 1), ("window", 3)]
        assert backend._prefix_streak["u1"] == 0
        assert backend.hybrid_stats == {"greedy_partials": 2, "beamed_fulls": 1}
        backend.release("u1")
        return routes, toks

    ref, out = both(monkeypatch, scenario)
    assert out == ref


def test_anchor_move_evicts_and_beams_from_scratch(monkeypatch):
    def scenario(backend, routes, port):
        backend._prefix_cache["u2"] = (0.0, _HYP)
        backend._prefix_streak["u2"] = 1
        result = call(backend, speech(1.0, seed=3), 2.5, "u2", port)
        # a commit moved the anchor: the from-scratch decode carries the beam
        assert routes[-1] == ("window", 3, ())
        assert backend._prefix_streak.get("u2", 0) == 0
        backend.release("u2")
        return routes, result.raw_tokens

    ref, out = both(monkeypatch, scenario)
    assert out == ref


def test_full_mode_unchanged(monkeypatch):
    """beam_mode="full" (the default) with a greedy pool: every request's
    beam width mismatches the pool, so every request goes to the window
    scheduler, beamed."""

    def scenario(backend, routes, port):
        backend_cls = tbackends.TorchBackend if port else jbackends.TpuBackend
        full = backend_cls(backend.scheduler, continuous_scheduler=backend.continuous_scheduler,
                           beam_size=3)
        assert not full.hybrid_beam
        full._prefix_cache["u3"] = (0.0, _HYP)
        result = call(full, speech(1.0, seed=4), 0.0, "u3", port)
        assert routes[-1][:2] == ("window", 3)
        return routes, result.raw_tokens

    ref, out = both(monkeypatch, scenario)
    assert out == ref


def test_spec_scheduler_conflicts_with_hybrid_beam(monkeypatch):
    """Port of tests/test_spec_mixed.py::test_spec_scheduler_conflicts_with_hybrid_beam:
    mixed speculative routing and hybrid beam both re-route the full
    re-decodes, so the backend takes one or the other."""
    with stack(True, monkeypatch) as (backend, _):
        spec_pool = tcont.ContinuousScheduler(backend.scheduler.engine, n_slots=2)
        with pytest.raises(ValueError, match="one or the other"):
            tbackends.TorchBackend(backend.scheduler,
                                   continuous_scheduler=backend.continuous_scheduler,
                                   spec_scheduler=spec_pool, beam_size=3, beam_mode="refresh")
        # greedy or full-mode beam serving keeps the speculative pool
        for kw in ({}, dict(beam_size=3)):
            ok = tbackends.TorchBackend(backend.scheduler,
                                        continuous_scheduler=backend.continuous_scheduler,
                                        spec_scheduler=spec_pool, **kw)
            assert ok.spec_scheduler is spec_pool and not ok.hybrid_beam
