"""Real-engine wire tests of the non-default serving configs on the port.

The cases of tests/test_server_real_engine_configs.py on the port's
client, server and TorchBackend, on the CPU in float32 with the narrow
Whisper of tests/test_torch_server_real_engine.py:

  * --continuous_spec with a self-draft: greedy output over the wire is
    token-exact against a from-scratch plain decode of the same audio, and
    the draft's proposals are accepted;
  * --beam_mode refresh (hybrid beam): the wire engages both the greedy
    partials and the beamed full re-decodes, and every full re-decode is
    token-exact against a direct beamed decode.
"""

import asyncio
import time

import jax
import numpy as np
import pytest

from tests.test_torch_server_e2e import ServerHarness
from tests.test_torch_server_real_engine import (
    DIMS,
    RecordingBackend,
    VisibleTokenizer,
    _speech_like,
    jax_params,
)
from whisperlive_tpu_torch.engine.continuous import ContinuousScheduler
from whisperlive_tpu_torch.engine.engine import WhisperEngine
from whisperlive_tpu_torch.engine.scheduler import BatchScheduler
from whisperlive_tpu_torch.engine.tokenizer import TokenSpec
from whisperlive_tpu_torch.models.bridge import from_jax_params
from whisperlive_tpu_torch.models.whisper import WhisperConfig
from whisperlive_tpu_torch.serving import backends as backends_mod
from whisperlive_tpu_torch.serving.backends import TorchBackend
from whisperlive_tpu_torch.serving.session import SessionOptions


def _tiny_engine():
    """A float32 CPU engine on the JAX init_params of the plain wire test."""
    return WhisperEngine(
        WhisperConfig(**DIMS), from_jax_params(jax.tree.map(np.asarray, jax_params())),
        batch_buckets=(1, 2), device="cpu",
        tokenizer=VisibleTokenizer(TokenSpec(DIMS["n_vocab"], multilingual=True)),
    )


@pytest.fixture(scope="module", params=["spec", "refresh"])
def config_stack(request):
    mode = request.param
    saved = (backends_mod._DISABLE_GATES, backends_mod.STREAMING_MAX_NEW_TOKENS)
    backends_mod._DISABLE_GATES = True
    backends_mod.STREAMING_MAX_NEW_TOKENS = 20

    engine = _tiny_engine()
    scheduler = BatchScheduler(engine, max_batch_size=2, batch_window_ms=10)
    scheduler.start()
    if mode == "spec":
        # self-draft (identical weights): acceptance ~1, so multi-token
        # verify-round commits actually exercise the acceptance holes
        draft = _tiny_engine()
        continuous = ContinuousScheduler(
            engine, draft_engine=draft, spec_k=2, n_slots=2,
            steps_per_chunk=2, prompt_pad=48, ring=64,
        )
        backend_kw = {}
    else:
        continuous = ContinuousScheduler(
            engine, n_slots=2, steps_per_chunk=4, prompt_pad=48, ring=64,
        )
        backend_kw = dict(beam_size=3, beam_mode="refresh")
    continuous.start()
    backend = RecordingBackend(
        scheduler, model_name="tiny", continuous_scheduler=continuous,
        **backend_kw,
    )
    # pre-compile so a mid-stream cold compile can't shunt windows onto
    # unintended paths (same reasoning as the plain real-engine test)
    warm = _speech_like(1.2, seed=99)
    asyncio.run(
        backend.transcribe(
            warm, SessionOptions(language="en", use_vad=False),
            language="en", uid="warmup", window_anchor_s=0.0,
        )
    )
    if mode == "refresh":
        # also the from-scratch (no-anchor) beamed window program
        asyncio.run(
            backend.transcribe(
                warm, SessionOptions(language="en", use_vad=False),
                language="en", uid="warmup2", window_anchor_s=None,
            )
        )
    backend.calls.clear()
    try:
        yield mode, backend
    finally:
        continuous.stop()
        scheduler.stop()
        backends_mod._DISABLE_GATES, backends_mod.STREAMING_MAX_NEW_TOKENS = saved


def _drive_session(backend, seconds=10.0, min_calls=4, seed=0, **client_kw):
    from whisperlive_tpu_torch.client import Client

    messages = []
    with ServerHarness(backend=backend, backend_name="torch") as h:
        client = Client(
            "127.0.0.1", h.port, lang="en", use_vad=False,
            log_transcription=False,
            transcription_callback=lambda text, segs: messages.append(segs),
            **client_kw,
        )
        deadline = time.time() + 15
        while not client.recording and time.time() < deadline:
            time.sleep(0.05)
        assert client.recording, "SERVER_READY never arrived"

        audio = _speech_like(seconds, seed=seed)
        deadline = time.time() + 120
        for off in range(0, len(audio), 4000):  # 250 ms chunks, realtime
            client.send_packet_to_server(audio[off:off + 4000].tobytes())
            time.sleep(0.25)
            if len(backend.calls) >= min_calls:
                break
        while len(backend.calls) < min_calls and time.time() < deadline:
            time.sleep(0.2)
        client.close_websocket()
    return messages


def _assert_wire_shape(messages):
    assert messages, "no segments messages received"
    for segs in messages:
        assert isinstance(segs, list) and segs
        for seg in segs:
            assert set(seg) >= {"start", "end", "text", "completed"}
            for key in ("start", "end"):
                assert isinstance(seg[key], str) and "." in seg[key]
                assert len(seg[key].split(".")[1]) == 3
            assert float(seg["end"]) >= float(seg["start"])


def test_wire_parity_per_config(config_stack):
    mode, backend = config_stack
    # refresh mode: pin the tail anchor (session no-speech gate always
    # fails, so nothing commits) — successive windows then ride the
    # greedy-partial prefix path while window 1 is the beamed full,
    # engaging BOTH sides of the hybrid split in one session
    client_kw = {} if mode == "spec" else dict(no_speech_thresh=0.0)
    messages = _drive_session(backend, seconds=10.0, min_calls=4, **client_kw)
    calls = list(backend.calls)
    assert len(calls) >= 3, f"only {len(calls)} windows decoded"
    assert any(c["result"] is not None for c in calls)
    if mode == "spec":
        _assert_wire_shape(messages)

    opts = SessionOptions(language="en", use_vad=False)
    if mode == "spec":
        # token parity vs a from-scratch PLAIN decode: build a plain pool
        # on the same engine and redo every recorded window
        plain_pool = ContinuousScheduler(
            backend.continuous_scheduler.engine, n_slots=2,
            steps_per_chunk=4, prompt_pad=48, ring=64,
        )
        plain_pool.start()
        plain = TorchBackend(
            backend.scheduler, model_name="tiny",
            continuous_scheduler=plain_pool,
        )
        try:
            checked = 0
            for i, call in enumerate(calls):
                live = call["result"]
                if live is None:
                    continue
                fresh = asyncio.run(plain.transcribe(
                    call["audio"], opts, language=call["language"],
                    previous_tokens=call["previous_tokens"],
                    uid=f"redo-{i}",
                    include_unfinished=call["include_unfinished"],
                    window_anchor_s=None,
                ))
                assert fresh is not None
                assert tuple(live.raw_tokens) == tuple(fresh.raw_tokens), (
                    f"window {i}: speculative wire tokens diverge from a "
                    f"plain from-scratch decode"
                )
                checked += 1
            assert checked >= 2
            # the self-draft must actually have accepted proposals —
            # otherwise this proved nothing about acceptance-hole harvest
            sched = backend.continuous_scheduler
            assert sched.spec_stats["windows"] >= 2
            assert sched.acceptance_rate() > 0.5, sched.spec_stats
        finally:
            plain_pool.stop()
    else:
        # hybrid beam: at least one greedy partial and one beamed full
        # were routed (the wire actually engaged the split)
        assert backend.hybrid_stats["greedy_partials"] >= 1
        assert backend.hybrid_stats["beamed_fulls"] >= 1
        # beamed fulls are token-exact vs a direct beamed from-scratch
        # decode; greedy partials extend a previously derived hypothesis
        fresh_hybrid = TorchBackend(
            backend.scheduler, model_name="tiny",
            continuous_scheduler=backend.continuous_scheduler,
            beam_size=3, beam_mode="refresh",
        )
        prev_tokens = None
        checked_full = 0
        for i, call in enumerate(calls):
            live = call["result"]
            if live is None:
                continue
            forced = (
                backend._trim_prefix(prev_tokens) if prev_tokens else ()
            )
            extends = forced and tuple(live.raw_tokens)[: len(forced)] == forced
            if not extends:
                # a full re-decode: must equal the beamed window decode
                fresh = asyncio.run(fresh_hybrid.transcribe(
                    call["audio"], opts, language=call["language"],
                    previous_tokens=call["previous_tokens"],
                    uid=f"redo-full-{i}",
                    include_unfinished=call["include_unfinished"],
                    window_anchor_s=None,
                ))
                assert fresh is not None
                assert tuple(live.raw_tokens) == tuple(fresh.raw_tokens), (
                    f"window {i}: beamed full re-decode diverges"
                )
                checked_full += 1
            if live.raw_tokens:
                prev_tokens = live.raw_tokens
        assert checked_full >= 1
