"""Real-engine end-to-end wire tests on the port.

The cases of tests/test_server_real_engine.py (wire-level token parity,
the incremental-prefix path over the wire, the final wire text) on the
port: the port's client -> real websockets -> the port's server ->
TorchBackend -> ContinuousScheduler -> WhisperEngine on the CPU in
float32, a narrow Whisper whose parameters come from the JAX init_params.
Every window the wire-driven session decoded must reproduce a
from-scratch decode of the same audio token for token; then the same
windows through the JAX package's TpuBackend on the same parameters give
the same tokens.
"""

import asyncio
import functools
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.test_torch_server_e2e import ServerHarness
from whisperlive_tpu.engine import tokenizer as jtok
from whisperlive_tpu.engine.continuous import ContinuousScheduler as JContinuous
from whisperlive_tpu.engine.engine import WhisperEngine as JEngine
from whisperlive_tpu.engine.scheduler import BatchScheduler as JWindow
from whisperlive_tpu.models import whisper as jw
from whisperlive_tpu.serving import backends as jbackends
from whisperlive_tpu_torch.engine.continuous import ContinuousScheduler
from whisperlive_tpu_torch.engine.engine import WhisperEngine as TEngine
from whisperlive_tpu_torch.engine.scheduler import BatchScheduler
from whisperlive_tpu_torch.engine.tokenizer import TokenSpec, WhisperTokenizer
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.models.bridge import from_jax_params
from whisperlive_tpu_torch.serving import backends as backends_mod
from whisperlive_tpu_torch.serving.backends import TorchBackend

DIMS = dict(
    n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
    n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)


@functools.lru_cache(maxsize=None)
def jax_params():
    """The JAX init_params both packages' engines run on."""
    return jw.init_params(jw.WhisperConfig(**DIMS), 0)


class VisibleTokenizer(WhisperTokenizer):
    """Decode every text token to a visible, deterministic word.

    Zero egress means no real BPE vocab: the hermetic tokenizer decodes
    ids ≥ ~1000 to '' — with random weights every segment's text would be
    empty and the session layer would (correctly) send nothing. Making
    text tokens visible lets the full wire path (segments → commits →
    client callbacks) run; the parity assertions stay at the token level,
    which the tokenizer does not influence."""

    def decode(self, tokens):
        return "".join(
            f" t{int(t)}" for t in tokens if int(t) < self.spec.eot
        )


class RecordingBackend(TorchBackend):
    """TorchBackend that records, per call, the audio that was ACTUALLY
    decoded (late-bound refresh included) and the result — so the test can
    re-decode each window from scratch afterwards."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calls = []
        self._lock = threading.Lock()

    async def transcribe(self, chunk, options, *, refresh_audio=None, **kw):
        rebound = []
        wrapped = None
        if refresh_audio is not None:
            def wrapped():
                fresh = refresh_audio()
                if fresh is not None:
                    rebound.append(np.asarray(fresh).copy())
                return fresh

        result = await super().transcribe(
            chunk, options, refresh_audio=wrapped, **kw
        )
        with self._lock:
            self.calls.append(
                dict(
                    audio=(rebound[-1] if rebound else np.asarray(chunk).copy()),
                    language=kw.get("language"),
                    previous_tokens=tuple(kw.get("previous_tokens", ())),
                    include_unfinished=kw.get("include_unfinished", True),
                    anchor=kw.get("window_anchor_s"),
                    result=result,
                )
            )
        return result


@pytest.fixture(scope="module")
def real_stack():
    # trained-weights gate behavior: random-weight decodes would cascade
    # through all 6 fallback temperatures (nondeterministic via seeds) —
    # T=0 greedy only keeps every window decode deterministic
    saved = (backends_mod._DISABLE_GATES, backends_mod.STREAMING_MAX_NEW_TOKENS)
    backends_mod._DISABLE_GATES = True
    backends_mod.STREAMING_MAX_NEW_TOKENS = 20

    engine = TEngine(
        tw.WhisperConfig(**DIMS), from_jax_params(jax.tree.map(np.asarray, jax_params())),
        batch_buckets=(1, 2), device="cpu",
        tokenizer=VisibleTokenizer(TokenSpec(DIMS["n_vocab"], multilingual=True)),
    )
    scheduler = BatchScheduler(engine, max_batch_size=2, batch_window_ms=10)
    scheduler.start()
    # prompt_pad 48: room for sot (3) + a carried ~16-token incremental
    # prefix, so the prefix fast path actually engages (overflow would
    # silently fall back to from-scratch and the test would prove less)
    continuous = ContinuousScheduler(
        engine, n_slots=2, steps_per_chunk=4, prompt_pad=48, ring=64,
    )
    continuous.start()
    backend = RecordingBackend(
        scheduler, model_name="tiny", continuous_scheduler=continuous,
    )
    from whisperlive_tpu_torch.serving.session import SessionOptions

    warm = _speech_like(1.2, seed=99)
    asyncio.run(
        backend.transcribe(
            warm, SessionOptions(language="en", use_vad=False),
            language="en", uid="warmup", window_anchor_s=0.0,
        )
    )
    backend.calls.clear()
    try:
        yield backend
    finally:
        continuous.stop()
        scheduler.stop()
        backends_mod._DISABLE_GATES, backends_mod.STREAMING_MAX_NEW_TOKENS = saved


def _speech_like(seconds, seed=0):
    """Harmonic + syllabic-AM signal (plain tones get VAD-gated; noise is
    fine here since use_vad=False, but keep it speech-shaped anyway)."""
    t = np.arange(int(16000 * seconds)) / 16000.0
    rng = np.random.default_rng(seed)
    f0 = 140 + 40 * np.sin(2 * np.pi * 2.1 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
    am = 0.55 + 0.45 * np.sin(2 * np.pi * 3.7 * t)
    sig = sig * am + 0.02 * rng.standard_normal(t.shape)
    return (0.12 * sig / np.max(np.abs(sig))).astype(np.float32)


def test_real_engine_wire_token_parity(real_stack):
    backend = real_stack
    from whisperlive_tpu_torch.client import Client

    messages = []
    with ServerHarness(backend=backend, backend_name="torch") as h:
        client = Client(
            "127.0.0.1", h.port, lang="en", use_vad=False,
            log_transcription=False,
            transcription_callback=lambda text, segs: messages.append(segs),
        )
        deadline = time.time() + 15
        while not client.recording and time.time() < deadline:
            time.sleep(0.05)
        assert client.recording, "SERVER_READY never arrived"

        # keep audio flowing at real-time pace while windows decode: the
        # session commits advance the tail anchor, and a drained buffer
        # (<1 s tail) would idle the decode loop after a couple of windows;
        # faster-than-realtime streaming would outgrow the continuous
        # content cap and shunt windows onto the window scheduler instead
        audio = _speech_like(12.0)
        deadline = time.time() + 120
        for off in range(0, len(audio), 4000):  # 250 ms chunks, realtime
            client.send_packet_to_server(audio[off:off + 4000].tobytes())
            time.sleep(0.25)
            if len(backend.calls) >= 5:
                break
        while len(backend.calls) < 5 and time.time() < deadline:
            time.sleep(0.2)
        client.close_websocket()

    calls = list(backend.calls)
    assert len(calls) >= 4, f"only {len(calls)} windows decoded"
    assert any(c["result"] is not None for c in calls)

    # -- protocol shape: every wire segment is byte-compatible ----------
    assert messages, "no segments messages received"
    for segs in messages:
        assert isinstance(segs, list) and segs
        for seg in segs:
            assert set(seg) >= {"start", "end", "text", "completed"}
            # ms-precision string timestamps ("%.3f", session.py:41-60)
            for key in ("start", "end"):
                assert isinstance(seg[key], str) and "." in seg[key]
                assert len(seg[key].split(".")[1]) == 3
            assert float(seg["end"]) >= float(seg["start"])

    # -- token parity: re-decode every recorded window from scratch -----
    # A fresh plain backend on the same schedulers; window_anchor_s=None
    # means no prefix cache — each redo is a from-scratch decode.
    plain = TorchBackend(
        backend.scheduler, model_name="tiny",
        continuous_scheduler=backend.continuous_scheduler,
    )
    from whisperlive_tpu_torch.serving.session import SessionOptions

    opts = SessionOptions(language="en", use_vad=False)

    async def redo(i, call):
        return await plain.transcribe(
            call["audio"], opts,
            language=call["language"],
            previous_tokens=call["previous_tokens"],
            uid=f"redo-{i}",
            include_unfinished=call["include_unfinished"],
            window_anchor_s=None,
        )

    for i, call in enumerate(calls):
        live = call["result"]
        if live is None:
            continue
        fresh = asyncio.run(redo(i, call))
        assert fresh is not None
        assert tuple(live.raw_tokens) == tuple(fresh.raw_tokens), (
            f"window {i}: wire-path tokens diverge from a from-scratch "
            f"decode of the same audio"
        )
        live_segs = [(s.start, s.end, s.text) for s in live.segments]
        fresh_segs = [(s.start, s.end, s.text) for s in fresh.segments]
        assert live_segs == fresh_segs, f"window {i}: segment split diverges"
        assert live.duration == pytest.approx(fresh.duration)


def test_real_engine_prefix_path_parity(real_stack):
    """The incremental-prefix fast path, driven over the wire.

    no_speech_thresh=0.0 fails the no-speech gate on every window (random
    weights give tiny but nonzero no_speech_prob), so nothing commits and
    the tail anchor stays pinned — successive windows re-transcribe the
    same growing tail and the backend forces the previous hypothesis as a
    decode prefix. Every such window must still be token-exact vs a
    from-scratch decode of the same audio."""
    backend = real_stack
    n_before = len(backend.calls)
    from whisperlive_tpu_torch.client import Client

    with ServerHarness(backend=backend, backend_name="torch") as h:
        client = Client(
            "127.0.0.1", h.port, lang="en", use_vad=False,
            no_speech_thresh=0.0,  # gate always fails: anchor never moves
            log_transcription=False,
        )
        deadline = time.time() + 15
        while not client.recording and time.time() < deadline:
            time.sleep(0.05)
        assert client.recording

        audio = _speech_like(6.0, seed=3)
        deadline = time.time() + 120
        for off in range(0, len(audio), 4000):
            client.send_packet_to_server(audio[off:off + 4000].tobytes())
            time.sleep(0.25)
            if len(backend.calls) - n_before >= 4:
                break
        while len(backend.calls) - n_before < 4 and time.time() < deadline:
            time.sleep(0.2)
        client.close_websocket()

    calls = backend.calls[n_before:]
    assert len(calls) >= 3, f"only {len(calls)} windows decoded"
    # the anchor stayed pinned, so windows 2+ rode the prefix fast path
    anchors = [c["anchor"] for c in calls]
    assert len(set(anchors)) == 1, f"anchor moved: {anchors}"
    assert calls[0]["result"] is not None and calls[0]["result"].raw_tokens

    # Prefix windows decode GROWN audio with the previous hypothesis
    # forced, so from-scratch equality is not the contract (the old
    # hypothesis was decoded from less audio); the contract is:
    #  (a) continuation — the live tokens extend the forced prefix, and
    #  (b) determinism — re-decoding the same audio with the same forced
    #      prefix through a fresh backend reproduces the tokens exactly.
    from whisperlive_tpu_torch.serving.session import SessionOptions

    plain = TorchBackend(
        backend.scheduler, model_name="tiny",
        continuous_scheduler=backend.continuous_scheduler,
    )
    opts = SessionOptions(language="en", use_vad=False)
    anchor = anchors[0]
    checked = 0
    for i in range(1, len(calls)):
        live = calls[i]["result"]
        prev = calls[i - 1]["result"]
        if live is None or prev is None or not prev.raw_tokens:
            continue
        forced = plain._trim_prefix(prev.raw_tokens)
        if not forced:
            continue
        assert tuple(live.raw_tokens)[: len(forced)] == forced, (
            f"window {i}: live tokens do not extend the forced prefix"
        )
        uid = f"prefix-redo-{i}"
        plain._prefix_cache[uid] = (anchor, prev.raw_tokens)
        fresh = asyncio.run(
            plain.transcribe(
                calls[i]["audio"], opts, language=calls[i]["language"],
                previous_tokens=calls[i]["previous_tokens"],
                uid=uid,
                include_unfinished=calls[i]["include_unfinished"],
                window_anchor_s=anchor,
            )
        )
        assert tuple(live.raw_tokens) == tuple(fresh.raw_tokens), (
            f"prefix window {i} is not deterministic"
        )
        checked += 1
    assert checked >= 1, "no prefix window was verifiable"


def test_real_engine_wire_text_matches_direct_final(real_stack):
    """The final wire hypothesis equals a direct decode of the full tail:
    the streaming path adds no text the engine would not produce."""
    backend = real_stack
    n_before = len(backend.calls)
    from whisperlive_tpu_torch.client import Client

    messages = []
    with ServerHarness(backend=backend, backend_name="torch") as h:
        client = Client(
            "127.0.0.1", h.port, lang="en", use_vad=False,
            log_transcription=False,
            transcription_callback=lambda text, segs: messages.append(segs),
        )
        deadline = time.time() + 15
        while not client.recording and time.time() < deadline:
            time.sleep(0.05)
        assert client.recording

        audio = _speech_like(2.5, seed=7)
        client.send_packet_to_server(audio.tobytes())
        deadline = time.time() + 60
        while len(backend.calls) == n_before and time.time() < deadline:
            time.sleep(0.2)
        client.close_websocket()

    calls = backend.calls[n_before:]
    assert calls
    last = calls[-1]
    assert last["result"] is not None
    # every decode in this session covered the full (never-committed or
    # partially-committed) tail; its text must match what the engine says
    # about exactly that audio
    from whisperlive_tpu_torch.serving.session import SessionOptions

    plain = TorchBackend(
        backend.scheduler, model_name="tiny",
        continuous_scheduler=backend.continuous_scheduler,
    )
    fresh = asyncio.run(
        plain.transcribe(
            last["audio"], SessionOptions(language="en", use_vad=False),
            language="en", previous_tokens=last["previous_tokens"],
            uid="direct-final", include_unfinished=True, window_anchor_s=None,
        )
    )
    assert "".join(s.text for s in last["result"].segments) == "".join(
        s.text for s in fresh.segments
    )


class JVisible(jtok.WhisperTokenizer):
    decode = VisibleTokenizer.decode


def test_real_engine_wire_windows_match_jax(real_stack, monkeypatch):
    """The windows a wire session decoded on the port, decoded again from
    scratch by the JAX package's TpuBackend on the same parameters (its
    own window scheduler and continuous pool), give the same tokens."""
    backend = real_stack
    n_before = len(backend.calls)
    from whisperlive_tpu_torch.client import Client

    with ServerHarness(backend=backend, backend_name="torch") as h:
        client = Client("127.0.0.1", h.port, lang="en", use_vad=False,
                        log_transcription=False)
        deadline = time.time() + 15
        while not client.recording and time.time() < deadline:
            time.sleep(0.05)
        assert client.recording
        audio = _speech_like(8.0, seed=5)
        deadline = time.time() + 120
        for off in range(0, len(audio), 4000):
            client.send_packet_to_server(audio[off:off + 4000].tobytes())
            time.sleep(0.25)
            if len(backend.calls) - n_before >= 3:
                break
        while len(backend.calls) - n_before < 3 and time.time() < deadline:
            time.sleep(0.2)
        client.close_websocket()
    calls = [c for c in backend.calls[n_before:] if c["result"] is not None]
    assert len(calls) >= 2

    monkeypatch.setattr(jbackends, "_DISABLE_GATES", True)
    monkeypatch.setattr(jbackends, "STREAMING_MAX_NEW_TOKENS", 20)
    jengine = JEngine(jw.WhisperConfig(**DIMS), jax_params(), compute_dtype=jnp.float32,
                      batch_buckets=(1, 2), tokenizer=JVisible(jtok.TokenSpec(
                          DIMS["n_vocab"], multilingual=True)))
    jwindow = JWindow(jengine, max_batch_size=2, batch_window_ms=10)
    jcont = JContinuous(jengine, n_slots=2, steps_per_chunk=4, prompt_pad=48, ring=64)
    jwindow.start()
    jcont.start()
    try:
        jplain = jbackends.TpuBackend(jwindow, model_name="tiny", continuous_scheduler=jcont)
        from whisperlive_tpu.serving.session import SessionOptions as JOptions

        for i, call in enumerate(calls):
            ref = asyncio.run(jplain.transcribe(
                call["audio"], JOptions(language="en", use_vad=False),
                language=call["language"], previous_tokens=call["previous_tokens"],
                uid=f"jax-{i}", include_unfinished=call["include_unfinished"],
                window_anchor_s=None))
            assert tuple(call["result"].raw_tokens) == tuple(ref.raw_tokens), f"window {i}"
            assert [(s.start, s.end, s.text) for s in call["result"].segments] == \
                [(s.start, s.end, s.text) for s in ref.segments], f"window {i}"
    finally:
        jcont.stop()
        jwindow.stop()
