"""The port's engine, scheduler, backend and server against the JAX package.

Both engines get the same parameters (JAX init_params, carried over with
from_jax_params) and the same numpy audio, and run on the CPU in float32,
once with float weights and cross-KV and once with decoder_int8=True,
cross_kv_bits=8. Greedy tokens must be exact, no_speech_prob within 1e-4,
avg_logprob within 1e-4 and detected languages equal. The backends see
identical chunks through asyncio.run(backend.transcribe(...)); the wire test
drives the port's server with the real client over a WebSocket.
"""

import asyncio
import functools
import time

import numpy as np
import pytest
import torch

import jax

from tests.test_server_e2e import ServerHarness
from tests.test_torch_model import small_configs
from whisperlive_tpu.engine.engine import TranscribeOptions as JOptions
from whisperlive_tpu.engine.engine import WhisperEngine as JEngine
from whisperlive_tpu.engine.scheduler import BatchScheduler as JScheduler
from whisperlive_tpu.engine.tokenizer import TokenSpec, WhisperTokenizer
from whisperlive_tpu.models import whisper as jw
from whisperlive_tpu.serving import backends as jbackends
from whisperlive_tpu.serving.session import SessionOptions
from whisperlive_tpu_torch.engine.engine import TranscribeOptions as TOptions
from whisperlive_tpu_torch.engine.engine import WhisperEngine as TEngine
from whisperlive_tpu_torch.engine.scheduler import BatchRequest
from whisperlive_tpu_torch.engine.scheduler import BatchScheduler as TScheduler
from whisperlive_tpu_torch.models.bridge import from_jax_params
from whisperlive_tpu_torch.serving import backends as tbackends

torch.set_num_threads(2)

BUCKETS = (2,)  # one batch bucket: one compiled program per JAX engine
MAX_NEW = 24


class VisibleTokenizer(WhisperTokenizer):
    """Text tokens decode to visible words, so segments carry text."""

    def decode(self, tokens):
        return "".join(f" t{int(t)}" for t in tokens if int(t) < self.spec.eot)


def tokenizer():
    return VisibleTokenizer(TokenSpec(51865, multilingual=True))


def speech_like(seconds, seed=0):
    t = np.arange(int(16000 * seconds)) / 16000.0
    rng = np.random.default_rng(seed)
    f0 = 140 + 40 * np.sin(2 * np.pi * 2.1 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
    sig = sig * (0.55 + 0.45 * np.sin(2 * np.pi * 3.7 * t)) + 0.02 * rng.standard_normal(t.shape)
    return (0.12 * sig / np.max(np.abs(sig))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def make_engines(mode):
    """(JAX engine, port engine) on the same parameters, built once per mode."""
    quant = mode == "int8"
    kw = dict(decoder_int8=quant, cross_kv_bits=8 if quant else 16)
    jcfg, tcfg = small_configs()
    jp = jw.init_params(jcfg, 0)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    je = JEngine(jcfg, jp, batch_buckets=BUCKETS, tokenizer=tokenizer(), **kw)
    te = TEngine(tcfg, tp, batch_buckets=BUCKETS, tokenizer=tokenizer(), device="cpu", **kw)
    assert te.decoder_int8 == quant and (te.cross_kv_bits == 8) == quant
    return je, te


@pytest.fixture(params=["float", "int8"])
def engines(request):
    return make_engines(request.param)


@pytest.fixture
def float_engines():
    return make_engines("float")


def window_batch():
    audio = np.zeros((2, 480000), np.float32)
    audio[0, :48000] = speech_like(3.0, 1)
    audio[1, :120000] = speech_like(7.5, 2)
    return audio


def assert_same_results(jres, tres):
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        assert list(a.tokens) == list(b.tokens)
        assert abs(a.no_speech_prob - b.no_speech_prob) <= 1e-4
        assert abs(a.avg_logprob - b.avg_logprob) <= 1e-4
        assert a.temperature == b.temperature
        assert a.compression_ratio == pytest.approx(b.compression_ratio)


def test_transcribe_batch_matches_jax(engines):
    je, te = engines
    audio = window_batch()
    kw = dict(max_new_tokens=MAX_NEW)
    p_en, s_en = je.build_prompt(JOptions(language="en"))
    p_fr, s_fr = je.build_prompt(JOptions(language="fr"), previous_tokens=[100, 200, 300])
    assert te.build_prompt(TOptions(language="fr"), previous_tokens=[100, 200, 300]) == (
        p_fr, s_fr)
    # item 0 knows its language; item 1's language token is detected on device
    args = (audio, [p_en, p_fr], [s_en, s_fr], [True, False])
    jres, jlang, _ = je.transcribe_batch(*args, JOptions(**kw))
    tres, tlang, tcross = te.transcribe_batch(*args, TOptions(**kw))
    assert_same_results(jres, tres)
    assert [lang for lang, _ in tlang] == [lang for lang, _ in jlang]
    for (_, pa), (_, pb) in zip(jlang, tlang):
        assert abs(pa - pb) <= 1e-4
    assert set(tcross) == ({"kv8", "scale"} if te.decoder_int8 else {"kv", "scale"})


def test_decode_with_fallback_matches_jax(engines):
    """Random weights fail the avg-logprob gate, so every item is retried
    (greedy again, on the gathered sub-batch) and the best attempt kept."""
    je, te = engines
    audio = window_batch()
    opts = dict(max_new_tokens=MAX_NEW, temperatures=(0.0, 0.0), language="en")
    p, s = je.build_prompt(JOptions(language="en"))
    _, jcross = je.prepare(audio)
    _, tcross = te.prepare(audio)
    jres = je.decode_with_fallback(jcross, [p], [s], JOptions(**opts))
    tres = te.decode_with_fallback(tcross, [p], [s], TOptions(**opts))
    assert jres[0].avg_logprob < -1.0  # the gate did fail: the retry ran
    assert_same_results(jres, tres)
    sub = te.gather_cross(tcross, [1, 1])
    key = "kv8" if te.cross_kv_bits == 8 else "kv"
    assert torch.equal(sub[key][:, :, 0], tcross[key][:, :, 1])


def test_detect_language_matches_jax(engines):
    je, te = engines
    audio = window_batch()
    jlang = je.detect_language_from_cross(je.prepare(audio)[1])
    tlang = te.detect_language_from_cross(te.prepare(audio)[1])
    assert [lang for lang, _ in tlang] == [lang for lang, _ in jlang]
    np.testing.assert_allclose([p for _, p in tlang], [p for _, p in jlang], atol=1e-5)


def test_warmup_runs_the_serving_and_fallback_paths(float_engines):
    _, te = float_engines
    calls = []
    decode_batch = te.decode_batch
    te.decode_batch = lambda *a, **kw: calls.append("decode") or decode_batch(*a, **kw)
    try:
        te.warmup(batch_sizes=[2], options=TOptions(language="en", max_new_tokens=4))
    finally:
        del te.decode_batch
    assert calls == ["decode"]


def test_prepare_accepts_int16_pcm(engines):
    _, te = engines
    audio = window_batch()
    pcm = np.round(audio * 32767).astype(np.int16)
    enc16, _ = te.prepare(pcm)
    enc32, _ = te.prepare(pcm.astype(np.float32) / 32767.0)
    torch.testing.assert_close(enc16, enc32)


# ---------------------------------------------------------------------------
# scheduler + backend, against the JAX window-scheduler backend
# ---------------------------------------------------------------------------


@pytest.fixture
def greedy_gates_off(monkeypatch):
    for mod in (jbackends, tbackends):
        monkeypatch.setattr(mod, "_DISABLE_GATES", True)
        monkeypatch.setattr(mod, "STREAMING_MAX_NEW_TOKENS", MAX_NEW)


def test_backend_matches_jax_window_backend(float_engines, greedy_gates_off):
    je, te = float_engines
    jsched, tsched = JScheduler(je, max_batch_size=2), TScheduler(te, max_batch_size=2)
    jsched.start()
    tsched.start()
    try:
        jb = jbackends.TpuBackend(jsched, model_name="test")
        tb = tbackends.TorchBackend(tsched, model_name="test")
        chunks = [
            (speech_like(2.0, 3), SessionOptions(language="en", use_vad=False), "en", ()),
            (speech_like(4.5, 4), SessionOptions(use_vad=True), None, (400, 500)),
        ]

        async def run(backend):
            return await asyncio.gather(*(
                backend.transcribe(chunk, opts, language=lang, previous_tokens=prev,
                                   uid=f"u{i}")
                for i, (chunk, opts, lang, prev) in enumerate(chunks)
            ))

        jout, tout = asyncio.run(run(jb)), asyncio.run(run(tb))
    finally:
        jsched.stop()
        tsched.stop()
    for a, b in zip(jout, tout):
        assert b is not None and a is not None
        assert b.raw_tokens == a.raw_tokens and b.raw_tokens
        assert [(s.start, s.end, s.text) for s in b.segments] == [
            (s.start, s.end, s.text) for s in a.segments]
        assert (b.language, b.duration, b.advance_s) == (a.language, a.duration, a.advance_s)
        assert abs(a.language_prob - b.language_prob) <= 1e-4


def test_scheduler_refuses_unported_options(engines):
    """Word-timestamp and beam requests are ported now: the scheduler
    queues them instead of failing them, and a beamed decode_batch is the
    JAX engine's beam search."""
    je, te = engines
    sched = TScheduler(te)  # never started: accepted requests stay queued
    for opts in (TOptions(word_timestamps=True), TOptions(beam_size=2)):
        fut = sched.submit(BatchRequest(audio=np.zeros(16000, np.float32), options=opts))
        assert not fut.done()
    assert sched._queue.qsize() == 2
    audio = window_batch()
    p, s = je.build_prompt(JOptions(language="en"))
    kw = dict(language="en", beam_size=2, temperatures=(0.0,), max_new_tokens=MAX_NEW)
    jres = je.decode_batch(je.prepare(audio)[1], [p, p], [s, s], JOptions(**kw))
    tres = te.decode_batch(te.prepare(audio)[1], [p, p], [s, s], TOptions(**kw))
    assert_same_results(jres, tres)


def test_server_answers_a_real_client(float_engines, greedy_gates_off):
    """Client -> WebSocket -> TranscriptionServer -> TorchBackend ->
    BatchScheduler -> WhisperEngine, and segments back to the client."""
    _, te = float_engines
    from whisperlive_tpu.client import Client

    sched = TScheduler(te, max_batch_size=2, batch_window_ms=10)
    sched.start()
    backend = tbackends.TorchBackend(sched, model_name="test")
    calls = []
    transcribe = backend.transcribe

    async def recording(chunk, options, **kw):
        result = await transcribe(chunk, options, **kw)
        calls.append(result)
        return result

    backend.transcribe = recording
    messages = []
    try:
        with ServerHarness(backend=backend, backend_name="torch") as h:
            client = Client(
                "127.0.0.1", h.port, lang="en", use_vad=False, log_transcription=False,
                transcription_callback=lambda text, segs: messages.append(segs),
            )
            deadline = time.time() + 15
            while not client.recording and time.time() < deadline:
                time.sleep(0.05)
            assert client.recording, "SERVER_READY never arrived"
            assert client.server_backend == "torch"
            audio = speech_like(3.0, 5)
            for off in range(0, len(audio), 8000):
                client.send_packet_to_server(audio[off:off + 8000].tobytes())
                time.sleep(0.1)
            deadline = time.time() + 60
            while (not calls or not messages) and time.time() < deadline:
                time.sleep(0.1)
            client.close_websocket()
    finally:
        sched.stop()
    assert calls and all(c is not None and c.raw_tokens for c in calls)
    assert messages, "no segments reached the client"
    for segs in messages:
        for seg in segs:
            assert set(seg) >= {"start", "end", "text", "completed"}
            assert float(seg["end"]) >= float(seg["start"])


def test_cli_builds_a_serving_backend():
    from whisperlive_tpu_torch.cli.run_server import build_parser, create_backend

    args = build_parser().parse_args(
        ["--model", "tiny", "--device", "cpu", "--no_warmup", "--batch_max_size", "2"])
    backend = create_backend(args)
    try:
        assert isinstance(backend, tbackends.TorchBackend)
        eng = backend.scheduler.engine
        assert eng.device.type == "cpu" and eng.cfg.dtype == torch.float32
        assert not eng.decoder_int8 and eng.cross_kv_bits == 16
        assert backend.scheduler.max_batch_size == 2
    finally:
        backend.scheduler.stop()
