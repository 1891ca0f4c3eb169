"""The port's REST endpoint against the JAX package's.

The cases of tests/test_rest.py run on the port's aiohttp app with the
port's FakeBackend. For the same multipart uploads the port's app and the
JAX app (each over its own package's FakeBackend) answer with byte-equal
bodies, statuses and content types: the five response formats, the SSE
stream, known-speaker labels, and 400, 401 and 429. One real-engine case:
a narrow Whisper from the JAX init_params, carried over by from_jax_params,
behind the port's TorchBackend and the JAX TpuBackend (window schedulers,
float32 on the CPU): a 35 s upload (two seek windows) gives token-exact
segments. `_adjust_options` overridden in a subclass reaches the scheduler.
"""

import asyncio
import dataclasses
import io
import json
import socket
import threading
import time
import types
import urllib.request
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisperlive_tpu.engine import tokenizer as jtok
from whisperlive_tpu.engine.engine import WhisperEngine as JEngine
from whisperlive_tpu.engine.scheduler import BatchScheduler as JWindow
from whisperlive_tpu.models import whisper as jw
from whisperlive_tpu.serving import backends as jbackends
from whisperlive_tpu.serving import rest as jrest
from whisperlive_tpu_torch.engine import tokenizer as ttok
from whisperlive_tpu_torch.engine.engine import WhisperEngine as TEngine
from whisperlive_tpu_torch.engine.scheduler import BatchResult
from whisperlive_tpu_torch.engine.scheduler import BatchScheduler as TWindow
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.models.bridge import from_jax_params
from whisperlive_tpu_torch.serving import backends as tbackends
from whisperlive_tpu_torch.serving import rest as trest
from whisperlive_tpu_torch.serving.backends import FakeBackend
from whisperlive_tpu_torch.serving.rest import _transcribe_full, start_rest_server
from whisperlive_tpu_torch.serving.session import SessionOptions

torch.set_num_threads(2)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class RestHarness:
    """A REST app on its own loop in a thread; `start` is the package's
    start_rest_server."""

    def __init__(self, backend=None, start=start_rest_server, **kwargs):
        self.port = _free_port()
        self.backend = backend if backend is not None else FakeBackend()
        self.start = start
        self.kwargs = kwargs
        self._loop = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        runner = self._loop.run_until_complete(
            self.start(self.backend, port=self.port, host="127.0.0.1", **self.kwargs))
        try:
            self._loop.run_forever()
        finally:
            self._loop.run_until_complete(runner.cleanup())
            self._loop.close()

    def __enter__(self):
        self._thread.start()
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                with socket.create_connection(("127.0.0.1", self.port), timeout=0.2):
                    return self
            except OSError:
                time.sleep(0.05)
        raise RuntimeError("REST server did not start")

    def __exit__(self, *exc):
        if self._loop and not self._loop.is_closed():
            self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)
        assert not self._thread.is_alive()
        return False


def _multipart(fields, files):
    """fields: {name: value}; files: [(name, filename, data)] in order, a
    part without a filename being a text field."""
    boundary = "XloBoundaryX"
    body = io.BytesIO()
    for name, value in fields.items():
        body.write(f"--{boundary}\r\n".encode())
        body.write(f'Content-Disposition: form-data; name="{name}"\r\n\r\n'.encode())
        body.write(f"{value}\r\n".encode())
    for name, fname, data in files:
        body.write(f"--{boundary}\r\n".encode())
        if fname is None:
            body.write(f'Content-Disposition: form-data; name="{name}"\r\n\r\n'.encode())
            body.write(f"{data}\r\n".encode())
            continue
        body.write(
            f'Content-Disposition: form-data; name="{name}"; filename="{fname}"\r\n'.encode())
        body.write(b"Content-Type: application/octet-stream\r\n\r\n")
        body.write(data)
        body.write(b"\r\n")
    body.write(f"--{boundary}--\r\n".encode())
    return body.getvalue(), f"multipart/form-data; boundary={boundary}"


def _request(port, fields, files, headers=None):
    """POST -> (status, content type, body bytes)."""
    raw, ctype = _multipart(fields, files)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/audio/transcriptions", data=raw, method="POST")
    req.add_header("Content-Type", ctype)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _post(port, fields, files, headers=None):
    files = [(name, fname, data) for name, (fname, data) in files.items()]
    code, _, body = _request(port, fields, files, headers)
    return code, body.decode()


def _wav_bytes(seconds=2.0, seed=0, audio=None):
    if audio is None:
        audio = (0.1 * np.random.default_rng(seed).standard_normal(int(16000 * seconds))).astype(
            np.float32)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _voice(seconds, f0, seed):
    t = np.arange(int(16000 * seconds)) / 16000.0
    rng = np.random.default_rng(seed)
    sig = sum(np.sin(2 * np.pi * k * f0 * t + rng.random()) / k ** 1.5 for k in range(1, 10))
    sig = sig * (0.6 + 0.4 * np.sin(2 * np.pi * 3.3 * t))
    return (0.1 * sig / np.abs(sig).max()).astype(np.float32)


# ---------------------------------------------------------------------------
# The cases of tests/test_rest.py on the port's app
# ---------------------------------------------------------------------------


def test_rest_json_and_formats():
    with RestHarness() as h:
        wav = _wav_bytes(2.5)
        code, body = _post(h.port, {"response_format": "json"}, {"file": ("a.wav", wav)})
        assert code == 200
        assert "word0" in json.loads(body)["text"]

        code, body = _post(h.port, {"response_format": "verbose_json"}, {"file": ("a.wav", wav)})
        data = json.loads(body)
        assert code == 200 and data["segments"]
        assert data["duration"] == pytest.approx(2.5, abs=0.1)

        code, body = _post(h.port, {"response_format": "vtt"}, {"file": ("a.wav", wav)})
        assert code == 200 and body.startswith("WEBVTT")

        code, body = _post(h.port, {"response_format": "nope"}, {"file": ("a.wav", wav)})
        assert code == 400


def test_rest_auth_and_rate_limit():
    with RestHarness(api_key="k3y", rate_limit_rpm=2) as h:
        wav = _wav_bytes(1.0)
        code, _ = _post(h.port, {}, {"file": ("a.wav", wav)})
        assert code == 401
        ok = {"Authorization": "Bearer k3y"}
        assert _post(h.port, {}, {"file": ("a.wav", wav)}, ok)[0] == 200
        assert _post(h.port, {}, {"file": ("a.wav", wav)}, ok)[0] == 200
        assert _post(h.port, {}, {"file": ("a.wav", wav)}, ok)[0] == 429


def test_rest_known_speakers():
    with RestHarness() as h:
        wav = _wav_bytes(3.0)
        ref = _wav_bytes(1.0, seed=1)
        code, body = _post(
            h.port,
            {"response_format": "verbose_json", "known_speaker_names": "alice"},
            {"file": ("a.wav", wav), "known_speaker_files": ("alice.wav", ref)},
        )
        assert code == 200
        segs = json.loads(body)["segments"]
        assert segs and any("speaker" in s for s in segs)


class WordyBackend(FakeBackend):
    async def transcribe(self, chunk, options, **kw):
        result = await super().transcribe(chunk, options, **kw)
        if options.word_timestamps:
            for s in result.segments:
                s.words = [types.SimpleNamespace(start=s.start, end=s.end, word=s.text,
                                                 probability=0.9)]
        return result


def test_rest_word_timestamps_field():
    """verbose_json carries word timings when timestamp_granularities
    includes 'word' and the backend provides them."""
    with RestHarness(backend=WordyBackend()) as h:
        wav = _wav_bytes(2.0)
        code, body = _post(
            h.port,
            {"response_format": "verbose_json", "timestamp_granularities": "word"},
            {"file": ("a.wav", wav)},
        )
    assert code == 200
    segs = json.loads(body)["segments"]
    assert segs and "words" in segs[0]
    assert segs[0]["words"][0]["probability"] == 0.9


def test_transcribe_full_advances_by_seek_feedback():
    """The seek loop follows the decode's own feedback: a window whose
    output ends mid-segment rewinds to the last closed timestamp, and the
    per-uid backend state is released once, after the loop."""
    calls = []
    released = []

    class SeekBackend:
        async def transcribe(self, chunk, options, *, language=None, previous_tokens=(),
                             uid="", include_unfinished=True):
            calls.append((len(chunk) / 16000.0, include_unfinished))
            dur = len(chunk) / 16000.0
            first = len(calls) == 1
            end = 20.0 if first else dur
            return BatchResult(
                segments=[types.SimpleNamespace(
                    start=0.0, end=end, text=" first" if first else " rest",
                    tokens=[1 if first else 2], avg_logprob=-0.1, no_speech_prob=0.0,
                    compression_ratio=1.0, temperature=0.0, words=None)],
                language="en", language_prob=1.0, duration=dur, advance_s=end,
            )

        def release(self, uid):
            released.append(uid)

    audio = np.zeros(16000 * 40, np.float32)  # 40 s file
    segments, lang = asyncio.run(_transcribe_full(SeekBackend(), audio, SessionOptions(), None))
    assert [round(c[0]) for c in calls] == [30, 20]
    assert all(c[1] is False for c in calls)  # offline mode: drop unfinished
    assert [s["text"] for s in segments] == [" first", " rest"]
    assert segments[1]["start"] == pytest.approx(20.0)
    assert segments[1]["end"] == pytest.approx(40.0)
    assert len(released) == 1 and lang == "en"


def test_health_cors_and_preflight():
    with RestHarness(cors_origins=["http://a.example"]) as h:
        with urllib.request.urlopen(f"http://127.0.0.1:{h.port}/health", timeout=10) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        req = urllib.request.Request(f"http://127.0.0.1:{h.port}/v1/audio/transcriptions",
                                     method="OPTIONS", headers={"Origin": "http://a.example"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 204
            assert r.headers["Access-Control-Allow-Origin"] == "http://a.example"


# ---------------------------------------------------------------------------
# Byte-equal to the JAX app
# ---------------------------------------------------------------------------

WAV = _wav_bytes(3.4, seed=3)
CASES = {
    "json": ({"response_format": "json"}, [("file", "a.wav", WAV)], {}),
    "text": ({"response_format": "text"}, [("file", "a.wav", WAV)], {}),
    "srt": ({"response_format": "srt"}, [("file", "a.wav", WAV)], {}),
    "vtt": ({"response_format": "vtt"}, [("file", "a.wav", WAV)], {}),
    "verbose_json": ({"response_format": "verbose_json", "language": "de"},
                     [("file", "a.wav", WAV)], {}),
    "raw_f32": ({}, [("file", "blob.bin", _voice(2.2, 150, 0).tobytes())], {}),
    "sse": ({"stream": "true"}, [("file", "a.wav", WAV)], {}),
    "known_speakers": (
        {"response_format": "verbose_json"},
        [("file", "a.wav", _wav_bytes(audio=np.concatenate([_voice(2.0, 120, 1),
                                                            _voice(2.0, 260, 2)]))),
         ("known_speaker_files[]", "lo.wav", _wav_bytes(audio=_voice(2.0, 120, 3))),
         ("known_speaker_names[]", None, "low"),
         ("known_speaker_files[]", "hi.wav", _wav_bytes(audio=_voice(2.0, 260, 4)))], {}),
    "missing_file": ({"response_format": "json"}, [], {}),
    "bad_format": ({"response_format": "nope"}, [("file", "a.wav", WAV)], {}),
    "undecodable": ({}, [("file", "a.wav", b"RIFFgarbage")], {}),
    "no_key": ({}, [("file", "a.wav", WAV)], {"auth": None}),
    "wrong_key": ({}, [("file", "a.wav", WAV)], {"auth": "Bearer nope"}),
}


def _case_request(port, name):
    fields, files, extra = CASES[name]
    headers = {"Authorization": "Bearer k"}
    if "auth" in extra:
        headers = {} if extra["auth"] is None else {"Authorization": extra["auth"]}
    return _request(port, fields, files, headers)


@pytest.fixture(scope="module")
def both_apps():
    with RestHarness(api_key="k") as t, \
            RestHarness(backend=jbackends.FakeBackend(), start=jrest.start_rest_server,
                        api_key="k") as j:
        yield t.port, j.port


@pytest.mark.parametrize("name", sorted(CASES))
def test_bytes_equal_to_the_jax_app(both_apps, name):
    tport, jport = both_apps
    ours, ref = _case_request(tport, name), _case_request(jport, name)
    assert ours == ref
    status = ours[0]
    expect = {"missing_file": 400, "bad_format": 400, "undecodable": 400, "no_key": 401,
              "wrong_key": 401}.get(name, 200)
    assert status == expect
    if name == "sse":
        events = ours[2].decode().split("\n\n")
        assert events[-2] == "data: [DONE]" and events[-1] == ""
        assert json.loads(events[0][len("data: "):]) == {"text": " word0", "start": 0.0,
                                                          "end": 1.0}
    if name == "known_speakers":
        labels = [s.get("speaker") for s in json.loads(ours[2])["segments"]]
        # the first reference takes the one name given, the second its file name
        assert labels and set(labels) <= {"low", "hi.wav"}


def test_rate_limit_bytes_equal_to_the_jax_app():
    with RestHarness(rate_limit_rpm=2) as t, \
            RestHarness(backend=jbackends.FakeBackend(), start=jrest.start_rest_server,
                        rate_limit_rpm=2) as j:
        for expect in (200, 200, 429):
            ours = _request(t.port, {"response_format": "text"}, [("file", "a.wav", WAV)])
            ref = _request(j.port, {"response_format": "text"}, [("file", "a.wav", WAV)])
            assert ours == ref and ours[0] == expect


def test_format_response_matches_jax():
    segs = [dict(start=0.0, end=1.5, text=" a", tokens=[1, 2], temperature=0.0,
                 avg_logprob=-0.2, compression_ratio=1.1, no_speech_prob=0.01,
                 speaker="SPEAKER_0"),
            dict(start=1.5, end=3.25, text=" b", tokens=[3], temperature=0.2,
                 avg_logprob=-0.4, compression_ratio=1.3, no_speech_prob=0.02,
                 words=[{"start": 1.5, "end": 2.0, "word": " b", "probability": 0.5}])]
    for fmt in trest.RESPONSE_FORMATS:
        assert trest._format_response(segs, "en", 3.25, fmt) == \
            jrest._format_response(segs, "en", 3.25, fmt)


# ---------------------------------------------------------------------------
# A real engine behind each package's backend
# ---------------------------------------------------------------------------

DIMS = dict(
    n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
    n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)


class JVisible(jtok.WhisperTokenizer):
    """Text tokens decode to visible words, so segments carry text."""

    def decode(self, tokens):
        return "".join(f" t{int(t)}" for t in tokens if int(t) < self.spec.eot)


class TVisible(ttok.WhisperTokenizer):
    decode = JVisible.decode


@pytest.fixture
def gates_off(monkeypatch):
    for mod in (jbackends, tbackends):
        monkeypatch.setattr(mod, "_DISABLE_GATES", True)
        monkeypatch.setattr(mod, "STREAMING_MAX_NEW_TOKENS", 24)


def _speech(seconds, seed):
    t = np.arange(int(16000 * seconds)) / 16000.0
    rng = np.random.default_rng(seed)
    f0 = 140 + 40 * np.sin(2 * np.pi * 2.1 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
    sig = sig * (0.55 + 0.45 * np.sin(2 * np.pi * 3.7 * t)) + 0.02 * rng.standard_normal(t.shape)
    return (0.12 * sig / np.max(np.abs(sig))).astype(np.float32)


def test_real_engine_segments_token_exact(gates_off):
    jcfg, tcfg = jw.WhisperConfig(**DIMS), tw.WhisperConfig(**DIMS)
    jp = jw.init_params(jcfg, 0)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    je = JEngine(jcfg, jp, compute_dtype=jnp.float32, batch_buckets=(1,),
                 tokenizer=JVisible(jtok.TokenSpec(51865, multilingual=True)))
    te = TEngine(tcfg, tp, batch_buckets=(1,), device="cpu",
                 tokenizer=TVisible(ttok.TokenSpec(51865, multilingual=True)))
    audio = _speech(35.0, 1)
    options = SessionOptions(language="en", use_vad=False)

    def run(backend, rest_mod):
        backend.scheduler.start()
        try:
            segs, lang = asyncio.run(rest_mod._transcribe_full(backend, audio, options, "en"))
        finally:
            backend.scheduler.stop()
        return [(s["text"], s["start"], s["end"], s["tokens"]) for s in segs], lang

    ref = run(jbackends.TpuBackend(JWindow(je), model_name="t"), jrest)
    ours = run(tbackends.TorchBackend(TWindow(te), model_name="t"), trest)
    assert ours == ref
    segs = ours[0]
    assert segs and max(s[2] for s in segs) > 30.0  # the second seek window decoded
    assert all(s[3] for s in segs)


def test_adjust_options_reaches_the_scheduler(gates_off):
    seen = []

    class Scheduler:
        def submit(self, req):
            seen.append(req.options)
            req.future.set_result(BatchResult(segments=[], language="en", language_prob=1.0,
                                              duration=1.0, advance_s=1.0))

    class Shorter(tbackends.TorchBackend):
        def _adjust_options(self, topts, chunk):
            return dataclasses.replace(topts, max_new_tokens=len(chunk) // 16000)

    backend = Shorter(Scheduler())
    result = asyncio.run(backend.transcribe(np.zeros(48000, np.float32),
                                            SessionOptions(use_vad=False), uid="u"))
    assert result.advance_s == 1.0
    assert [o.max_new_tokens for o in seen] == [3]
    # the base class leaves the options as they are
    plain = tbackends.TorchBackend(Scheduler())
    asyncio.run(plain.transcribe(np.zeros(16000, np.float32), SessionOptions(use_vad=False),
                                 uid="u"))
    assert seen[-1].max_new_tokens == 24
