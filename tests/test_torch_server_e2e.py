"""The port's client against the port's server over real websockets.

The cases of tests/test_server_e2e.py: a real TranscriptionServer of the
port on a real port, the port's client library streaming real PCM, with
FakeBackend standing in for the model. Then what the port's server no
longer refuses: a diarized session (every committed segment labelled), a
translated session through translator_factory (translated_segments), and
the REST listener that serve(rest_port=...) starts beside the websocket
one. Then the cases of tests/test_client.py on the port's client (mocked
websocket). Last, parity with the JAX package: its client and the port's fed
the same socket events, and its server and the port's fed the same scripted
session (diarized, translated through translator_factory, translated by the
default worker), each compared message for message.
"""

import asyncio
import json
import socket
import threading
import time
import urllib.request
from unittest import mock

import numpy as np
import pytest

from whisperlive_tpu_torch.serving.backends import FakeBackend
from whisperlive_tpu_torch.serving.server import TranscriptionServer


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class ServerHarness:
    def __init__(self, max_clients=4, api_key=None, max_connection_time=600,
                 backend=None, backend_name="fake", **serve_kwargs):
        self.port = _free_port()
        self.serve_kwargs = serve_kwargs
        self.max_clients = max_clients
        self.api_key = api_key
        self.max_connection_time = max_connection_time
        self.backend = backend if backend is not None else FakeBackend()
        self.backend_name = backend_name
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._loop = None

    def _run(self):
        self.server = TranscriptionServer()
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(
                self.server.serve(
                    self.backend,
                    host="127.0.0.1",
                    port=self.port,
                    backend_name=self.backend_name,
                    max_clients=self.max_clients,
                    max_connection_time=self.max_connection_time,
                    api_key=self.api_key,
                    **self.serve_kwargs,
                )
            )
        except Exception:
            pass
        finally:
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
        raise RuntimeError("server did not start")

    def __exit__(self, *exc):
        if self._loop is not None and not self._loop.is_closed():
            self._loop.call_soon_threadsafe(self.server.request_shutdown)
        self._thread.join(timeout=10)
        return False


@pytest.fixture()
def server():
    with ServerHarness() as h:
        yield h


def test_streaming_client_end_to_end(server):
    from whisperlive_tpu_torch.client import StreamingTranscriptionClient

    committed, partials = [], []
    client = StreamingTranscriptionClient(
        "127.0.0.1",
        server.port,
        lang="en",
        on_committed=committed.append,
        on_partial=partials.append,
        use_vad=False,
        same_output_threshold=2,
    )
    audio = (0.1 * np.sin(2 * np.pi * 300 * np.arange(16000 * 4) / 16000)).astype(
        np.float32
    )
    for off in range(0, len(audio), 8000):
        client.send_array(audio[off : off + 8000])
        time.sleep(0.05)
    deadline = time.time() + 15
    while not committed and time.time() < deadline:
        time.sleep(0.1)
    client.close(wait_for_server=False)
    assert committed, "no committed segments received"
    seg = committed[0]
    assert set(seg) >= {"start", "end", "text", "completed"}
    assert seg["completed"] is True
    assert "." in seg["start"]  # ms-precision string format
    assert seg["text"].strip().startswith("word")


def test_server_full_sends_wait(server):
    from whisperlive_tpu_torch.client import Client, StreamingTranscriptionClient

    clients = [
        StreamingTranscriptionClient("127.0.0.1", server.port, use_vad=False)
        for _ in range(4)
    ]
    # 5th client must get a WAIT status
    extra = Client("127.0.0.1", server.port, log_transcription=False)
    deadline = time.time() + 10
    while not extra.waiting and time.time() < deadline:
        time.sleep(0.05)
    assert extra.waiting
    extra.close_websocket()
    for c in clients:
        c.close(wait_for_server=False)


def test_api_key_auth():
    from whisperlive_tpu_torch.client import StreamingTranscriptionClient

    with ServerHarness(api_key="sekret") as h:
        # wrong key: connection is closed before SERVER_READY
        with pytest.raises((ConnectionError, TimeoutError)):
            StreamingTranscriptionClient(
                "127.0.0.1", h.port, connect_timeout=3, use_vad=False
            )
        # correct key via query token
        ok = StreamingTranscriptionClient(
            "127.0.0.1", h.port, connect_timeout=10, use_vad=False, api_key="sekret"
        )
        ok.close(wait_for_server=False)


def test_transcription_client_file(tmp_path, server):
    from whisperlive_tpu_torch.audio.io import write_wav
    from whisperlive_tpu_torch.client import TranscriptionClient

    wav = tmp_path / "t.wav"
    audio = (0.05 * np.random.default_rng(0).standard_normal(16000 * 3)).astype(
        np.float32
    )
    write_wav(str(wav), audio)
    srt = tmp_path / "out.srt"
    client = TranscriptionClient(
        "127.0.0.1",
        server.port,
        lang="en",
        use_vad=False,
        same_output_threshold=2,
        srt_file_path=str(srt),
        log_transcription=False,
    )
    client.client.disconnect_if_no_response_for = 2
    text = client(str(wav))
    assert "word" in text
    assert srt.exists()
    content = srt.read_text()
    assert "-->" in content and "word" in content


def test_connection_time_eviction():
    """Clients past max_connection_time get DISCONNECT and are dropped
    (server.py:141-158 behavior)."""

    with ServerHarness(max_connection_time=3) as h:
        from whisperlive_tpu_torch.client import Client

        c = Client("127.0.0.1", h.port, log_transcription=False)
        deadline = time.time() + 10
        while not c.recording and time.time() < deadline:
            time.sleep(0.05)
        assert c.recording
        # stream a little audio, then wait past the limit
        c.send_packet_to_server(np.zeros(8000, np.float32).tobytes())
        deadline = time.time() + 15
        while c.recording and time.time() < deadline:
            time.sleep(0.2)
        assert not c.recording  # DISCONNECT flipped recording off
        c.close_websocket()


def test_model_mismatch_warning():
    """Requesting a different model than served yields a WARNING status."""
    with ServerHarness() as h:
        h.server.backend.model_name = "large-v3"  # pretend a specific model

        from whisperlive_tpu_torch.client import Client

        warnings = []
        c = Client("127.0.0.1", h.port, model="tiny", log_transcription=False)
        orig = c.handle_status_messages

        def capture(msg):
            if msg.get("status") == "WARNING":
                warnings.append(msg["message"])
            orig(msg)

        c.handle_status_messages = capture
        deadline = time.time() + 10
        while not c.recording and time.time() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)
        c.close_websocket()
        assert any("large-v3" in w for w in warnings)


def test_backend_state_released_on_disconnect():
    """Per-uid backend state (VAD instances) must be freed when the client
    leaves, or a long-lived server leaks one entry per connection."""
    released = []

    class TrackingBackend(FakeBackend):
        def release(self, uid):
            released.append(uid)

    with ServerHarness() as h:
        h.server.backend = TrackingBackend()
        from whisperlive_tpu_torch.client import StreamingTranscriptionClient

        c = StreamingTranscriptionClient("127.0.0.1", h.port, use_vad=False)
        uid = c.client.uid
        c.close(wait_for_server=False)
        deadline = time.time() + 10
        while uid not in released and time.time() < deadline:
            time.sleep(0.1)
        assert uid in released


def test_vad_gated_session_does_not_starve_event_loop():
    """Regression: backend.transcribe returning None SYNCHRONOUSLY (the
    VAD-silence gate) must not let speech_to_text spin without yielding —
    that seizes the event loop and starves every other connection."""
    import asyncio

    import numpy as np

    from whisperlive_tpu_torch.serving.server import ServeClient
    from whisperlive_tpu_torch.serving.session import SessionOptions

    class SilenceBackend:
        async def transcribe(self, chunk, options, **kw):
            return None  # completes without ever awaiting

    async def drive():
        client = ServeClient(
            websocket=None, uid="starve",
            options=SessionOptions(language="en", use_vad=False),
            backend=SilenceBackend(),
            send_json=lambda payload: None,
        )
        client.add_frames(np.zeros(32000, np.float32))  # 2 s tail, forever
        client.start()
        try:
            ticks = 0
            # with the busy-spin bug this coroutine never runs and
            # wait_for times out
            async def other():
                nonlocal ticks
                for _ in range(5):
                    await asyncio.sleep(0.02)
                    ticks += 1

            await asyncio.wait_for(other(), timeout=5)
            assert ticks == 5
        finally:
            await client.cleanup()

    asyncio.run(drive())


def test_cadence_spacing_policy():
    """Adaptive cadence: spacing engages only under sustained pool
    saturation, scales with the stream's round-trip EMA, and can be
    disabled (WL_ADAPTIVE_CADENCE=0)."""
    from whisperlive_tpu_torch.serving.backends import TorchBackend

    class StubContinuous:
        beam_width = 1

        def __init__(self, load):
            self._load = load

        def load_factor(self):
            return self._load

    backend = TorchBackend(scheduler=None,
                         continuous_scheduler=StubContinuous(3.0))
    backend.cadence_alpha = 0.7
    backend._rt_ema["u1"] = 2.0
    assert backend.cadence_spacing_s("u1") == pytest.approx(1.4)
    assert backend.cadence_spacing_s("unknown-uid") == 0.0  # no history yet

    backend.continuous_scheduler._load = 1.0  # pool keeping up
    assert backend.cadence_spacing_s("u1") == 0.0

    backend.continuous_scheduler._load = 3.0
    backend.adaptive_cadence = False
    assert backend.cadence_spacing_s("u1") == 0.0

    # window-scheduler-only backends never space
    assert TorchBackend(scheduler=None).cadence_spacing_s("u1") == 0.0


def test_session_loop_honors_cadence_spacing():
    """When the backend's policy asks for spacing, the session loop holds
    the next submission (buffering audio meanwhile); with zero spacing it
    submits back-to-back."""
    import asyncio

    import numpy as np

    from whisperlive_tpu_torch.serving.server import ServeClient
    from whisperlive_tpu_torch.serving.session import SessionOptions

    class SpacedBackend:
        def __init__(self, spacing):
            self.spacing = spacing
            self.calls = 0

        def cadence_spacing_s(self, uid):
            return self.spacing

        async def transcribe(self, chunk, options, **kw):
            self.calls += 1
            # the real backend awaits the scheduler future; without a yield
            # here the zero-spacing loop would never cede the event loop
            await asyncio.sleep(0.01)
            from types import SimpleNamespace

            return SimpleNamespace(
                segments=[], language="en", language_prob=1.0,
                duration=len(chunk) / 16000.0, advance_s=0.0,
            )

    async def drive(spacing):
        backend = SpacedBackend(spacing)
        client = ServeClient(
            websocket=None, uid="cadence",
            options=SessionOptions(language="en", use_vad=False),
            backend=backend,
            send_json=None,
        )
        client.add_frames(np.zeros(32000, np.float32))
        client.start()
        try:
            await asyncio.sleep(1.0)
        finally:
            await client.cleanup()
        return backend.calls

    spaced = asyncio.run(drive(0.4))
    free = asyncio.run(drive(0.0))
    # 1 s / 0.4 s spacing => ~2-3 submissions; unspaced runs far more
    assert spaced <= 4, spaced
    assert free > 3 * spaced, (free, spaced)


# ---------------------------------------------------------------------------
# Diarization, translation and REST on the port's server
# ---------------------------------------------------------------------------


def _voice(seconds, f0, seed):
    t = np.arange(int(16000 * seconds)) / 16000.0
    rng = np.random.default_rng(seed)
    sig = sum(np.sin(2 * np.pi * k * f0 * t + rng.random()) / k ** 1.5 for k in range(1, 10))
    sig = sig * (0.6 + 0.4 * np.sin(2 * np.pi * 3.3 * t))
    return (0.1 * sig / np.abs(sig).max()).astype(np.float32)


def _stream(port, audio, **kwargs):
    """Stream `audio` in real time; returns (committed segments, translated
    segments) once a few commits arrived."""
    from whisperlive_tpu_torch.client import StreamingTranscriptionClient

    committed, translated = [], []
    client = StreamingTranscriptionClient(
        "127.0.0.1", port, lang="en", use_vad=False, same_output_threshold=2,
        on_committed=committed.append, on_translation=translated.extend, **kwargs)
    for off in range(0, len(audio), 8000):
        client.send_array(audio[off: off + 8000])
        time.sleep(0.05)
    deadline = time.time() + 20
    while len(committed) < 2 and time.time() < deadline:
        time.sleep(0.1)
    if kwargs.get("enable_translation"):
        while len(translated) < len(committed) and time.time() < deadline:
            time.sleep(0.1)
    client.close(wait_for_server=False)
    return committed, translated


def test_diarized_session_labels_segments():
    """A slow backend lets the tail grow past one segment, so segments
    commit as finished (labelled) and not only by repetition (unlabelled,
    as in the reference)."""
    audio = np.concatenate([_voice(3.0, 120, 0), _voice(3.0, 260, 1)])
    with ServerHarness(backend=FakeBackend(latency_s=0.5)) as h:
        committed, _ = _stream(h.port, audio, enable_diarization=True, max_speakers=2)
    labels = [seg["speaker"] for seg in committed if "speaker" in seg]
    assert len(labels) >= 2
    assert set(labels) <= {"SPEAKER_0", "SPEAKER_1"}


def test_translated_session_through_translator_factory():
    from whisperlive_tpu_torch.translation import TranslationWorker

    class Upper:
        def translate(self, text, target_language):
            return f"[{target_language}]{text.upper()}"

    def factory(client, target_language):
        return TranslationWorker(client, target_language, Upper(), send_original=True)

    with ServerHarness(translator_factory=factory) as h:
        committed, translated = _stream(h.port, _voice(4.0, 150, 2), enable_translation=True,
                                        target_language="de")
    assert committed and len(translated) >= len(committed)
    by_original = {seg["original_text"]: seg["text"] for seg in translated}
    for seg in committed:
        assert by_original[seg["text"]] == f"[de]{seg['text'].upper()}"


def test_translated_session_without_model_dir_passes_through():
    with ServerHarness() as h:
        committed, translated = _stream(h.port, _voice(3.0, 150, 3), enable_translation=True,
                                        target_language="fr")
    assert committed and translated
    assert {s["text"] for s in committed} <= {s["text"] for s in translated}


def test_serve_starts_the_rest_listener():
    rest_port = _free_port()
    with ServerHarness(rest_port=rest_port, rest_kwargs={"rate_limit_rpm": 5}):
        deadline = time.time() + 10
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{rest_port}/health",
                                            timeout=2) as r:
                    assert json.loads(r.read()) == {"status": "ok"}
                    break
            except OSError:
                assert time.time() < deadline, "REST listener did not start"
                time.sleep(0.1)
        boundary = "b0und"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"response_format\""
                f"\r\n\r\ntext\r\n--{boundary}\r\nContent-Disposition: form-data; "
                f"name=\"file\"; filename=\"a.raw\"\r\n\r\n").encode()
        body += np.zeros(16000 * 2, np.float32).tobytes() + f"\r\n--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{rest_port}/v1/audio/transcriptions", data=body, method="POST",
            headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.read().decode() == "word0 word1"
    # the listener is cleaned up with the server
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{rest_port}/health", timeout=2)


# ---------------------------------------------------------------------------
# The cases of tests/test_client.py on the port's client
# ---------------------------------------------------------------------------


@pytest.fixture()
def client():
    with mock.patch("websocket.WebSocketApp") as ws_app:
        from whisperlive_tpu_torch.client.client import Client

        c = Client("localhost", 9090, lang="en", model="tiny",
                    log_transcription=False)
        c._ws_app_cls = ws_app
        yield c
        c._closing = True


def test_handshake_payload(client):
    client.on_open(client.client_socket)
    payload = json.loads(client.client_socket.send.call_args[0][0])
    assert payload["uid"] == client.uid
    assert payload["language"] == "en"
    assert payload["task"] == "transcribe"
    assert payload["model"] == "tiny"
    assert "use_vad" in payload and "same_output_threshold" in payload


def test_server_ready_flips_recording(client):
    msg = json.dumps({"uid": client.uid, "message": "SERVER_READY", "backend": "tpu"})
    client.on_message(None, msg)
    assert client.recording is True
    assert client.server_backend == "tpu"


def test_wrong_uid_ignored(client):
    msg = json.dumps({"uid": "other", "message": "SERVER_READY"})
    client.on_message(None, msg)
    assert client.recording is False


def test_segments_accumulate_and_dedup(client):
    client.server_backend = "tpu"
    seg = {"start": "0.000", "end": "1.000", "text": " a", "completed": True}
    partial = {"start": "1.000", "end": "1.500", "text": " b", "completed": False}
    msg = json.dumps({"uid": client.uid, "segments": [seg, partial]})
    client.on_message(None, msg)
    client.on_message(None, msg)  # duplicate delivery
    assert client.transcript == [seg]
    assert client.last_segment == partial


def test_language_detection_message(client):
    msg = json.dumps({"uid": client.uid, "language": "de", "language_prob": 0.9})
    client.on_message(None, msg)
    assert client.language == "de"


def test_translation_callback():
    with mock.patch("websocket.WebSocketApp"):
        from whisperlive_tpu_torch.client.client import Client

        got = []
        c = Client("localhost", 9090, log_transcription=False,
                    translation_callback=got.append)
        seg = {"start": "0.000", "end": "1.000", "text": "bonjour", "completed": True}
        c.on_message(None, json.dumps({"uid": c.uid, "translated_segments": [seg]}))
        assert got == [[seg]]
        assert c.translated_transcript == [seg]
        c._closing = True


def test_disconnect_message_stops_recording(client):
    client.recording = True
    client._closing = True  # avoid reconnect timer in tests
    client.on_message(None, json.dumps({"uid": client.uid, "message": "DISCONNECT"}))
    assert client.recording is False


def test_status_error_sets_flag(client):
    client.on_message(None, json.dumps(
        {"uid": client.uid, "status": "ERROR", "message": "boom"}))
    assert client.server_error is True


def test_reconnect_on_unexpected_drop():
    with mock.patch("websocket.WebSocketApp"):
        from whisperlive_tpu_torch.client.client import Client

        c = Client("localhost", 9090, log_transcription=False,
                    max_retries=2, retry_delay=0.05)
        c.recording = True
        with mock.patch.object(c, "_connect") as reconnect:
            c.on_close(None, 1006, "abnormal")
            time.sleep(0.2)
            assert reconnect.called
            assert c._retries_left == 1
        c._closing = True


def test_no_reconnect_after_server_error():
    with mock.patch("websocket.WebSocketApp"):
        from whisperlive_tpu_torch.client.client import Client

        c = Client("localhost", 9090, log_transcription=False,
                    max_retries=2, retry_delay=0.05)
        c.recording = True
        c.server_error = True
        with mock.patch.object(c, "_connect") as reconnect:
            c.on_close(None, 1006, "abnormal")
            time.sleep(0.2)
            assert not reconnect.called
        c._closing = True


def test_no_reconnect_after_clean_close():
    with mock.patch("websocket.WebSocketApp"):
        from whisperlive_tpu_torch.client.client import Client

        c = Client("localhost", 9090, log_transcription=False, max_retries=2)
        c.recording = True
        with mock.patch.object(c, "_connect") as reconnect:
            c.close_websocket()
            c.on_close(None, 1000, "bye")
            time.sleep(0.1)
            assert not reconnect.called


def test_write_srt(tmp_path, client):
    client.server_backend = "tpu"
    client.transcript = [
        {"start": "0.000", "end": "1.000", "text": " hi", "completed": True}
    ]
    client.last_segment = {"start": "1.000", "end": "2.000", "text": " there",
                           "completed": False}
    path = str(tmp_path / "out.srt")
    client.write_srt_file(path)
    content = open(path).read()
    assert "hi" in content and "there" in content and "-->" in content


def _tee(n=2):
    from whisperlive_tpu_torch.client.client import Client, TranscriptionTeeClient

    with mock.patch("websocket.WebSocketApp"):
        clients = [Client("localhost", 9090, log_transcription=False) for _ in range(n)]
        for c in clients:
            c.send_packet_to_server = mock.MagicMock()
            c._closing = True
        tee = TranscriptionTeeClient(clients)
        return tee, clients


def test_tee_multicast_conditional_on_recording():
    tee, clients = _tee()
    clients[0].recording = True
    clients[1].recording = False
    tee.multicast_packet(b"pcm")
    clients[0].send_packet_to_server.assert_called_once_with(b"pcm")
    clients[1].send_packet_to_server.assert_not_called()


def test_tee_multicast_unconditional():
    tee, clients = _tee()
    for c in clients:
        c.recording = False
    tee.multicast_packet(b"END_OF_AUDIO", unconditional=True)
    for c in clients:
        c.send_packet_to_server.assert_called_once()


def test_tee_requires_clients():
    from whisperlive_tpu_torch.client.client import TranscriptionTeeClient

    with pytest.raises(Exception):
        TranscriptionTeeClient([])


def test_tee_srt_paths_per_client(tmp_path):
    tee, clients = _tee(2)
    for i, c in enumerate(clients):
        c.server_backend = "tpu"
        c.srt_file_path = str(tmp_path / "out.srt")
        c.transcript = [{"start": "0.000", "end": "1.000",
                         "text": f"c{i}", "completed": True}]
        c.last_segment = None
    tee.write_all_clients_srt()
    assert (tmp_path / "out_0.srt").exists()
    assert (tmp_path / "out_1.srt").exists()
    assert "c0" in (tmp_path / "out_0.srt").read_text()
    assert "c1" in (tmp_path / "out_1.srt").read_text()


def test_print_transcript_timestamps_mode(capsys):
    """--timestamps rendering: '[start -> end] text' with wrapped
    continuation lines indented under the text column (utils.py:15-35)."""
    from whisperlive_tpu_torch.utils.text import print_transcript

    segs = [
        {"start": "0.000", "end": "2.500", "text": "hello there"},
        {"start": "2.500", "end": "5.000", "text": "x " * 60},
    ]
    print_transcript(segs, timestamps=True, max_lines=10)
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0].startswith("[0.000 -> 2.500] hello there")
    assert any(line.startswith("[2.500 -> 5.000] ") for line in lines)
    # wrapped continuations are indented
    cont = [l for l in lines if l.startswith(" " * 10)]
    assert cont, "long text should wrap with indent"


def test_client_timestamps_display(capsys):
    """Client with enable_timestamps renders segment boundaries."""
    with mock.patch("websocket.WebSocketApp"):
        from whisperlive_tpu_torch.client.client import Client

        c = Client("localhost", 9090, lang="en", enable_timestamps=True,
                   n_display_segments=5)
        c.process_segments([
            {"start": "0.000", "end": "1.000", "text": "one", "completed": True},
            {"start": "1.000", "end": "2.000", "text": "two", "completed": False},
        ])
        out = capsys.readouterr().out
        assert "[0.000 -> 1.000] one" in out
        assert "[1.000 -> 2.000] two" in out


# ---------------------------------------------------------------------------
# Parity with the JAX package: the port's client and server against the
# originals they were copied from, fed the same script
# ---------------------------------------------------------------------------


_CLIENT_SCRIPT = [
    {"message": "SERVER_READY", "backend": "tpu"},
    {"language": "en", "language_prob": 0.93},
    {"status": "WARNING", "message": "server is running model 'tiny'"},
    {"segments": [{"start": "0.000", "end": "1.000", "text": " one", "completed": True},
                  {"start": "1.000", "end": "1.400", "text": " tw", "completed": False}]},
    {"segments": [{"start": "0.000", "end": "1.000", "text": " one", "completed": True},
                  {"start": "1.000", "end": "1.400", "text": " tw", "completed": False}]},
    {"segments": [{"start": "0.000", "end": "1.000", "text": " one", "completed": True},
                  {"start": "1.000", "end": "2.000", "text": " two", "completed": True,
                   "speaker": "SPEAKER_1"},
                  {"start": "2.000", "end": "2.700", "text": " thr", "completed": False}]},
    {"segments": [{"start": "0.500", "end": "0.900", "text": " stale", "completed": True},
                  {"start": "2.000", "end": "3.000", "text": " three", "completed": True}]},
    {"translated_segments": [{"start": "0.000", "end": "1.000", "text": "un",
                              "completed": True}]},
    {"translated_segments": [{"start": "1.000", "end": "2.000", "text": "deux",
                              "completed": True, "original_text": " two"}]},
    {"language": "fr", "language_prob": 0.51},
    {"status": "ERROR", "message": "boom"},
]


def _drive_client(client_module, tmp_path, mode, capsys):
    """Run one client through the handshake, `_CLIENT_SCRIPT`, a message for
    another uid, a short WAV played through the tee, a DISCONNECT and the
    close; return everything the client sent, kept, wrote and printed."""
    from whisperlive_tpu_torch.audio.io import write_wav

    wav = tmp_path / "in.wav"
    if not wav.exists():
        write_wav(str(wav), _voice(0.6, 140, 7))
    srt = tmp_path / f"{client_module.__name__}.srt"
    callbacks = []
    kwargs = {"enable_timestamps": mode == "timestamps", "n_display_segments": 2}
    if mode == "callback":
        kwargs["transcription_callback"] = lambda text, segs: callbacks.append((text, segs))
    with mock.patch("websocket.WebSocketApp"):
        c = client_module.Client(
            "localhost", 9090, lang="en", model="tiny", srt_file_path=str(srt),
            translation_callback=lambda segs: callbacks.append(segs),
            enable_translation=True, target_language="fr", enable_diarization=True,
            max_speakers=2, hotwords="alpha", initial_prompt="Hi.", **kwargs)
        c.uid = "parity-uid"
        c.disconnect_if_no_response_for = 0
        ws = c.client_socket
        c.on_open(ws)
        for msg in _CLIENT_SCRIPT:
            c.on_message(ws, json.dumps({"uid": c.uid, **msg}))
        c.on_message(ws, json.dumps({"uid": "other", "segments": _CLIENT_SCRIPT[3]["segments"]}))
        c.server_error = False
        tee = client_module.TranscriptionTeeClient([c])
        tee.chunk = 4000
        tee.play_file(str(wav))
        c.on_message(ws, json.dumps({"uid": c.uid, "message": "DISCONNECT"}))
        c.on_close(ws, 1000, "bye")
    return {
        "sent": [call.args for call in ws.send.call_args_list],
        "closed": ws.close.call_count,
        "state": {k: getattr(c, k) for k in (
            "transcript", "translated_transcript", "last_segment", "language",
            "recording", "waiting", "server_error", "server_backend",
            "last_received_segment")},
        "callbacks": callbacks,
        "srt": srt.read_bytes(),
        "stdout": capsys.readouterr().out,
    }


@pytest.mark.parametrize("mode", ["print", "timestamps", "callback"])
def test_client_matches_the_jax_client(tmp_path, capsys, mode):
    """The port's client and the JAX package's client, fed the same socket
    events, send the same frames (handshake, audio, END_OF_AUDIO) and end
    with the same transcript, translations, SRT bytes and printed text."""
    from whisperlive_tpu.client import client as jax_client
    from whisperlive_tpu_torch.client import client as torch_client

    ref = _drive_client(jax_client, tmp_path, mode, capsys)
    got = _drive_client(torch_client, tmp_path, mode, capsys)
    assert len(ref["sent"]) > 3 and ref["sent"][-1][0] == b"END_OF_AUDIO"
    assert got == ref


class _Closed(Exception):
    """Named like websockets' ConnectionClosed: the server's receive loop
    takes it as the end of the connection."""


class _LockstepBackend:
    """A backend whose every transcription waits for its turn, so that audio
    arrival and decoding interleave the same way on every run."""

    def __init__(self, inner):
        self.inner = inner
        self.turn = asyncio.Event()
        self.done = asyncio.Event()
        self.calls = 0

    async def transcribe(self, chunk, options, **kwargs):
        await self.turn.wait()
        self.turn.clear()
        try:
            return await self.inner.transcribe(chunk, options, **kwargs)
        finally:
            self.calls += 1
            self.done.set()


class _ScriptedSocket:
    """A websocket that gives the server a handshake, audio frames and
    END_OF_AUDIO, with one decode between frames; then lets the session run
    dry, waits for the translations, and closes. Records what was sent."""

    def __init__(self, handshake, frames, backend, clients):
        self.script = [json.dumps(handshake), *frames, b"END_OF_AUDIO"]
        self.backend = backend
        self.clients = clients
        self.sent = []
        self.next = 0

    async def _one_decode(self) -> bool:
        self.backend.done.clear()
        self.backend.turn.set()
        try:
            await asyncio.wait_for(self.backend.done.wait(), timeout=0.5)
            return True
        except asyncio.TimeoutError:
            self.backend.turn.clear()
            return False

    async def recv(self):
        if self.next >= 2:
            await self._one_decode()
        if self.next < len(self.script):
            self.next += 1
            return self.script[self.next - 1]
        for _ in range(40):
            if not await self._one_decode():
                break
        worker = self.clients.get_client(self).translator
        deadline = time.time() + 3
        while worker is not None and time.time() < deadline:
            done = sum(len(m.get("translated_segments", [])) for m in self.sent)
            if done == worker.queue.unfinished_tasks:
                break
            await asyncio.sleep(0.01)
        raise _Closed()

    async def send(self, text):
        self.sent.append(json.loads(text))

    async def close(self, *args):
        pass


class _Upper:
    def translate(self, text, target_language):
        return f"[{target_language}]{text.upper()}"


def _serve_scripted(server_module, backends_module, translation_module, handshake, audio,
                    use_factory):
    server = server_module.TranscriptionServer()
    server.client_manager = server_module.ClientManager(4, 600)
    server.backend = _LockstepBackend(backends_module.FakeBackend())
    if use_factory:
        server.translator_factory = lambda client, lang: translation_module.TranslationWorker(
            client, lang, _Upper(), send_original=True)
    frames = [audio[off: off + 24000].tobytes() for off in range(0, len(audio), 24000)]

    async def run():
        ws = _ScriptedSocket(handshake, frames, server.backend, server.client_manager)
        await server.recv_audio(ws)
        return ws.sent, server.backend.calls

    sent, calls = asyncio.run(run())
    translated = [seg for m in sent for seg in m.get("translated_segments", [])]
    return [m for m in sent if "translated_segments" not in m], translated, calls


@pytest.mark.parametrize("session", ["diarized", "translated_factory", "translated_default"])
def test_server_wire_matches_the_jax_server(session):
    """One session through the JAX package's server and the port's, each
    with its own FakeBackend, diarizer and translation worker: the same
    audio in the same frames gives the same messages on the wire."""
    from whisperlive_tpu import translation as jax_translation
    from whisperlive_tpu.serving import backends as jax_backends
    from whisperlive_tpu.serving import server as jax_server
    from whisperlive_tpu_torch import translation as torch_translation
    from whisperlive_tpu_torch.serving import backends as torch_backends
    from whisperlive_tpu_torch.serving import server as torch_server

    handshake = {"uid": "wire", "language": "en", "use_vad": False,
                 "same_output_threshold": 2}
    if session == "diarized":
        handshake.update(enable_diarization=True, max_speakers=2)
        audio = np.concatenate([_voice(4.5, 110, 0), _voice(4.5, 240, 1)])
    else:
        handshake.update(enable_translation=True,
                         target_language="fr")
        audio = _voice(6.0, 150, 2)

    use_factory = session == "translated_factory"
    ref = _serve_scripted(jax_server, jax_backends, jax_translation, handshake, audio,
                          use_factory)
    got = _serve_scripted(torch_server, torch_backends, torch_translation, handshake, audio,
                          use_factory)
    messages, translated, calls = ref
    assert calls > len(audio) // 24000
    committed = [s for m in messages for s in m.get("segments", []) if s["completed"]]
    assert committed
    if session == "diarized":
        assert {s.get("speaker") for s in committed} >= {"SPEAKER_0", "SPEAKER_1"}
    else:
        assert {s["text"] for s in translated} >= {
            f"[fr]{s['text'].upper()}" if use_factory else s["text"]
            for s in committed}
    assert got == ref
