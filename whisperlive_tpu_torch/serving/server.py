"""Asyncio WebSocket transcription server (wire-compatible with the
reference's whisper_live/server.py protocol).

Architectural difference from the reference, driven by the TPU serving
model: the reference runs one OS thread per connection plus one
transcription thread per client (server.py:439-488, backend/*:121-122) —
fine for max_clients=4 on a GPU with a lock. Here sessions are asyncio
tasks: the receive loop and the transcription loop are coroutines, and all
device work funnels through the single BatchScheduler thread, so hundreds
of concurrent streams cost one Python thread total plus the device batch.

Wire protocol (byte-compatible, SURVEY §2 "WebSocket wire protocol"):
  client -> server : JSON handshake options, then binary PCM frames,
                     literal b"END_OF_AUDIO" to finish
  server -> client : {"uid", "status": WAIT|ERROR|WARNING, "message"},
                     {"uid", "message": "SERVER_READY", "backend"},
                     {"uid", "language", "language_prob"},
                     {"uid", "segments": [...]},
                     {"uid", "message": "DISCONNECT"}

The port's copy of whisperlive_tpu/serving/server.py. The websockets and
aiohttp imports stay lazy (inside serve() and the REST module's
start_rest_server), so the connection handler runs without either package.
"""

from __future__ import annotations

import asyncio
import functools
import json
import logging
import time
import uuid
from typing import Any, Optional

import numpy as np

from whisperlive_tpu_torch.audio.io import bytes_to_float_array
from whisperlive_tpu_torch.serving.session import (
    SAMPLE_RATE,
    SessionOptions,
    StreamingSession,
)
from whisperlive_tpu_torch.utils import metrics as wl_metrics
from whisperlive_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

END_OF_AUDIO = b"END_OF_AUDIO"
MIN_CHUNK_S = 1.0  # minimum tail before a decode is scheduled (base.py:118)
POLL_S = 0.1


class ClientManager:
    """Tracks active sessions, capacity and connection-time limits
    (server.py:45-158)."""

    def __init__(self, max_clients: int = 4, max_connection_time: float = 600.0):
        self.max_clients = max_clients
        self.max_connection_time = max_connection_time
        self.clients: dict[Any, Any] = {}
        self.start_times: dict[Any, float] = {}

    def add_client(self, websocket, client) -> None:
        self.clients[websocket] = client
        self.start_times[websocket] = time.time()

    def get_client(self, websocket):
        return self.clients.get(websocket, False)

    def remove_client(self, websocket) -> None:
        self.clients.pop(websocket, None)
        self.start_times.pop(websocket, None)

    def get_wait_time(self) -> float:
        """Estimated minutes until a slot frees (server.py:117-131)."""
        if not self.start_times:
            return 0.0
        remaining = [
            self.max_connection_time - (time.time() - t)
            for t in self.start_times.values()
        ]
        return max(0.0, min(remaining)) / 60.0

    def is_server_full(self) -> bool:
        return len(self.clients) >= self.max_clients

    def is_client_timeout(self, websocket) -> bool:
        start = self.start_times.get(websocket)
        if start is None:
            return False
        return (time.time() - start) >= self.max_connection_time


class ServeClient:
    """One connected stream: session state + async transcription loop.

    The asyncio analogue of ServeClientBase/ServeClientFasterWhisper: audio
    arrives via `add_frames`, a background task repeatedly submits the
    un-committed tail to the backend and pushes segment updates.
    """

    SERVER_READY = "SERVER_READY"
    DISCONNECT = "DISCONNECT"

    def __init__(
        self,
        websocket,
        uid: str,
        options: SessionOptions,
        backend,
        backend_name: str = "tpu",
        send_json=None,
    ):
        self.websocket = websocket
        self.uid = uid
        self.options = options
        self.backend = backend
        self.backend_name = backend_name
        self.session = StreamingSession(options)
        self.language: Optional[str] = options.language
        self.language_pushed = options.language is not None
        self.previous_tokens: list[int] = []
        self.exit = False
        self.eos = False
        self._task: Optional[asyncio.Task] = None
        self._new_audio = asyncio.Event()
        self._send_json = send_json
        self.translator = None  # attached by the server when enabled

    # ------------------------------------------------------------------

    def add_frames(self, frames: np.ndarray) -> None:
        with profiling.span("session.add_frames"):
            self.session.add_frames(frames)
        self._new_audio.set()

    def set_eos(self, eos: bool = True) -> None:
        self.eos = eos
        self._new_audio.set()

    async def send(self, payload: dict) -> None:
        if self._send_json is not None:
            await self._send_json(payload)
            return
        try:
            await self.websocket.send(json.dumps(payload))
        except Exception:
            logger.warning("[%s] failed to send to client", self.uid)

    async def send_ready(self) -> None:
        await self.send(
            {"uid": self.uid, "message": self.SERVER_READY, "backend": self.backend_name}
        )

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self.speech_to_text())

    async def cleanup(self) -> None:
        self.exit = True
        self._new_audio.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        if self.translator is not None:
            await self.translator.stop()
        # drop per-stream backend state (e.g. the VAD instance keyed by uid)
        release = getattr(self.backend, "release", None)
        if release is not None:
            release(self.uid)

    # ------------------------------------------------------------------

    async def speech_to_text(self) -> None:
        """The per-stream hot loop (async port of base.py:88-137)."""
        last_submit = 0.0
        while not self.exit:
            # Adaptive cadence (backend policy): when the decode pool is
            # saturated, space submissions so the wait happens HERE (new
            # audio keeps buffering) instead of in the scheduler queue —
            # the next window then covers more audio and returns fast.
            spacing_fn = getattr(self.backend, "cadence_spacing_s", None)
            if spacing_fn is not None and not self.eos:
                hold = spacing_fn(self.uid) - (time.monotonic() - last_submit)
                if hold > 0:
                    await asyncio.sleep(min(hold, 1.0))
                    continue
            duration = self.session.buffered_duration()
            if duration < MIN_CHUNK_S and not (self.eos and duration > 0):
                self._new_audio.clear()
                try:
                    await asyncio.wait_for(self._new_audio.wait(), timeout=POLL_S * 5)
                except asyncio.TimeoutError:
                    pass
                continue

            with profiling.span("session.chunk"):
                chunk, chunk_dur = self.session.get_audio_chunk_for_processing()
            if chunk_dur < MIN_CHUNK_S and not self.eos:
                await asyncio.sleep(POLL_S)
                continue
            if chunk_dur == 0.0:
                if self.eos:
                    await asyncio.sleep(POLL_S)
                continue

            try:
                t0 = time.monotonic()
                last_submit = t0
                result = await self.backend.transcribe(
                    chunk,
                    self.options,
                    language=self.language,
                    previous_tokens=self.previous_tokens,
                    uid=self.uid,
                    # the tail anchor: while it is unchanged (no commit),
                    # successive windows extend the same audio, enabling
                    # the backend's incremental-prefix decode
                    window_anchor_s=self.session.timestamp_offset,
                    # late-bound audio: if the request queues, decode the
                    # tail as buffered at slot-grant time, not at submit
                    refresh_audio=functools.partial(
                        self.session.peek_tail, self.session.timestamp_offset
                    ),
                )
                wl_metrics.track_transcription_latency(time.monotonic() - t0)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("[%s] transcription failed", self.uid)
                wl_metrics.track_error("transcription")
                await asyncio.sleep(POLL_S)
                continue
            if result is None:
                # VAD-gated silence: nothing was decoded and the tail was
                # not consumed, so this branch can recur immediately. The
                # sleep is LOAD-BEARING: backend.transcribe returns None
                # synchronously (no internal await), and a bare `continue`
                # would spin this coroutine without ever yielding — seizing
                # the event loop and starving every other connection
                # (handshakes, closes, all sessions) until new audio
                # changes the VAD verdict.
                await asyncio.sleep(POLL_S)
                continue

            if not self.language_pushed and result.language:
                self.language = result.language
                self.language_pushed = True
                await self.send(
                    {
                        "uid": self.uid,
                        "language": result.language,
                        "language_prob": result.language_prob,
                    }
                )

            rid = getattr(result, "rid", 0)
            with profiling.span("session.update", rid=rid):
                last_segment = self.session.update_segments(
                    result.segments, result.duration
                )
                # carry decoded tokens for conditioning the next window
                for s in result.segments:
                    self.previous_tokens.extend(
                        t for t in getattr(s, "tokens", []) if t < 50_000
                    )
                self.previous_tokens = self.previous_tokens[-224:]
                segments = self.session.prepare_segments(last_segment)
            if segments:
                wl_metrics.track_segments(
                    sum(1 for s in segments if s.get("completed")), True
                )
                await self.send({"uid": self.uid, "segments": segments})
                resolved = getattr(result, "resolved_ns", 0)
                if resolved:
                    # the update's hand-back: from the scheduler thread's
                    # resolve to the push's return on this loop; its content
                    # age runs from the decoded audio's capture to here
                    pushed = time.monotonic_ns()
                    profiling.record_span(
                        "request.push", resolved, pushed, rid=rid,
                        content_age_s=pushed / 1e9 - result.audio_bound_at)
            if self.translator is not None:
                self.translator.poke()


class TranscriptionServer:
    """Accepts WebSocket connections and routes them to sessions
    (asyncio port of whisper_live/server.py TranscriptionServer)."""

    def __init__(self):
        self.client_manager: Optional[ClientManager] = None
        self.backend = None
        self.backend_name = "tpu"
        self.api_key: Optional[str] = None
        self.raw_pcm_default = "float32"
        self.translator_factory = None
        self.diarizer = None
        self.translation_model_dir: Optional[str] = None
        self._shutdown: Optional[asyncio.Event] = None

    def request_shutdown(self) -> None:
        """Ask a running serve() to exit cleanly. Must run on the serving
        loop — from another thread use loop.call_soon_threadsafe."""
        if self._shutdown is not None:
            self._shutdown.set()

    # ------------------------------------------------------------------

    def _auth_ok(self, websocket) -> bool:
        """Bearer header or ?token= query param (server.py:34-42)."""
        if not self.api_key:
            return True
        try:
            headers = websocket.request.headers
            auth = headers.get("Authorization", "")
            if auth == f"Bearer {self.api_key}":
                return True
            path = websocket.request.path or ""
            if f"token={self.api_key}" in path.split("?", 1)[-1]:
                return True
        except Exception:
            pass
        return False

    async def handle_new_connection(self, websocket) -> Optional[ServeClient]:
        try:
            raw = await asyncio.wait_for(websocket.recv(), timeout=30)
            opts_json = json.loads(raw)
        except asyncio.TimeoutError:
            logger.warning("handshake timeout")
            return None
        except (json.JSONDecodeError, Exception) as e:
            logger.warning("bad handshake: %s", e)
            return None

        uid = opts_json.get("uid") or str(uuid.uuid4())

        # Capacity WAIT: hard client cap (reference server.py:117-139), or
        # sustained engine oversubscription — the continuous scheduler's
        # load EMA — which would otherwise collapse every session's update
        # cadence rather than reject anyone.
        wait_minutes: Optional[float] = None
        if self.client_manager.is_server_full():
            wait_minutes = self.client_manager.get_wait_time()
        else:
            sched = getattr(self.backend, "continuous_scheduler", None)
            if sched is not None and getattr(sched, "overloaded", None):
                if sched.overloaded():
                    wait_minutes = max(sched.estimated_wait_s() / 60.0, 0.1)
        if wait_minutes is not None:
            wl_metrics.track_connection_rejected()
            await websocket.send(
                json.dumps(
                    {"uid": uid, "status": "WAIT", "message": wait_minutes}
                )
            )
            return None

        options = SessionOptions(
            language=opts_json.get("language"),
            task=opts_json.get("task", "transcribe"),
            model=opts_json.get("model", "small"),
            use_vad=opts_json.get("use_vad", True),
            send_last_n_segments=opts_json.get("send_last_n_segments", 10),
            no_speech_thresh=opts_json.get("no_speech_thresh", 0.45),
            clip_audio=opts_json.get("clip_audio", False),
            same_output_threshold=opts_json.get("same_output_threshold", 10),
            enable_translation=opts_json.get("enable_translation", False),
            target_language=opts_json.get("target_language"),
            hotwords=opts_json.get("hotwords"),
            enable_diarization=opts_json.get("enable_diarization", False),
            max_speakers=opts_json.get("max_speakers", 4),
            word_timestamps=opts_json.get("word_timestamps", False),
            initial_prompt=opts_json.get("initial_prompt"),
            vad_parameters=opts_json.get("vad_parameters"),
        )
        audio_format = opts_json.get("audio_format", self.raw_pcm_default)
        if audio_format not in ("float32", "int16", "uint8"):
            audio_format = "float32"

        # The engine serves ONE model; a client asking for a different size
        # gets a WARNING (the reference's single-model mode does the same,
        # faster_whisper_backend.py:100-105 + server WARNING path).
        served_model = getattr(self.backend, "model_name", None)
        if served_model and options.model not in (served_model, "small"):
            await websocket.send(
                json.dumps(
                    {
                        "uid": uid,
                        "status": "WARNING",
                        "message": f"server is running model '{served_model}'; "
                        f"ignoring requested model '{options.model}'",
                    }
                )
            )

        client = ServeClient(
            websocket,
            uid=uid,
            options=options,
            backend=self.backend,
            backend_name=self.backend_name,
        )
        client.audio_format = audio_format
        if options.enable_diarization:
            from whisperlive_tpu_torch.diarization import SpeakerDiarizer

            diarizer = SpeakerDiarizer(max_speakers=options.max_speakers)
            client.session.speaker_identifier = diarizer.make_identifier()
            client.diarizer = diarizer
        if options.enable_translation:
            if self.translator_factory is not None:
                client.translator = self.translator_factory(
                    client, options.target_language
                )
            else:
                from whisperlive_tpu_torch.translation import (
                    TranslationWorker,
                    make_translator,
                )

                client.translator = TranslationWorker(
                    client,
                    options.target_language,
                    make_translator(self.translation_model_dir),
                )
            client.session.translation_queue = client.translator.queue
        self.client_manager.add_client(websocket, client)
        wl_metrics.track_connection_accepted()
        wl_metrics.set_active_streams(len(self.client_manager.clients))
        client.start()
        await client.send_ready()
        return client

    async def recv_audio(self, websocket) -> None:
        """Per-connection receive loop (server.py:439-488)."""
        if not self._auth_ok(websocket):
            try:
                await websocket.close(1008, "invalid token")
            finally:
                return

        client = await self.handle_new_connection(websocket)
        if client is None:
            await websocket.close()
            return

        try:
            while not self.client_manager.is_client_timeout(websocket):
                try:
                    frame = await asyncio.wait_for(websocket.recv(), timeout=5.0)
                except asyncio.TimeoutError:
                    continue
                if isinstance(frame, str):
                    frame = frame.encode("utf-8")
                if frame == END_OF_AUDIO:
                    client.set_eos(True)
                    continue
                audio = bytes_to_float_array(frame, client.audio_format)
                client.add_frames(audio)
            else:
                await client.send({"uid": client.uid, "message": ServeClient.DISCONNECT})
        except Exception as e:
            name = type(e).__name__
            if "Closed" not in name:
                logger.warning("connection error: %s", e)
        finally:
            await client.cleanup()
            self.client_manager.remove_client(websocket)
            wl_metrics.track_connection_closed()
            wl_metrics.set_active_streams(len(self.client_manager.clients))

    # ------------------------------------------------------------------

    async def serve(
        self,
        backend,
        host: str = "0.0.0.0",
        port: int = 9090,
        backend_name: str = "tpu",
        max_clients: int = 4,
        max_connection_time: float = 600.0,
        api_key: Optional[str] = None,
        metrics_port: Optional[int] = None,
        rest_port: Optional[int] = None,
        rest_kwargs: Optional[dict] = None,
        translator_factory=None,
        diarizer=None,
        ready_event: Optional[asyncio.Event] = None,
    ) -> None:
        """Run the server forever (async analogue of server.py:600-887)."""
        from websockets.asyncio.server import serve as ws_serve

        self.backend = backend
        self.backend_name = backend_name
        self.api_key = api_key
        self.translator_factory = translator_factory
        self.diarizer = diarizer
        self.client_manager = ClientManager(max_clients, max_connection_time)

        if metrics_port:
            wl_metrics.start_metrics_server(metrics_port)

        rest_runner = None
        if rest_port:
            from whisperlive_tpu_torch.serving.rest import start_rest_server

            rest_runner = await start_rest_server(
                backend=backend, port=rest_port, **(rest_kwargs or {})
            )

        self._shutdown = asyncio.Event()
        async with ws_serve(self.recv_audio, host, port, max_size=2**24) as server:
            logger.info("WebSocket server listening on %s:%d", host, port)
            if ready_event is not None:
                ready_event.set()
            try:
                # Wait on an explicit shutdown signal rather than
                # serve_forever(): a stopped-then-closed event loop would
                # otherwise leave the serve_forever future pending and leak
                # an unraisable "Event loop is closed" at teardown.
                await self._shutdown.wait()
            finally:
                server.close()
                if rest_runner is not None:
                    await rest_runner.cleanup()

    def run(self, *args, **kwargs) -> None:
        """Blocking entry point (matches TranscriptionServer.run)."""
        asyncio.run(self.serve(*args, **kwargs))
