"""Python client library — same public API and wire behavior as the
reference's whisper_live/client.py (SURVEY §2.13), reimplemented for this
framework:

  Client                        low-level WS client: handshake, segment
                                accumulation, SRT output, reconnect
  TranscriptionTeeClient        fan-out to N servers; mic/file sources
  TranscriptionClient           single-server facade; __call__ returns text
  StreamingTranscriptionClient  push-mode API with on_partial/on_committed
                                callbacks

Differences: PyAudio/PyAV sources are optional imports (mic and RTSP/HLS
raise a clear error if absent); file playback decodes WAV natively.

The port's copy of whisperlive_tpu/client/client.py; `websocket`, `pyaudio`
and `av` stay imports inside the functions that need them.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from typing import Callable, Optional

import numpy as np

from whisperlive_tpu_torch.audio.io import (
    SAMPLE_RATE,
    bytes_to_float_array,
    load_audio,
    resample_audio,
    write_wav,
)
from whisperlive_tpu_torch.utils.text import create_srt_file, print_transcript

logger = logging.getLogger(__name__)

END_OF_AUDIO = b"END_OF_AUDIO"


class Client:
    """Low-level WebSocket transcription client (client.py:25-439)."""

    INSTANCES: dict = {}
    END_OF_AUDIO = "END_OF_AUDIO"

    def __init__(
        self,
        host: str,
        port: int,
        lang: Optional[str] = None,
        translate: bool = False,
        model: str = "small",
        srt_file_path: str = "output.srt",
        use_vad: bool = True,
        use_wss: bool = False,
        log_transcription: bool = True,
        max_clients: int = 4,
        max_connection_time: int = 600,
        send_last_n_segments: int = 10,
        no_speech_thresh: float = 0.45,
        clip_audio: bool = False,
        same_output_threshold: int = 10,
        enable_translation: bool = False,
        target_language: Optional[str] = None,
        hotwords: Optional[str] = None,
        enable_diarization: bool = False,
        max_speakers: int = 4,
        word_timestamps: bool = False,
        enable_timestamps: bool = False,
        n_display_segments: int = 3,
        initial_prompt: Optional[str] = None,
        transcription_callback: Optional[Callable] = None,
        translation_callback: Optional[Callable] = None,
        max_retries: int = 0,
        retry_delay: float = 2.0,
        api_key: Optional[str] = None,
    ):
        import websocket

        self.uid = str(uuid.uuid4())
        self.language = lang
        self.task = "translate" if translate else "transcribe"
        self.model = model
        self.server_error = False
        self.srt_file_path = srt_file_path
        self.use_vad = use_vad
        self.use_wss = use_wss
        self.log_transcription = log_transcription
        self.send_last_n_segments = send_last_n_segments
        self.no_speech_thresh = no_speech_thresh
        self.clip_audio = clip_audio
        self.same_output_threshold = same_output_threshold
        self.enable_translation = enable_translation
        self.target_language = target_language
        self.hotwords = hotwords
        self.enable_diarization = enable_diarization
        self.max_speakers = max_speakers
        self.word_timestamps = word_timestamps
        self.enable_timestamps = enable_timestamps
        self.n_display_segments = n_display_segments
        self.initial_prompt = initial_prompt
        self.transcription_callback = transcription_callback
        self.translation_callback = translation_callback
        self.max_retries = max_retries
        self.retry_delay = retry_delay
        self.api_key = api_key

        self.recording = False
        self.waiting = False
        self.last_response_received: Optional[float] = None
        self.disconnect_if_no_response_for = 15
        self.transcript: list[dict] = []
        self.translated_transcript: list[dict] = []
        self.last_segment: Optional[dict] = None
        self.last_received_segment: Optional[str] = None

        scheme = "wss" if use_wss else "ws"
        self.websocket_url = f"{scheme}://{host}:{port}"
        if api_key:
            self.websocket_url += f"?token={api_key}"
        self._ws_module = websocket
        self._retries_left = max_retries
        self._closing = False
        self._connect()
        Client.INSTANCES[self.uid] = self

    # ------------------------------------------------------------------

    def _connect(self) -> None:
        self.client_socket = self._ws_module.WebSocketApp(
            self.websocket_url,
            on_open=lambda ws: self.on_open(ws),
            on_message=lambda ws, message: self.on_message(ws, message),
            on_error=lambda ws, error: self.on_error(ws, error),
            on_close=lambda ws, code, reason: self.on_close(ws, code, reason),
        )
        self.ws_thread = threading.Thread(target=self.client_socket.run_forever)
        self.ws_thread.daemon = True
        self.ws_thread.start()

    def handle_status_messages(self, message: dict) -> None:
        """WAIT / ERROR / WARNING statuses (client.py:162-172)."""
        status = message["status"]
        if status == "WAIT":
            self.waiting = True
            logger.info("server full, estimated wait %.1f minutes", message["message"])
        elif status == "ERROR":
            logger.error("server error: %s", message["message"])
            self.server_error = True
        elif status == "WARNING":
            logger.warning("server warning: %s", message["message"])

    def process_segments(self, segments: list[dict]) -> None:
        """Accumulate committed segments, dedup rolling partials
        (client.py:174-246)."""
        text = []
        for i, seg in enumerate(segments):
            if not text or text[-1] != seg["text"]:
                text.append(seg["text"])
                if i == len(segments) - 1 and not seg.get("completed", False):
                    self.last_segment = seg
                elif seg.get("completed", False) and (
                    not self.transcript
                    or float(seg["start"])
                    >= float(self.transcript[-1]["end"]) - 0.01
                ):
                    self.transcript.append(seg)
        if self.last_received_segment is None or self.last_received_segment != segments[-1]["text"]:
            self.last_response_received = time.time()
            self.last_received_segment = segments[-1]["text"]

        if self.transcription_callback is not None:
            try:
                self.transcription_callback(text.copy(), segments)
            except Exception:
                logger.exception("transcription callback failed")
            return

        if self.log_transcription:
            if self.enable_timestamps:
                # `[start -> end] text` per segment (reference
                # client.py:212-225 + utils.py:15-35)
                shown = [
                    {"start": s["start"], "end": s["end"], "text": s["text"]}
                    for s in self.transcript[-self.n_display_segments:]
                ]
                if self.last_segment is not None and not any(
                    d.get("text") == self.last_segment["text"] for d in shown
                ):
                    shown.append(
                        {
                            "start": self.last_segment["start"],
                            "end": self.last_segment["end"],
                            "text": self.last_segment["text"],
                        }
                    )
                print_transcript(
                    shown, timestamps=True, max_lines=self.n_display_segments
                )
            else:
                text = text[-self.n_display_segments:]
                print_transcript(text)

    def on_message(self, ws, message) -> None:
        message = json.loads(message)
        if message.get("uid") != self.uid:
            logger.error("invalid client uid")
            return
        if "status" in message:
            self.handle_status_messages(message)
            return
        if "message" in message:
            if message["message"] == "DISCONNECT":
                logger.info("server disconnected due to overtime")
                self.recording = False
            elif message["message"] == "SERVER_READY":
                self.last_response_received = time.time()
                self.recording = True
                self.server_backend = message.get("backend", "tpu")
                logger.info("server running with backend %s", self.server_backend)
            return
        if "language" in message:
            self.language = message.get("language")
            lang_prob = message.get("language_prob")
            logger.info("server detected language %s with probability %s",
                        self.language, lang_prob)
            return
        if "segments" in message and message["segments"]:
            self.process_segments(message["segments"])
        if "translated_segments" in message and message["translated_segments"]:
            self.translated_transcript.extend(message["translated_segments"])
            if self.translation_callback is not None:
                try:
                    self.translation_callback(message["translated_segments"])
                except Exception:
                    logger.exception("translation callback failed")

    def on_error(self, ws, error) -> None:
        logger.error("websocket error: %s", error)
        self.server_error = True
        self.error_message = str(error)

    def on_close(self, ws, close_status_code, close_msg) -> None:
        logger.info("websocket closed: %s %s", close_status_code, close_msg)
        was_recording = self.recording
        self.recording = False
        # NOTE: `waiting` stays sticky — a WAIT status followed by the
        # server closing must still read as "server full" to callers.
        # Auto-reconnect (client.py:301-313): only for unexpected drops of a
        # live session, never after a server-reported error or WAIT.
        if (
            was_recording
            and not self._closing
            and not self.server_error
            and not self.waiting
            and self._retries_left > 0
        ):
            self._retries_left -= 1
            logger.info(
                "connection lost; reconnecting in %.1fs (%d retries left)",
                self.retry_delay, self._retries_left,
            )
            threading.Timer(self.retry_delay, self._reconnect).start()

    def _reconnect(self) -> None:
        if self._closing:
            return
        try:
            self._connect()
        except Exception:
            logger.exception("reconnect failed")

    def on_open(self, ws) -> None:
        """Send handshake options (client.py:315-349)."""
        ws.send(
            json.dumps(
                {
                    "uid": self.uid,
                    "language": self.language,
                    "task": self.task,
                    "model": self.model,
                    "use_vad": self.use_vad,
                    "send_last_n_segments": self.send_last_n_segments,
                    "no_speech_thresh": self.no_speech_thresh,
                    "clip_audio": self.clip_audio,
                    "same_output_threshold": self.same_output_threshold,
                    "enable_translation": self.enable_translation,
                    "target_language": self.target_language,
                    "hotwords": self.hotwords,
                    "enable_diarization": self.enable_diarization,
                    "max_speakers": self.max_speakers,
                    "word_timestamps": self.word_timestamps,
                    "initial_prompt": self.initial_prompt,
                }
            )
        )

    def send_packet_to_server(self, message) -> None:
        try:
            self.client_socket.send(message, self._ws_module.ABNF.OPCODE_BINARY)
        except Exception as e:
            logger.error("failed to send packet: %s", e)

    def close_websocket(self) -> None:
        self._closing = True
        try:
            self.client_socket.close()
        except Exception:
            pass
        try:
            self.ws_thread.join(timeout=5)
        except Exception:
            pass

    def get_client_socket(self):
        return self.client_socket

    def write_srt_file(self, output_path: str = "output.srt") -> None:
        if self.server_backend:
            segments = self.transcript.copy()
            if self.last_segment:
                segments.append(self.last_segment)
            if segments:
                create_srt_file(segments, output_path)

    server_backend: Optional[str] = None

    def wait_before_disconnect(self) -> None:
        """Wait until the server has been idle 15 s (client.py:409-413)."""
        while (
            self.recording
            and self.last_response_received is not None
            and time.time() - self.last_response_received
            < self.disconnect_if_no_response_for
        ):
            time.sleep(0.1)


class TranscriptionTeeClient:
    """Fan audio out to N clients (client.py:442-841)."""

    def __init__(self, clients: list[Client], save_output_recording: bool = False,
                 output_recording_filename: str = "./output_recording.wav",
                 mute_audio_playback: bool = False):
        self.clients = clients
        if not self.clients:
            raise Exception("At least one client is required.")
        self.chunk = 4096
        self.rate = SAMPLE_RATE
        self.save_output_recording = save_output_recording
        self.output_recording_filename = output_recording_filename
        self.mute_audio_playback = mute_audio_playback
        self.frames = b""

    def __call__(self, audio=None, rtsp_url=None, hls_url=None, save_file=None) -> None:
        assert sum(x is not None for x in (audio, rtsp_url, hls_url)) <= 1, (
            "only one source at a time"
        )
        logger.info("waiting for server ready ...")
        for client in self.clients:
            while not client.recording:
                if client.waiting or client.server_error:
                    self.close_all_clients()
                    return
                time.sleep(0.05)
        logger.info("server ready")
        try:
            if audio is not None:
                self.play_file(audio)
            elif rtsp_url is not None:
                self.process_rtsp(rtsp_url)
            elif hls_url is not None:
                self.process_hls(hls_url)
            else:
                self.record()
        except KeyboardInterrupt:
            self.close_all_clients()

    def close_all_clients(self) -> None:
        for client in self.clients:
            client.close_websocket()

    def write_all_clients_srt(self) -> None:
        for i, client in enumerate(self.clients):
            path = (
                client.srt_file_path
                if len(self.clients) == 1
                else f"{client.srt_file_path.rsplit('.', 1)[0]}_{i}.srt"
            )
            client.write_srt_file(path)

    def multicast_packet(self, packet: bytes, unconditional: bool = False) -> None:
        for client in self.clients:
            if unconditional or client.recording:
                client.send_packet_to_server(packet)

    def play_file(self, filename: str) -> None:
        """Stream a file in real time (client.py:511-571)."""
        audio = load_audio(filename)
        chunk_samples = self.chunk
        t_start = time.time()
        sent = 0
        try:
            for off in range(0, len(audio), chunk_samples):
                piece = audio[off : off + chunk_samples]
                self.multicast_packet(piece.astype(np.float32).tobytes())
                sent += len(piece)
                # realtime pacing
                target = t_start + sent / self.rate
                delay = target - time.time()
                if delay > 0:
                    time.sleep(delay)
            for client in self.clients:
                client.wait_before_disconnect()
            self.multicast_packet(END_OF_AUDIO, True)
            self.write_all_clients_srt()
        finally:
            self.close_all_clients()

    def record(self) -> None:
        """Microphone capture via PyAudio (optional dep)."""
        try:
            import pyaudio
        except ImportError as e:
            raise RuntimeError("microphone capture requires pyaudio") from e
        pa = pyaudio.PyAudio()
        stream = pa.open(
            format=pyaudio.paInt16, channels=1, rate=self.rate,
            input=True, frames_per_buffer=self.chunk,
        )
        try:
            while any(c.recording for c in self.clients):
                data = stream.read(self.chunk, exception_on_overflow=False)
                if self.save_output_recording:
                    self.frames += data
                audio = bytes_to_float_array(data, "int16")
                self.multicast_packet(audio.tobytes())
        finally:
            stream.stop_stream()
            stream.close()
            pa.terminate()
            if self.save_output_recording and self.frames:
                write_wav(
                    self.output_recording_filename,
                    bytes_to_float_array(self.frames, "int16"),
                    self.rate,
                )
            self.write_all_clients_srt()
            self.close_all_clients()

    def _stream_container(self, url: str) -> None:
        try:
            import av
        except ImportError as e:
            raise RuntimeError("RTSP/HLS ingestion requires PyAV") from e
        container = av.open(url)
        resampler = av.audio.resampler.AudioResampler(
            format="s16", layout="mono", rate=self.rate
        )
        for frame in container.decode(audio=0):
            for out in resampler.resample(frame):
                data = bytes(out.planes[0])
                audio = bytes_to_float_array(data, "int16")
                self.multicast_packet(audio.tobytes())
        self.multicast_packet(END_OF_AUDIO, True)
        self.write_all_clients_srt()
        self.close_all_clients()

    def process_rtsp(self, rtsp_url: str) -> None:
        self._stream_container(rtsp_url)

    def process_hls(self, hls_url: str) -> None:
        self._stream_container(hls_url)


class TranscriptionClient(TranscriptionTeeClient):
    """Single-server facade (client.py:844-923)."""

    def __init__(self, host, port, **kwargs):
        tee_kwargs = {
            k: kwargs.pop(k)
            for k in (
                "save_output_recording",
                "output_recording_filename",
                "mute_audio_playback",
            )
            if k in kwargs
        }
        self.client = Client(host, port, **kwargs)
        if tee_kwargs.get("save_output_recording") and not str(
            tee_kwargs.get("output_recording_filename", ".wav")
        ).endswith(".wav"):
            raise ValueError("output_recording_filename must end with .wav")
        super().__init__([self.client], **tee_kwargs)

    def __call__(self, *args, **kwargs):
        super().__call__(*args, **kwargs)
        # final transcript text (client.py:920-923)
        segments = self.client.transcript.copy()
        if self.client.last_segment:
            segments.append(self.client.last_segment)
        return " ".join(s["text"].strip() for s in segments).strip()


class StreamingTranscriptionClient:
    """Push-mode client: send()/send_array()/close() + callbacks
    (client.py:959-1150)."""

    def __init__(
        self,
        host: str,
        port: int,
        on_partial: Optional[Callable] = None,
        on_committed: Optional[Callable] = None,
        on_translation: Optional[Callable] = None,
        on_error: Optional[Callable] = None,
        on_close: Optional[Callable] = None,
        connect_timeout: float = 15.0,
        **client_kwargs,
    ):
        self.on_partial = on_partial
        self.on_committed = on_committed
        self.on_error = on_error
        self.on_close_cb = on_close
        self._seen_committed: set = set()
        self._closed = False

        self.client = Client(
            host,
            port,
            log_transcription=False,
            transcription_callback=self._dispatch,
            translation_callback=on_translation,
            **client_kwargs,
        )
        deadline = time.time() + connect_timeout
        while not self.client.recording:
            if self.client.server_error:
                raise ConnectionError(
                    getattr(self.client, "error_message", "server error")
                )
            if self.client.waiting:
                raise ConnectionError("server full")
            if time.time() > deadline:
                raise TimeoutError("timed out waiting for SERVER_READY")
            time.sleep(0.02)

    def _dispatch(self, text, segments) -> None:
        try:
            for seg in segments:
                if seg.get("completed", False):
                    key = (seg["start"], seg["end"], seg["text"])
                    if key not in self._seen_committed:
                        self._seen_committed.add(key)
                        if self.on_committed:
                            self.on_committed(seg)
                elif self.on_partial:
                    self.on_partial(seg)
        except Exception as e:
            if self.on_error:
                self.on_error(e)

    def send(self, pcm_bytes: bytes, audio_format: str = "int16") -> None:
        """Push raw PCM bytes (normalized to float32 on the wire)."""
        if self._closed:
            raise RuntimeError("client is closed")
        if audio_format == "float32":
            audio = np.frombuffer(pcm_bytes, np.float32)
        else:
            audio = bytes_to_float_array(pcm_bytes, audio_format)
        self.client.send_packet_to_server(audio.astype(np.float32).tobytes())

    def send_array(self, audio: np.ndarray) -> None:
        if self._closed:
            raise RuntimeError("client is closed")
        self.client.send_packet_to_server(audio.astype(np.float32).tobytes())

    def close(self, wait_for_server: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.client.send_packet_to_server(END_OF_AUDIO)
            if wait_for_server:
                self.client.wait_before_disconnect()
        finally:
            self.client.close_websocket()
            if self.on_close_cb:
                try:
                    self.on_close_cb()
                except Exception:
                    pass
