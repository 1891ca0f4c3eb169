"""OpenAI-compatible REST API (reference: server.py:490-598, 692-867).

`POST /v1/audio/transcriptions` with multipart upload, response_format in
{json, text, srt, verbose_json, vtt}, SSE streaming (`stream=true`),
known-speaker labels (`known_speaker_files[]`, `known_speaker_names[]`),
Bearer-token auth, per-IP sliding-window rate limiting and CORS. The REST
app shares the server's event loop and its backend, so REST windows batch
with the live streams on the card.

The port's copy of whisperlive_tpu/serving/rest.py, split in two so that
the request logic runs without aiohttp:

  * `check_access` (auth and rate limit) and `handle_transcription` (the
    parsed fields and upload in; status, content type and body out, SSE
    chunks through a callable) import nothing beyond the port;
  * `start_rest_server` imports aiohttp when it is called and wraps them.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
import uuid
from collections import defaultdict, deque
from typing import Awaitable, Callable, Optional, Sequence

import numpy as np

from whisperlive_tpu_torch.audio import io as audio_io
from whisperlive_tpu_torch.audio.flac import read_flac_bytes
from whisperlive_tpu_torch.serving.session import SessionOptions
from whisperlive_tpu_torch.utils import metrics as wl_metrics
from whisperlive_tpu_torch.utils.text import segments_to_srt, segments_to_vtt

logger = logging.getLogger(__name__)

WINDOW_S = 30.0
SAMPLE_RATE = 16_000
ENDPOINT = "/v1/audio/transcriptions"
RESPONSE_FORMATS = ("json", "text", "srt", "verbose_json", "vtt")


class RateLimiter:
    """Per-IP sliding window (server.py:713-730)."""

    def __init__(self, rpm: int):
        self.rpm = rpm
        self.hits: dict[str, deque] = defaultdict(deque)

    def allow(self, ip: str) -> bool:
        if self.rpm <= 0:
            return True
        now = time.monotonic()
        q = self.hits[ip]
        while q and now - q[0] > 60.0:
            q.popleft()
        if len(q) >= self.rpm:
            return False
        q.append(now)
        return True


def check_access(path: str, authorization: str, ip: str, api_key: Optional[str],
                 limiter: RateLimiter) -> Optional[tuple[int, dict]]:
    """The middleware's gate on /v1/ paths: (401, body) for a missing or
    wrong Bearer key (server.py:705-711), (429, body) past the rate limit,
    None to serve the request."""
    if api_key and path.startswith("/v1/") and authorization != f"Bearer {api_key}":
        wl_metrics.track_rest_request(path, 401)
        return 401, {"error": "invalid or missing API key"}
    if path.startswith("/v1/") and not limiter.allow(ip):
        wl_metrics.track_rest_request(path, 429)
        return 429, {"error": "rate limit exceeded"}
    return None


async def _seek_results(backend, audio: np.ndarray, options: SessionOptions,
                        language: Optional[str]):
    """The seek loop over a whole file through the shared backend: yields
    (window start in s, BatchResult) per decoded window. The cursor
    advances by the decode's own feedback (BatchResult.advance_s, floored
    at 1 s; the reference's generate_segments semantics,
    transcriber_faster_whisper.py:1104-1127), so speech that straddles a
    window edge is decoded again from the last closed timestamp; the last
    224 tokens condition the next window; the per-uid backend state is
    released once, at the end."""
    previous_tokens: list[int] = []
    detected = language
    offset = 0
    uid = f"rest-{uuid.uuid4()}"
    try:
        while offset < len(audio):
            window = audio[offset: offset + int(WINDOW_S * SAMPLE_RATE)]
            result = await backend.transcribe(
                window, options, language=detected, previous_tokens=previous_tokens,
                uid=uid, include_unfinished=False,
            )
            advance_s = WINDOW_S
            if result is not None:
                detected = detected or result.language
                advance_s = max(result.advance_s, 1.0)
                yield offset / SAMPLE_RATE, result
                for s in result.segments:
                    previous_tokens.extend(getattr(s, "tokens", []))
            previous_tokens = previous_tokens[-224:]
            offset += int(advance_s * SAMPLE_RATE)
    finally:
        if hasattr(backend, "release"):
            backend.release(uid)


async def _transcribe_full(backend, audio: np.ndarray, options: SessionOptions,
                           language: Optional[str]):
    """A whole file -> (segment dicts in file time, detected language)."""
    segments_out = []
    detected = language
    async with contextlib.aclosing(_seek_results(backend, audio, options, language)) as results:
        async for t0, result in results:
            detected = detected or result.language
            for s in result.segments:
                seg = {
                    "start": t0 + s.start,
                    "end": t0 + s.end,
                    "text": s.text,
                    "tokens": list(getattr(s, "tokens", [])),
                    "avg_logprob": getattr(s, "avg_logprob", 0.0),
                    "no_speech_prob": getattr(s, "no_speech_prob", 0.0),
                    "compression_ratio": getattr(s, "compression_ratio", 0.0),
                    "temperature": getattr(s, "temperature", 0.0),
                }
                words = getattr(s, "words", None)
                if words:
                    seg["words"] = [{"start": t0 + w.start, "end": t0 + w.end,
                                     "word": w.word, "probability": w.probability}
                                    for w in words]
                segments_out.append(seg)
    return segments_out, (detected or "en")


def _format_response(segments, language, duration, response_format):
    text = "".join(s["text"] for s in segments).strip()
    if response_format == "text":
        return "text/plain", text
    if response_format in ("srt", "vtt"):
        subs = [{"start": s["start"], "end": s["end"], "text": s["text"]} for s in segments]
        to_subtitles = segments_to_srt if response_format == "srt" else segments_to_vtt
        return "text/plain", to_subtitles(subs)
    if response_format == "verbose_json":
        return "application/json", json.dumps(
            {
                "task": "transcribe",
                "language": language,
                "duration": duration,
                "text": text,
                "segments": [
                    {
                        "id": i,
                        "seek": 0,
                        "start": s["start"],
                        "end": s["end"],
                        "text": s["text"],
                        "tokens": s["tokens"],
                        "temperature": s["temperature"],
                        "avg_logprob": s["avg_logprob"],
                        "compression_ratio": s["compression_ratio"],
                        "no_speech_prob": s["no_speech_prob"],
                        **({"speaker": s["speaker"]} if "speaker" in s else {}),
                        **({"words": s["words"]} if "words" in s else {}),
                    }
                    for i, s in enumerate(segments)
                ],
            }
        )
    return "application/json", json.dumps({"text": text})


def _decode_audio(data: bytes, filename: str = "") -> np.ndarray:
    """WAV or FLAC, resampled to 16 kHz."""
    if filename.lower().endswith(".flac") or data[:4] == b"fLaC":
        audio, sr = read_flac_bytes(data)
    else:
        audio, sr = audio_io.read_wav(data)
    return audio_io.resample_audio(audio, sr)


def _label_speakers(segments: list[dict], audio: np.ndarray,
                    known_speakers: Sequence[tuple[str, bytes]],
                    speaker_names: Sequence[str]) -> None:
    """Known-speaker diarization (server.py:550-598, 812-821): enroll the
    uploaded reference voices (WAV or FLAC), then label each segment. REST is
    offline work, so it takes the quality embedder; live sessions keep the
    cheap one."""
    from whisperlive_tpu_torch.diarization import SpeakerDiarizer

    diarizer = SpeakerDiarizer(max_speakers=max(len(known_speakers), 4), quality=True)
    for i, (fname, raw) in enumerate(known_speakers):
        name = speaker_names[i] if i < len(speaker_names) else fname
        try:
            diarizer.enroll_speaker(name, _decode_audio(raw))
        except Exception:
            logger.exception("failed to enroll speaker %s", name)
    for s in segments:
        label = diarizer.identify_speaker(
            audio[int(s["start"] * SAMPLE_RATE): int(s["end"] * SAMPLE_RATE)])
        if label is not None:
            s["speaker"] = label


def _error(message: str) -> tuple[int, str, str]:
    wl_metrics.track_rest_request(ENDPOINT, 400)
    return 400, "application/json", json.dumps({"error": message})


async def handle_transcription(
    backend,
    fields: dict[str, str],
    file_bytes: bytes,
    filename: str = "audio.wav",
    known_speakers: Sequence[tuple[str, bytes]] = (),
    speaker_names: Sequence[str] = (),
    write: Optional[Callable[[bytes], Awaitable[None]]] = None,
) -> tuple[int, str, Optional[str]]:
    """One transcription request -> (status, content type, body).

    `fields` are the multipart form's text fields (language, prompt,
    hotwords, response_format, timestamp_granularities, use_vad, stream).
    The upload is WAV or FLAC (by name or magic), or else raw f32 PCM. With
    stream=true every segment goes out through `write` as an SSE event
    `data: {"text", "start", "end"}`, then `data: [DONE]`, and the body is
    None."""
    if not file_bytes:
        return _error("missing file")
    try:
        if filename.lower().endswith((".flac", ".wav")) or file_bytes[:4] in (b"fLaC", b"RIFF"):
            audio = _decode_audio(file_bytes, filename)
        else:
            audio = np.frombuffer(file_bytes, np.float32).copy()
    except Exception as e:
        return _error(f"cannot decode audio: {e}")

    language = fields.get("language") or None
    response_format = fields.get("response_format", "json")
    if response_format not in RESPONSE_FORMATS:
        return _error(f"unsupported response_format {response_format!r}")
    options = SessionOptions(
        language=language,
        initial_prompt=fields.get("prompt") or None,
        hotwords=fields.get("hotwords") or None,
        word_timestamps="word" in fields.get("timestamp_granularities", ""),
        use_vad=fields.get("use_vad", "true").lower() != "false",
    )
    duration = len(audio) / SAMPLE_RATE

    if fields.get("stream", "").lower() == "true":  # SSE (server.py:490-537)
        async with contextlib.aclosing(
                _seek_results(backend, audio, options, language)) as results:
            async for t0, result in results:
                for s in result.segments:
                    event = {"text": s.text, "start": t0 + s.start, "end": t0 + s.end}
                    await write(f"data: {json.dumps(event)}\n\n".encode())
        await write(b"data: [DONE]\n\n")
        wl_metrics.track_rest_request(ENDPOINT, 200)
        return 200, "text/event-stream", None

    t_start = time.monotonic()
    segments, detected = await _transcribe_full(backend, audio, options, language)
    if known_speakers:
        _label_speakers(segments, audio, known_speakers, speaker_names)
    ctype, body = _format_response(segments, detected, duration, response_format)
    wl_metrics.track_rest_request(ENDPOINT, 200)
    logger.info("REST transcription done in %.2fs (%.1fs audio)",
                time.monotonic() - t_start, duration)
    return 200, ctype, body


async def start_rest_server(
    backend,
    port: int,
    host: str = "0.0.0.0",
    cors_origins: Optional[list[str]] = None,
    api_key: Optional[str] = None,
    rate_limit_rpm: int = 0,
):
    """Start the aiohttp app on the current loop; returns the runner."""
    from aiohttp import web

    limiter = RateLimiter(rate_limit_rpm)
    origins = cors_origins or ["*"]

    @web.middleware
    async def middleware(request, handler):
        if request.method == "OPTIONS":  # CORS preflight
            resp = web.Response(status=204)
        else:
            denied = check_access(request.path, request.headers.get("Authorization", ""),
                                  request.remote or "unknown", api_key, limiter)
            if denied is not None:
                return web.json_response(denied[1], status=denied[0])
            try:
                resp = await handler(request)
            except web.HTTPException as e:
                resp = e
        origin = request.headers.get("Origin")
        if origin and ("*" in origins or origin in origins):
            resp.headers["Access-Control-Allow-Origin"] = origin if "*" not in origins else "*"
            resp.headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"
            resp.headers["Access-Control-Allow-Headers"] = "Authorization, Content-Type"
        return resp

    async def health(request):
        return web.json_response({"status": "ok"})

    async def transcriptions(request):
        try:
            reader = await request.multipart()
        except Exception:
            wl_metrics.track_rest_request(ENDPOINT, 400)
            return web.json_response({"error": "expected multipart form data"}, status=400)
        fields: dict[str, str] = {}
        file_bytes = b""
        filename = "audio.wav"
        known_speakers: list[tuple[str, bytes]] = []
        speaker_names: list[str] = []
        async for part in reader:
            if part.name == "file":
                filename = part.filename or filename
                file_bytes = await part.read(decode=False)
            elif part.name in ("known_speaker_files", "known_speaker_files[]"):
                known_speakers.append((part.filename or f"speaker_{len(known_speakers)}",
                                       await part.read(decode=False)))
            elif part.name in ("known_speaker_names", "known_speaker_names[]"):
                speaker_names.append((await part.read(decode=False)).decode("utf-8", "replace"))
            else:
                fields[part.name] = (await part.read(decode=False)).decode("utf-8", "replace")

        stream = None

        async def write(chunk: bytes) -> None:
            nonlocal stream
            if stream is None:
                stream = web.StreamResponse(headers={"Content-Type": "text/event-stream",
                                                     "Cache-Control": "no-cache"})
                await stream.prepare(request)
            await stream.write(chunk)

        status, ctype, body = await handle_transcription(
            backend, fields, file_bytes, filename, known_speakers, speaker_names, write)
        if body is None:
            await stream.write_eof()
            return stream
        return web.Response(status=status, text=body, content_type=ctype)

    app = web.Application(middlewares=[middleware], client_max_size=512 * 1024 * 1024)
    app.router.add_get("/health", health)
    app.router.add_post(ENDPOINT, transcriptions)
    app.router.add_route("OPTIONS", ENDPOINT, transcriptions)

    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    logger.info("REST API listening on %s:%d", host, port)
    return runner
