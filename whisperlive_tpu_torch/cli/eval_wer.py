"""One-command WER harness through the port's full wire path.

    python -m whisperlive_tpu_torch.cli.eval_wer --audio a.flac \\
        --ckpt /path/to/hf-or-converted-dir --model base.en

runs the port's TranscriptionServer (its backend built as
cli/run_server.py's create_backend builds it) and the port's
TranscriptionClient on the audio, and scores the client's transcript
against --ref_text (default: the reference's jfk.flac ground truth) with
utils/wer.py. It prints the result as JSON and exits 0 iff WER <
--threshold. Without --ckpt the weights are random (from --seed, via the
server flags after "--"): the run then checks the harness, not the model.
Server flags go after "--", e.g. `-- --device cpu --beam_size 5`.

--transport loopback keeps the wire inside the process: the client's
socket and the server's connection handler exchange the same messages
through queues, for machines without the `websockets` and
`websocket-client` packages.

The port of scripts/eval_wer.py; `run_eval(...)` returns the result dict.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import queue
import socket
import sys
import threading
import time
from types import SimpleNamespace

JFK_GROUND_TRUTH = (
    "And so my fellow Americans, ask not, what your country can do for you. "
    "Ask what you can do for your country!"
)

_CLOSE = object()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _ServerThread:
    """The port's TranscriptionServer on its own event loop thread: on a
    local port (transport "websocket"), or taking in-process connections
    (transport "loopback")."""

    def __init__(self, backend, backend_name: str, transport: str = "websocket"):
        self.port = _free_port()
        self.backend = backend
        self.backend_name = backend_name
        self.transport = transport
        self.loop = None
        self._ready = threading.Event()
        self._stop = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        from whisperlive_tpu_torch.serving.server import ClientManager, TranscriptionServer

        self.server = TranscriptionServer()
        self.loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self.loop)
        try:
            if self.transport == "websocket":
                self.loop.run_until_complete(self.server.serve(
                    self.backend, host="127.0.0.1", port=self.port,
                    backend_name=self.backend_name, max_clients=4))
            else:
                # what serve() sets up, without a listening socket
                self.server.backend = self.backend
                self.server.backend_name = self.backend_name
                self.server.client_manager = ClientManager(4, 600)
                self._stop = asyncio.Event()
                self._ready.set()
                self.loop.run_until_complete(self._stop.wait())
        except Exception:
            pass
        finally:
            self.loop.close()

    def __enter__(self):
        self._thread.start()
        deadline = time.time() + 30
        while time.time() < deadline:
            if self.transport == "loopback":
                if self._ready.wait(0.05):
                    return self
                continue
            try:
                with socket.create_connection(("127.0.0.1", self.port), timeout=0.2):
                    return self
            except OSError:
                time.sleep(0.05)
        raise RuntimeError("server did not start")

    def __exit__(self, *exc):
        if self.loop is not None and not self.loop.is_closed():
            stop = self._stop.set if self._stop is not None else self.server.request_shutdown
            self.loop.call_soon_threadsafe(stop)
        self._thread.join(timeout=10)
        return False


class _LoopbackClosed(Exception):
    """The client closed an in-process connection ("Closed" in the name:
    the server's receive loop takes it as a normal close)."""


class _LoopbackServerSocket:
    """The server's end of an in-process connection: what the connection
    handler awaits from a websockets connection."""

    def __init__(self, to_client: queue.Queue):
        self.incoming: asyncio.Queue = asyncio.Queue()
        self.to_client = to_client

    async def recv(self):
        item = await self.incoming.get()
        if item is _CLOSE:
            raise _LoopbackClosed()
        return item

    async def send(self, message):
        self.to_client.put(message)

    async def close(self, *args):
        self.to_client.put(_CLOSE)


def _loopback_websocket_module(srv: _ServerThread) -> SimpleNamespace:
    """A stand-in for the `websocket` (websocket-client) module whose
    WebSocketApp connects to `srv`'s connection handler in-process; the
    client's callbacks run on its run_forever thread, as with the real
    package."""

    class WebSocketApp:
        def __init__(self, url, on_open=None, on_message=None, on_error=None, on_close=None):
            self.on_open, self.on_message = on_open, on_message
            self.on_error, self.on_close = on_error, on_close
            self.to_client: queue.Queue = queue.Queue()
            self.sock = None

        def run_forever(self):
            async def connect():
                sock = _LoopbackServerSocket(self.to_client)
                sock.task = asyncio.ensure_future(srv.server.recv_audio(sock))
                return sock

            self.sock = asyncio.run_coroutine_threadsafe(connect(), srv.loop).result(10)
            try:
                self.on_open(self)
                while (message := self.to_client.get()) is not _CLOSE:
                    self.on_message(self, message)
            except Exception as e:
                self.on_error(self, e)
            finally:
                self.on_close(self, None, None)

        def send(self, data, opcode=None):
            if self.sock is None:
                raise ConnectionError("loopback socket is not open")
            srv.loop.call_soon_threadsafe(self.sock.incoming.put_nowait, data)

        def close(self):
            if self.sock is not None and not srv.loop.is_closed():
                srv.loop.call_soon_threadsafe(self.sock.incoming.put_nowait, _CLOSE)
            self.to_client.put(_CLOSE)

    return SimpleNamespace(WebSocketApp=WebSocketApp, ABNF=SimpleNamespace(OPCODE_BINARY=2))


@contextlib.contextmanager
def _client_websocket_module(module):
    """Serve `module` to the client's `import websocket` while it connects."""
    saved = sys.modules.get("websocket")
    sys.modules["websocket"] = module
    try:
        yield
    finally:
        if saved is None:
            sys.modules.pop("websocket", None)
        else:
            sys.modules["websocket"] = saved


def run_eval(
    audio: str,
    ref_text: str,
    model: str = "base.en",
    ckpt: str | None = None,
    threshold: float = 0.05,
    language: str = "en",
    use_vad: bool = True,
    backend=None,
    server_args: list[str] | None = None,
    out_srt: str = "eval_wer_output.srt",
    transport: str = "websocket",
) -> dict:
    """Run the full server+client loop on `audio` and score vs `ref_text`.

    backend: pass a prebuilt serving backend to skip model construction;
    default builds the engine from model/ckpt/server_args via the server
    CLI's create_backend (and stops its schedulers at the end).
    transport: "websocket" (a local port) or "loopback" (in-process).
    """
    from whisperlive_tpu_torch.utils.wer import normalize_text, score

    if transport not in ("websocket", "loopback"):
        raise ValueError(f"unknown transport {transport!r} (websocket or loopback)")
    backend_name = "torch"
    built = None
    if backend is None:
        from whisperlive_tpu_torch.cli.run_server import (
            build_parser,
            create_backend,
        )

        argv = ["--model", model]
        if ckpt:
            argv += ["--tpu_model_path", ckpt]
        argv += server_args or []
        args = build_parser().parse_args(argv)
        backend = built = create_backend(args)
        backend_name = "fake" if args.fake_transcriber else "torch"

    from whisperlive_tpu_torch.client import TranscriptionClient

    try:
        with _ServerThread(backend, backend_name, transport) as srv:
            kwargs = dict(lang=language, model=model, use_vad=use_vad, srt_file_path=out_srt,
                          log_transcription=False)
            if transport == "loopback":
                with _client_websocket_module(_loopback_websocket_module(srv)):
                    client = TranscriptionClient("127.0.0.1", srv.port, **kwargs)
            else:
                client = TranscriptionClient("127.0.0.1", srv.port, **kwargs)
            hypothesis = client(audio)
    finally:
        if built is not None:
            from whisperlive_tpu_torch.cli.run_server import stop_backend

            stop_backend(built)

    ref_t = normalize_text(ref_text)
    hyp_t = normalize_text(hypothesis or "")
    stats = score([("utt", ref_t, hyp_t)])
    wer = stats.wer
    return {
        "wer": round(wer, 4),
        "threshold": threshold,
        "pass": wer < threshold,
        "ref_words": len(ref_t),
        "errors": stats.errors,
        "hypothesis": (hypothesis or "").strip(),
        "reference": ref_text,
        "srt": out_srt,
    }


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--audio", required=True, help="Audio file to transcribe (wav/flac).")
    parser.add_argument("--ref_text", default=JFK_GROUND_TRUTH,
                        help="Ground-truth transcript (literal text or @file).")
    parser.add_argument("--model", "-m", default="base.en")
    parser.add_argument("--ckpt", "-tpu", default=None,
                        help="Converted/HF checkpoint dir (REQUIRED for a meaningful WER: "
                             "random weights always fail).")
    parser.add_argument("--threshold", type=float, default=0.05,
                        help="Pass bar (the reference asserts < 0.05).")
    parser.add_argument("--language", default="en")
    parser.add_argument("--no_vad", action="store_true")
    parser.add_argument("--out_srt", default="eval_wer_output.srt")
    parser.add_argument("--transport", choices=("websocket", "loopback"), default="websocket",
                        help="websocket: a local port; loopback: the same messages "
                             "in-process (no websockets packages needed).")
    parser.add_argument("server_args", nargs="*", default=[],
                        help="Extra run_server flags after '--' (e.g. -- --device cpu).")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    ref = args.ref_text
    if ref.startswith("@"):
        with open(ref[1:]) as f:
            ref = f.read().strip()
    if args.ckpt is None:
        print("WARNING: no --ckpt given: random weights cannot pass WER; this run only "
              "validates the harness plumbing.", file=sys.stderr)
    result = run_eval(
        audio=args.audio,
        ref_text=ref,
        model=args.model,
        ckpt=args.ckpt,
        threshold=args.threshold,
        language=args.language,
        use_vad=not args.no_vad,
        server_args=args.server_args,
        out_srt=args.out_srt,
        transport=args.transport,
    )
    print(json.dumps(result))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
