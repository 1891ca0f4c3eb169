"""The port's profiler (utils/profiling.py) and the server's --profile_dir.

start_profiler / stop_profiler write a Chrome trace JSON under the
directory, naming the spans of the span log (a span opens a record_function
while the profiler records); trace_scope does the same; the stop is
registered with atexit while a trace runs. A served CPU session (the server CLI's
main with WL_PROFILE_DIR set, a tiny random model, one streaming session
through the connection handler in-process) leaves a trace file naming the
continuous scheduler's spans once the server has shut down.
"""

import asyncio
import glob
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from whisperlive_tpu_torch.cli import run_server
from whisperlive_tpu_torch.serving import backends as tbackends
from whisperlive_tpu_torch.serving.server import ClientManager, TranscriptionServer
from whisperlive_tpu_torch.utils import profiling


def _names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


@pytest.fixture(autouse=True)
def no_trace_left():
    yield
    profiling.stop_profiler()


def test_start_stop_writes_a_chrome_trace_naming_the_spans(tmp_path, monkeypatch):
    registered = []
    monkeypatch.setattr(profiling, "atexit", SimpleNamespace(
        register=registered.append, unregister=registered.remove))
    assert profiling.stop_profiler() is None  # nothing tracing
    assert profiling.start_profiler(str(tmp_path / "p"), device="cpu")
    assert registered == [profiling.stop_profiler]
    assert not profiling.start_profiler(str(tmp_path / "q"), device="cpu")  # one at a time
    with profiling.span("wl.test_span"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    path = profiling.stop_profiler()
    assert registered == []
    assert os.path.dirname(path) == str(tmp_path / "p") and path.endswith(".json")
    names = _names(path)
    assert "wl.test_span" in names and "aten::mm" in names
    assert profiling.stop_profiler() is None
    assert not os.path.exists(tmp_path / "q")


def test_trace_scope_and_env(tmp_path):
    """trace_scope writes one trace naming its spans (the server's
    WL_PROFILE_DIR default: test_served_session_with_wl_profile_dir_leaves_a_trace)."""
    with profiling.trace_scope(str(tmp_path / "scoped"), device="cpu"):
        with profiling.span("wl.scoped"):
            torch.zeros(4).sum()
    (path,) = glob.glob(str(tmp_path / "scoped" / "trace_*.json"))
    assert "wl.scoped" in _names(path)
    assert profiling.stop_profiler() is None


class _Socket:
    """The server's side of one in-process connection."""

    def __init__(self):
        self.incoming: asyncio.Queue = asyncio.Queue()
        self.sent: list[dict] = []

    async def recv(self):
        item = await self.incoming.get()
        if item is None:
            raise ConnectionError("Closed")
        return item

    async def send(self, message):
        self.sent.append(json.loads(message))

    async def close(self, *args):
        pass


async def _one_session(server):
    ws = _Socket()
    ws.incoming.put_nowait(json.dumps({"uid": "p", "language": "en", "use_vad": False}))
    task = asyncio.create_task(server.recv_audio(ws))
    audio = (np.random.default_rng(0).standard_normal(32000) * 0.1).astype(np.float32)
    for off in range(0, len(audio), 8000):
        ws.incoming.put_nowait(audio[off:off + 8000].tobytes())
        await asyncio.sleep(0.25)
    ws.incoming.put_nowait(b"END_OF_AUDIO")
    pool = server.backend.continuous_scheduler
    for _ in range(600):  # until the pool has stepped and drained
        if pool.tick_stats["ticks"] and not pool._slots:
            break
        await asyncio.sleep(0.1)
    ws.incoming.put_nowait(None)
    await task
    return ws


def test_served_session_with_wl_profile_dir_leaves_a_trace(tmp_path, monkeypatch):
    """F5: the flag defaults to WL_PROFILE_DIR as in the reference, main
    starts the profiler, and the server's shutdown path writes the trace."""
    monkeypatch.setenv("WL_PROFILE_DIR", str(tmp_path / "served"))
    monkeypatch.setattr(tbackends, "_DISABLE_GATES", True)
    monkeypatch.setattr(tbackends, "STREAMING_MAX_NEW_TOKENS", 8)
    sessions = []

    def serve_one(self, backend, **kw):
        self.backend, self.backend_name = backend, kw["backend_name"]
        self.client_manager = ClientManager(4, 600)
        sessions.append(asyncio.run(_one_session(self)))

    monkeypatch.setattr(TranscriptionServer, "run", serve_one)
    threads = torch.get_num_threads()
    monkeypatch.setenv("OMP_NUM_THREADS", str(threads))  # main sets it; restored after
    try:
        run_server.main(["--model", "tiny", "--device", "cpu", "--no_warmup",
                         "--continuous_slots", "2", "--omp_num_threads", str(threads)])
    finally:
        torch.set_num_threads(threads)
    (ws,) = sessions
    assert any(m.get("message") == "SERVER_READY" for m in ws.sent)
    assert profiling._active is None
    (path,) = glob.glob(str(tmp_path / "served" / "trace_*.json"))
    names = _names(path)
    assert {"continuous.insert", "continuous.step", "continuous.harvest"} <= names
