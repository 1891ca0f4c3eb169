"""The port's multi-replica cluster router (whisperlive_tpu_torch/serving/
cluster.py): sticky uid routing, health failover, capacity-WAIT failover,
opaque wire relay; the five scenarios of tests/test_cluster.py against the
port's server on its FakeBackend, through the port's client, and the
router's rendezvous order held against the JAX router's.

The reference is single-process (ClientManager WAIT when full,
server.py:117-139); the router generalizes that to N replicas while
keeping the wire protocol byte-identical — asserted here by running the
REAL client library through the router against REAL fake-backend
servers."""

import asyncio
import socket
import threading
import time

import numpy as np
import pytest

from whisperlive_tpu.serving.cluster import ClusterRouter as JClusterRouter
from whisperlive_tpu_torch.serving.backends import FakeBackend
from whisperlive_tpu_torch.serving.cluster import ClusterRouter
from whisperlive_tpu_torch.serving.server import TranscriptionServer


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class ServerHarness:
    def __init__(self, max_clients=4):
        self.port = _free_port()
        self.max_clients = max_clients
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._loop = None

    def _run(self):
        self.server = TranscriptionServer()
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(
                self.server.serve(
                    FakeBackend(),
                    host="127.0.0.1",
                    port=self.port,
                    backend_name="fake",
                    max_clients=self.max_clients,
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


class RouterHarness:
    def __init__(self, backend_ports, health_interval_s=0.5):
        self.port = _free_port()
        self.router = ClusterRouter(
            [f"127.0.0.1:{p}" for p in backend_ports],
            health_interval_s=health_interval_s,
        )
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._loop = None

    def _run(self):
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(
                self.router.serve(host="127.0.0.1", port=self.port)
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
        raise RuntimeError("router did not start")

    def __exit__(self, *exc):
        if self._loop is not None and not self._loop.is_closed():
            self._loop.call_soon_threadsafe(self.router.request_shutdown)
        self._thread.join(timeout=10)
        return False


def _stream_through(port, uid_hint=None, seconds=3):
    """Run the real streaming client against `port`; return committed."""
    from whisperlive_tpu_torch.client import StreamingTranscriptionClient

    committed = []
    client = StreamingTranscriptionClient(
        "127.0.0.1", port, lang="en", on_committed=committed.append,
        use_vad=False, same_output_threshold=2,
    )
    audio = (
        0.1 * np.sin(2 * np.pi * 300 * np.arange(16000 * seconds) / 16000)
    ).astype(np.float32)
    for off in range(0, len(audio), 8000):
        client.send_array(audio[off : off + 8000])
        time.sleep(0.05)
    deadline = time.time() + 15
    while not committed and time.time() < deadline:
        time.sleep(0.1)
    client.close(wait_for_server=False)
    return committed


def test_end_to_end_through_router():
    with ServerHarness() as a, ServerHarness() as b:
        with RouterHarness([a.port, b.port]) as r:
            committed = _stream_through(r.port)
            assert committed, "no committed segments through the router"
            assert committed[0]["text"].strip().startswith("word")
            assert "." in committed[0]["start"]  # wire format preserved


def test_sticky_rendezvous_ranking():
    router = ClusterRouter(["h1:1", "h2:1", "h3:1"])
    for uid in ("alpha", "beta", "gamma"):
        first = [r.addr for r in router.rank(uid)]
        assert first == [r.addr for r in router.rank(uid)]  # deterministic
    # unhealthy replicas rank last but stay in the list (failover order)
    router.replicas[0].healthy = False
    ranked = router.rank("alpha")
    assert ranked[-1].addr == "h1:1"
    assert len(ranked) == 3
    # different uids spread across replicas (rendezvous, not all-on-one)
    tops = {router.rank(f"uid{i}")[0].addr for i in range(32)}
    assert len(tops) >= 2
    # the same order as the JAX package's router for the same uids
    jrouter = JClusterRouter(["h1:1", "h2:1", "h3:1"])
    jrouter.replicas[0].healthy = False
    for i in range(32):
        assert ([r.addr for r in router.rank(f"uid{i}")]
                == [r.addr for r in jrouter.rank(f"uid{i}")])


def test_failover_to_live_replica():
    dead_port = _free_port()  # nothing listening
    with ServerHarness() as live:
        with RouterHarness([dead_port, live.port]) as r:
            # whatever the hash prefers, only the live replica can accept
            committed = _stream_through(r.port)
            assert committed
            st = r.router.status()
            by_addr = {b["addr"]: b for b in st["backends"]}
            assert by_addr[f"127.0.0.1:{dead_port}"]["healthy"] is False


def test_capacity_wait_fails_over_to_other_replica():
    """Replica A full (max_clients=0 -> immediate WAIT) must not strand
    the session: the router retries replica B and the client streams."""
    with ServerHarness(max_clients=0) as full, ServerHarness() as open_:
        with RouterHarness([full.port, open_.port]) as r:
            committed = _stream_through(r.port)
            assert committed, "session stranded on the full replica"


def test_no_backend_available_sends_error():
    import json as _json

    from websockets.sync.client import connect

    dead = _free_port()
    with RouterHarness([dead]) as r:
        with connect(f"ws://127.0.0.1:{r.port}", open_timeout=5) as ws:
            ws.send(_json.dumps({"uid": "x", "language": "en", "task":
                                 "transcribe", "model": "small"}))
            msg = _json.loads(ws.recv(timeout=10))
            assert msg.get("status") == "ERROR"
