"""Wire-protocol robustness of the port's server: malformed input must never
take it down; at worst it costs the offending connection.

The cases of tests/test_server_robustness.py, run against the port's
serving/server.py (FakeBackend, real websockets): after each bad client, a
well-formed session on the same server must still get segments, and the
bad client must no longer hold a seat.
"""

import asyncio
import json
import time

import numpy as np
import pytest

from tests.test_torch_server_e2e import ServerHarness


@pytest.fixture()
def server():
    with ServerHarness() as h:
        yield h


def _url(server):
    return f"ws://127.0.0.1:{server.port}"


async def _handshake(ws, uid="ok"):
    await ws.send(json.dumps({"uid": uid, "language": "en", "task": "transcribe",
                              "use_vad": False}))
    msg = json.loads(await asyncio.wait_for(ws.recv(), timeout=10))
    assert msg.get("message") == "SERVER_READY"


async def _stream_and_get_segments(server, uid="ok"):
    """A well-formed session must still work: the survival check."""
    import websockets

    async with websockets.connect(_url(server)) as ws:
        await _handshake(ws, uid)
        audio = (np.random.default_rng(0).standard_normal(32000) * 0.1).astype(np.float32)
        await ws.send(audio.tobytes())
        deadline = asyncio.get_event_loop().time() + 15
        while asyncio.get_event_loop().time() < deadline:
            msg = json.loads(await asyncio.wait_for(ws.recv(), timeout=10))
            if msg.get("segments"):
                return msg["segments"]
    raise AssertionError("no segments from the healthy client")


def _seats_freed(server, timeout_s=5.0):
    """Every connection has closed: the client manager holds no client."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if not server.server.client_manager.clients:
            return True
        time.sleep(0.05)
    return False


def test_garbage_handshake_does_not_kill_server(server):
    import websockets

    async def drive():
        # non-JSON binary garbage as the handshake frame
        async with websockets.connect(_url(server)) as ws:
            await ws.send(b"\xff\xfe\x00 not json at all")
            with pytest.raises(Exception):  # the server closes the connection
                await asyncio.wait_for(ws.recv(), timeout=10)
        assert await _stream_and_get_segments(server)

    asyncio.run(drive())
    assert _seats_freed(server)


def test_wrong_typed_handshake_fields_survive(server):
    import websockets

    async def drive():
        async with websockets.connect(_url(server)) as ws:
            # valid JSON, hostile types: the accept path must not crash
            await ws.send(json.dumps({"uid": 12345, "language": 42, "use_vad": "yes",
                                      "send_last_n_segments": "many"}))
            try:
                await asyncio.wait_for(ws.recv(), timeout=10)
            except Exception:
                pass  # a reply or a close are both acceptable
        assert await _stream_and_get_segments(server)

    asyncio.run(drive())
    assert _seats_freed(server)


def test_odd_length_audio_frame_costs_only_that_client(server):
    import websockets

    async def drive():
        async with websockets.connect(_url(server)) as ws:
            await _handshake(ws, uid="bad-bytes")
            await ws.send(b"\x01\x02\x03")  # not a multiple of 4 (float32)
            try:  # that connection is torn down...
                while True:
                    await asyncio.wait_for(ws.recv(), timeout=5)
            except Exception:
                pass
        # ...while the server keeps serving everyone else
        assert await _stream_and_get_segments(server, uid="healthy")

    asyncio.run(drive())
    assert _seats_freed(server)


def test_abrupt_disconnect_mid_stream(server):
    import websockets

    async def drive():
        ws = await websockets.connect(_url(server))
        await _handshake(ws, uid="rude")
        await ws.send(np.zeros(16000, np.float32).tobytes())
        # close the TCP socket without a websocket close handshake
        ws.transport.abort()
        await asyncio.sleep(0.5)
        assert await _stream_and_get_segments(server, uid="next")

    asyncio.run(drive())
    assert _seats_freed(server)
