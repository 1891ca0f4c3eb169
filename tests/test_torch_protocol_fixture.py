"""The shared wire-protocol fixture (clients/protocol_fixture.json) held
against the port's client and server, as tests/test_protocol_fixture.py
holds the JAX package's: the handshake, the segment format, the wire
constants and the status literals of the port's serving sources. The
handshake and the segment are also held equal to the JAX package's.
"""

import json
import os
from unittest import mock

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
FIXTURE = os.path.join(ROOT, "clients", "protocol_fixture.json")


@pytest.fixture(scope="module")
def protocol():
    with open(FIXTURE) as f:
        return json.load(f)


def _client_handshake(client_cls):
    sent = []
    with mock.patch("websocket.WebSocketApp"), mock.patch("threading.Thread"):
        c = client_cls(host="h", port=1, lang="en")
    ws = mock.MagicMock()
    ws.send = lambda payload, *a: sent.append(payload)
    c.on_open(ws)
    return json.loads(sent[0])


def test_client_handshake_matches_fixture(protocol):
    from whisperlive_tpu.client.client import Client as JClient
    from whisperlive_tpu_torch.client.client import Client

    handshake = _client_handshake(Client)
    for key in protocol["handshake_required"]:
        assert key in handshake, f"missing required handshake key {key}"
    allowed = set(protocol["handshake_required"] + protocol["handshake_optional"])
    unknown = set(handshake) - allowed
    assert not unknown, f"handshake keys not in fixture: {unknown}"
    assert handshake["task"] in protocol["task_values"]
    want = _client_handshake(JClient)
    assert {k: v for k, v in handshake.items() if k != "uid"} == {
        k: v for k, v in want.items() if k != "uid"}


def test_segment_format_matches_fixture(protocol):
    from whisperlive_tpu.serving.session import format_segment as jformat
    from whisperlive_tpu_torch.serving.session import format_segment

    seg = format_segment(0.0, 1.23, " hello world", completed=False)
    for key in protocol["segment_required_keys"]:
        assert key in seg
    allowed = set(protocol["segment_required_keys"] + protocol["segment_optional_keys"])
    assert set(seg) <= allowed
    # "%.3f"-formatted second strings: the byte-level detail clients key on
    assert seg["start"] == "0.000"
    assert seg["end"] == "1.230"
    assert seg == jformat(0.0, 1.23, " hello world", completed=False)
    example = protocol["example_segment"]
    assert set(example) <= allowed
    assert example["start"] == "%.3f" % float(example["start"])


def test_wire_constants_match_fixture(protocol):
    from whisperlive_tpu_torch.client import client as tclient
    from whisperlive_tpu_torch.serving import server as tserver

    assert protocol["end_of_audio"] == "END_OF_AUDIO"
    assert protocol["server_ready_message"] == "SERVER_READY"
    assert protocol["disconnect_message"] == "DISCONNECT"
    assert set(protocol["server_status_values"]) == {"WAIT", "ERROR", "WARNING"}
    assert protocol["pcm"]["sample_rate"] == 16000
    # the port's modules speak the same constants
    for module in (tclient, tserver):
        with open(module.__file__) as f:
            assert protocol["end_of_audio"] in f.read()


def test_server_uses_fixture_status_values(protocol):
    """The port's server must carry the WAIT / READY / DISCONNECT literals
    verbatim (a grep-level guard against renames)."""
    src_dir = os.path.join(ROOT, "whisperlive_tpu_torch", "serving")
    blob = ""
    for name in ("server.py", "session.py"):
        with open(os.path.join(src_dir, name)) as f:
            blob += f.read()
    assert '"WAIT"' in blob
    assert protocol["server_ready_message"] in blob
    assert protocol["disconnect_message"] in blob
    assert protocol["end_of_audio"] in blob
