"""The port's server CLI passes the reference's serving flags on to the server.

`--api_key` (default: the WL_API_KEY environment variable), `--metrics_port`
and `--raw_pcm_input` are parsed as in whisperlive_tpu/cli/run_server.py and
reach TranscriptionServer: the key and the metrics port as arguments of
`run`, the PCM format as the server's `raw_pcm_default`. The backend and the
server's loop are replaced, so no model is built and no socket is opened.
"""

import pytest

from whisperlive_tpu_torch.cli import run_server
from whisperlive_tpu_torch.serving.server import TranscriptionServer


@pytest.fixture
def served(monkeypatch):
    seen = {}

    def fake_run(self, backend, **kw):
        seen.update(kw, backend=backend, raw_pcm_default=self.raw_pcm_default)

    monkeypatch.setattr(TranscriptionServer, "run", fake_run)
    monkeypatch.setattr(run_server, "create_backend", lambda args: "backend")
    monkeypatch.setattr(run_server, "stop_backend", lambda backend: seen.update(stopped=backend))
    return seen


def test_api_key_from_env_metrics_port_and_pcm_reach_the_server(monkeypatch, served):
    monkeypatch.setenv("WL_API_KEY", "s3cret")
    run_server.main(["--metrics_port", "9464", "--raw_pcm_input", "int16"])
    assert served["api_key"] == "s3cret"
    assert served["metrics_port"] == 9464
    assert served["raw_pcm_default"] == "int16"
    assert served["backend"] == "backend" and served["stopped"] == "backend"


def test_flags_default_as_the_reference(monkeypatch, served):
    monkeypatch.delenv("WL_API_KEY", raising=False)
    run_server.main([])
    assert served["api_key"] is None and served["metrics_port"] is None
    assert served["raw_pcm_default"] == "float32"


def test_api_key_flag_overrides_env(monkeypatch, served):
    monkeypatch.setenv("WL_API_KEY", "from-env")
    run_server.main(["--api_key", "from-flag"])
    assert served["api_key"] == "from-flag"
