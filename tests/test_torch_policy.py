"""Policies of the port: no JAX import, no quiet CPU run, refusals of
configurations it cannot run (a tp that does not divide the heads), what it
takes (int4 cross-KV, beam search, word
alignment, WL_BEAM_CHUNK), and chip_smoke.py's refusal to run without a
card."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_model import small_configs
from whisperlive_tpu_torch import device as device_policy
from whisperlive_tpu_torch.engine.engine import TranscribeOptions, WhisperEngine
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.parallel.mesh import EngineShardings

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]

IMPORT_ALL_WITHOUT_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax`, however indirect, now fails
import whisperlive_tpu_torch
names = [m.name for m in pkgutil.walk_packages(whisperlive_tpu_torch.__path__,
                                               "whisperlive_tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
print(len(names))
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL_WITHOUT_JAX], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15  # every module of the package was imported


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        device_policy.resolve_device("cuda")
    _, tcfg = small_configs()
    with pytest.raises(RuntimeError, match="cuda"):
        WhisperEngine(tcfg, {}, device="cuda")
    assert device_policy.resolve_device("cpu").type == "cpu"
    assert device_policy.default_compute_dtype(torch.device("cuda")) == torch.bfloat16
    assert device_policy.default_compute_dtype(torch.device("cpu")) == torch.float32
    assert device_policy.default_quantized(torch.device("cuda"))


@pytest.fixture(scope="module")
def tiny_params():
    _, tcfg = small_configs()
    return tcfg, tw.init_params(tcfg, 0)


@pytest.mark.parametrize("kw,error,match", [
    (dict(cross_kv_bits=4, shardings=EngineShardings(tp=3)), ValueError,
     "must divide attention heads"),
    (dict(shardings=object()), TypeError, "EngineShardings"),
])
def test_engine_refuses_unported_configurations(tiny_params, kw, error, match):
    """Shardings are ported (parallel/mesh.py): what stays refused is a
    tensor-parallel degree that does not divide the heads, and a sharding
    that is not the port's rank description."""
    tcfg, params = tiny_params
    with pytest.raises(error, match=match):
        WhisperEngine(tcfg, params, device="cpu", **kw)


@pytest.mark.parametrize("kw,env", [(dict(cross_kv_bits=4), {}), ({}, {"WL_CROSS_BITS": "4"})])
def test_engine_takes_int4_cross_kv(tiny_params, monkeypatch, kw, env):
    """cross_kv_bits=4 (or WL_CROSS_BITS=4, read once at construction)
    builds an int4 engine whose prepare packs two nibbles per byte."""
    tcfg, params = tiny_params
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    eng = WhisperEngine(tcfg, params, device="cpu", batch_buckets=(1,), **kw)
    assert eng.cross_kv_bits == 4
    _, cross = eng.prepare(np.zeros((1, 480000), np.float32))
    assert set(cross) == {"kv4", "scale"} and cross["kv4"].dtype == torch.int8
    l, b, h, t = tcfg.n_text_layer, 1, tcfg.n_text_head, tcfg.n_audio_ctx
    assert tuple(cross["kv4"].shape) == (l, 2, b, h, t, tcfg.head_dim // 2)


@pytest.mark.parametrize("kw,env", [(dict(cross_kv_bits=4), {"WL_CROSS_BITS": "4"}), ({}, {})])
def test_engine_takes_beam_chunk(tiny_params, monkeypatch, kw, env):
    """WL_BEAM_CHUNK is read once at construction and pins the chunk:
    enable_beam_chunk (hybrid beam serving) then leaves it alone; without
    it the engine decodes monolithically until a caller opts in."""
    tcfg, params = tiny_params
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setenv("WL_BEAM_CHUNK", "24")
    eng = WhisperEngine(tcfg, params, device="cpu", batch_buckets=(1,), **kw)
    assert eng.beam_chunk == 24
    eng.enable_beam_chunk(8)
    assert eng.beam_chunk == 24
    monkeypatch.setenv("WL_BEAM_CHUNK", "0")
    assert WhisperEngine(tcfg, params, device="cpu", **kw).beam_chunk == 0
    monkeypatch.delenv("WL_BEAM_CHUNK")
    eng = WhisperEngine(tcfg, params, device="cpu", **kw)
    assert eng.beam_chunk == 0
    eng.enable_beam_chunk(8)
    assert eng.beam_chunk == 8


def test_engine_takes_beam_search_and_alignment(tiny_params):
    tcfg, params = tiny_params
    eng = WhisperEngine(tcfg, params, device="cpu", batch_buckets=(1,))
    assert eng.cross_kv_bits == 16 and not eng.decoder_int8  # CPU defaults
    audio = np.zeros((1, 480000), np.float32)
    prompt, sot = eng.build_prompt(TranscribeOptions(language="en"))
    beam = TranscribeOptions(language="en", beam_size=2, temperatures=(0.0,),
                             max_new_tokens=6)
    (res,), _, cross = eng.transcribe_batch(audio, [prompt], [sot], [True], beam)
    assert 0 < len(res.tokens) <= 6 and np.isfinite(res.avg_logprob)
    eng.warmup(batch_sizes=[1], options=beam)
    timings = eng.align_words(cross, 0, [int(t) for t in res.tokens] or [1000], 100)
    assert all(0.0 <= w.start <= w.end for w in timings)


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    hidden = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=120, env=hidden)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    # alone in a directory, without the package beside it, it cannot run either
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
