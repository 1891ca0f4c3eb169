"""The port stands alone: no module of whisperlive_tpu_torch, and nothing in
chip_smoke.py, imports jax or any module of the JAX package.

A subprocess installs a meta-path finder that refuses `jax`, `jaxlib` and
every `whisperlive_tpu.` module, then imports every module of the port and
chip_smoke.py. The host modules the port keeps its own copies of
(tokenizer, session, VAD) are also held against the originals on a few
inputs.
"""

import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace
from pathlib import Path

import numpy as np
import pytest

from whisperlive_tpu.audio import vad as jvad
from whisperlive_tpu.engine import tokenizer as jtok
from whisperlive_tpu.serving import session as jsession
from whisperlive_tpu_torch.audio import vad as tvad
from whisperlive_tpu_torch.engine import tokenizer as ttok
from whisperlive_tpu_torch.serving import session as tsession

ROOT = Path(__file__).resolve().parents[1]

_PROBE = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "whisperlive_tpu"):
                raise ImportError(f"the port must not import {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import whisperlive_tpu_torch

    names = ["whisperlive_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            whisperlive_tpu_torch.__path__, "whisperlive_tpu_torch.")
    ]
    for name in names:
        importlib.import_module(name)
    importlib.import_module("chip_smoke")
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "whisperlive_tpu"))
    assert not bad, bad
    print("IMPORTED", len(names))
    """
)


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = int(proc.stdout.split("IMPORTED")[1])
    assert n >= 30  # every module of the package, not an empty walk


@pytest.mark.parametrize("multilingual", [True, False])
def test_tokenizer_copy_matches_original(multilingual):
    vocab = 51865 if multilingual else 51864
    a = jtok.WhisperTokenizer(jtok.TokenSpec(vocab, multilingual=multilingual),
                              language="fr" if multilingual else None)
    b = ttok.WhisperTokenizer(ttok.TokenSpec(vocab, multilingual=multilingual),
                              language="fr" if multilingual else None)
    for text in ("hello world", " Ça va? 123", ""):
        assert b.encode(text) == a.encode(text)
    assert b.sot_sequence() == a.sot_sequence()
    assert b.sot_sequence(include_timestamps=False) == a.sot_sequence(include_timestamps=False)
    for attr in ("eot", "sot_prev", "no_speech", "timestamp_begin"):
        assert getattr(b, attr) == getattr(a, attr)
    assert b.decode([10, 20, 300]) == a.decode([10, 20, 300])
    assert b.spec.language_codes == a.spec.language_codes
    for sup in ((-1,), (5, 9), None):
        assert ttok.get_suppressed_tokens(b, sup) == jtok.get_suppressed_tokens(a, sup)


def test_session_copy_matches_original():
    assert vars(tsession.SessionOptions()) == vars(jsession.SessionOptions())
    seg = dict(start=1.0, end=2.5, text=" hi", completed=True)
    assert tsession.format_segment(**seg) == jsession.format_segment(**seg)

    segs = [SimpleNamespace(start=0.0, end=1.0, text=" one", tokens=[], no_speech_prob=0.0,
                            words=None),
            SimpleNamespace(start=1.0, end=1.8, text=" two", tokens=[], no_speech_prob=0.0,
                            words=None)]
    audio = (np.random.default_rng(1).standard_normal(16000 * 3) * 0.1).astype(np.float32)
    outs = []
    for mod in (jsession, tsession):
        s = mod.StreamingSession(mod.SessionOptions(same_output_threshold=1))
        s.add_frames(audio)
        chunk, offset = s.get_audio_chunk_for_processing()
        trace = [len(chunk), offset, s.buffered_duration()]
        for _ in range(3):  # a repeated last segment is committed
            trace.append(s.update_segments(segs, 1.8))
            trace.append(s.prepare_segments())
        trace.append(s.timestamp_offset)
        outs.append(trace)
    assert outs[1] == outs[0]


def test_vad_copy_matches_original():
    rng = np.random.default_rng(0)
    t = np.arange(16000 * 2) / 16000.0
    speech = (0.1 * np.sin(2 * np.pi * 150 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)))
    chunks = [
        np.zeros(16000, np.float32),
        (rng.standard_normal(16000) * 0.01).astype(np.float32),
        speech.astype(np.float32),
    ]
    a, b = jvad.VoiceActivityDetector(threshold=0.5), tvad.VoiceActivityDetector(threshold=0.5)
    assert type(b._model).__name__ == type(a._model).__name__ == "SileroShapedVAD"
    for chunk in chunks:
        a.reset()
        b.reset()
        assert b(chunk) == a(chunk)
    ts_a = jvad.get_speech_timestamps(chunks[2])
    ts_b = tvad.get_speech_timestamps(chunks[2])
    assert ts_b == ts_a
