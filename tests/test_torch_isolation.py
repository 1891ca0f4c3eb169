"""The port stands alone: no module of whisperlive_tpu_torch, and nothing in
chip_smoke.py or kernel_variants.py, imports jax or any module of the JAX package.

A subprocess installs a meta-path finder that refuses `jax`, `jaxlib` and
every `whisperlive_tpu.` module, and the packages the card's machine lacks
(`safetensors`, `orbax`, `optax`, `tokenizers`, `aiohttp`, `websockets`,
`websocket`, `transformers`, `sentencepiece`: the checkpoint reader, the
optimizer and the SMALL100 tokenizer are the port's own, `tokenizers` and
`transformers` are reached only for a checkpoint that needs them, and the
servers', the client's and the cluster router's network packages only
inside the functions that open a connection), then imports every module of
the port (the parallel package, the router and its CLI, the profiler, the
roofline model, the WER harness and the VAD and speaker trainers among
them),
chip_smoke.py and kernel_variants.py. The host modules the port keeps its own copies of
(tokenizer, session, VAD, word alignment, SMALL100 tokenizer, diarization
and its speaker embedders) are also held against the originals on a few
inputs; the alignment copy exactly, on random inputs.
"""

import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace
from pathlib import Path

import numpy as np
import pytest

from whisperlive_tpu import diarization as jdiar
from whisperlive_tpu import small100_tokenizer as jspm
from whisperlive_tpu.audio import speaker_model as jsm
from whisperlive_tpu.audio import vad as jvad
from whisperlive_tpu.audio import wespeaker as jws
from whisperlive_tpu.engine import align as jalign
from whisperlive_tpu.engine import tokenizer as jtok
from whisperlive_tpu.serving import session as jsession
from whisperlive_tpu_torch import diarization as tdiar
from whisperlive_tpu_torch import small100_tokenizer as tspm
from whisperlive_tpu_torch.audio import speaker_model as tsm
from whisperlive_tpu_torch.audio import vad as tvad
from whisperlive_tpu_torch.audio import wespeaker as tws
from whisperlive_tpu_torch.engine import align as talign
from whisperlive_tpu_torch.engine import tokenizer as ttok
from whisperlive_tpu_torch.serving import session as tsession

ROOT = Path(__file__).resolve().parents[1]

_PROBE = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    REFUSED = ("jax", "jaxlib", "whisperlive_tpu", "safetensors", "orbax", "optax",
               "tokenizers", "aiohttp", "websockets", "websocket", "transformers",
               "sentencepiece")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in REFUSED:
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
    importlib.import_module("kernel_variants")
    bad = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    assert not bad, bad
    print("IMPORTED", " ".join(names))
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
    names = proc.stdout.split("IMPORTED")[1].split()
    assert len(names) >= 30  # every module of the package, not an empty walk
    for name in ("training", "distill", "cli.distill", "serving.rest", "translation",
                 "models.m2m100", "diarization", "client.client", "cli.run_client",
                 "parallel", "parallel.mesh", "parallel.multihost", "parallel.serve_multihost",
                 "serving.cluster", "cli.run_cluster", "utils.profiling", "utils.roofline",
                 "utils.wer", "cli.eval_wer", "cli.train_vad", "cli.train_speaker"):
        assert f"whisperlive_tpu_torch.{name}" in names


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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_align_copy_matches_original(seed):
    """dtw_path, the median filter, find_alignment_from_attn,
    merge_punctuations, the anomaly scores and words_for_segment of the
    port's copy give exactly the original's results on random inputs."""
    rng = np.random.default_rng(seed)
    cost = rng.standard_normal((7 + seed, 20 + 3 * seed))
    for a, b in zip(talign.dtw_path(cost), jalign.dtw_path(cost)):
        np.testing.assert_array_equal(a, b)
    x = rng.standard_normal((3, 5, 40)).astype(np.float32)
    for width in (1, 7, 41):
        np.testing.assert_array_equal(talign._median_filter(x, width),
                                      jalign._median_filter(x, width))

    tok_t = ttok.WhisperTokenizer(ttok.TokenSpec(51865, multilingual=True))
    tok_j = jtok.WhisperTokenizer(jtok.TokenSpec(51865, multilingual=True))
    text = tok_t.encode(" hello, world. how are (you) today?")
    sot_len = 3
    t = sot_len + len(text) + 1
    attn = rng.random((4, 2, t, 300)).astype(np.float32)
    probs = rng.random(len(text))

    def run(mod, tok):
        timings = mod.find_alignment_from_attn(attn, probs, tok, text, sot_len, num_frames=500)
        merged = mod.merge_punctuations(mod.find_alignment_from_attn(
            attn, probs, tok, text, sot_len, num_frames=500))
        words = mod.words_for_segment(merged, 0.5, 4.0)
        return ([vars(w) for w in timings], [vars(w) for w in merged],
                [vars(w) for w in words], [mod.word_anomaly_score(w) for w in merged],
                mod.is_segment_anomaly(merged))

    assert run(talign, tok_t) == run(jalign, tok_j)


def test_small100_tokenizer_copy_matches_original(tmp_path):
    u = "\u2581"
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3), (u, -1.0, 1),
              ("a", -2.0, 1), ("b", -2.0, 1), ("ab", -0.5, 1), (u + "ab", -0.2, 1)]
    tspm.write_spm_model(str(tmp_path / "t.model"), pieces)
    jspm.write_spm_model(str(tmp_path / "j.model"), pieces)
    assert (tmp_path / "t.model").read_bytes() == (tmp_path / "j.model").read_bytes()
    read = tspm.read_spm_model(str(tmp_path / "t.model"))
    assert read == jspm.read_spm_model(str(tmp_path / "t.model"))
    a, b = tspm.SPMBpe(read), jspm.SPMBpe(read)
    for text in ("ab ba abab", "  b", "xyz ab"):
        assert a.encode(text) == b.encode(text)
        assert tspm.SPMBpe.decode(a.encode(text)) == jspm.SPMBpe.decode(b.encode(text))
    assert tspm.FAIRSEQ_LANGUAGE_CODES == jspm.FAIRSEQ_LANGUAGE_CODES
    assert tspm.is_small100_checkpoint(str(tmp_path)) == jspm.is_small100_checkpoint(
        str(tmp_path))


def test_diarization_copies_match_originals():
    audio = (np.random.default_rng(4).standard_normal(16000) * 0.1).astype(np.float32)
    pairs = [(tdiar.SpectralEmbedder(), jdiar.SpectralEmbedder()),
             (tsm.LearnedSpeakerEmbedder(), jsm.LearnedSpeakerEmbedder()),
             (tws.WeSpeakerEmbedder(), jws.WeSpeakerEmbedder())]
    for ours, ref in pairs:
        np.testing.assert_array_equal(ours(audio), ref(audio))
    for name in ("SAMPLE_RATE", "MIN_AUDIO_S", "SIMILARITY_THRESHOLD", "EMA_KEEP"):
        assert getattr(tdiar, name) == getattr(jdiar, name)
    assert vars(tws.LITE) == vars(jws.LITE) and vars(tws.R34) == vars(jws.R34)
