"""The port's offline CLIs, server checkpoint flags and audio files against
the JAX package's.

One random `transformers` Whisper checkpoint (vocab 51865, width 64, 4
heads, 2 + 2 layers, 80 mels) with a `tokenizer.json` whose every id
decodes to its own visible word " t<id>" (a word-level vocabulary, so that
random weights give text and word timings), saved to a temporary directory;
nothing is downloaded. Both CLIs run on the CPU (`--device cpu` for the
port) with their own loaders, in float32; their outputs must be equal byte
for byte (txt, srt, vtt, `--batched`, `--draft_path`), and json with word
timestamps equal but for its probabilities (within 1e-5 for the language,
1e-4 for words: float32 sums in another order). The convert CLI's dir transcribes as the HF dir does; the
server's checkpoint flags load the dir's weights. WAV files (8/16/32-bit,
stereo), resample_audio and the FLAC decoder (streams from a small writer
below, VERBATIM and FIXED subframes, mono and left/side stereo) must equal
the JAX package's exactly.
"""

import functools
import json
import logging
import os
import re
import sys
import wave

import numpy as np
import pytest
import torch

from tests.test_torch_convert import hf_checkpoint
from whisperlive_tpu.audio import flac as jflac
from whisperlive_tpu.audio import io as jio
from whisperlive_tpu.cli import transcribe as jcli
from whisperlive_tpu_torch import loader as tloader
from whisperlive_tpu_torch.audio import flac as tflac
from whisperlive_tpu_torch.audio import io as tio
from whisperlive_tpu_torch.cli import convert as tconvert_cli
from whisperlive_tpu_torch.cli import run_server
from whisperlive_tpu_torch.cli import transcribe as tcli
from whisperlive_tpu_torch.models import convert as tconvert

torch.set_num_threads(2)

FLAGS = ["--model", "tiny", "--no_gates", "--language", "en", "--max_new_tokens", "16"]


def write_tokenizer(path, n_vocab=51865):
    """A word-level tokenizer.json: id i decodes to " t<i>" (byte-level
    pieces keep the leading space, so each token starts a word)."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel({f"Ġt{i}": i for i in range(n_vocab)},
                                     unk_token="Ġt0"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.decoder = decoders.ByteLevel()
    tok.save(str(path))


def speech_like(seconds, seed=0):
    t = np.arange(int(16000 * seconds)) / 16000.0
    rng = np.random.default_rng(seed)
    f0 = 140 + 40 * np.sin(2 * np.pi * 2.1 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
    sig = sig * (0.55 + 0.45 * np.sin(2 * np.pi * 3.7 * t)) + 0.02 * rng.standard_normal(t.shape)
    return (0.12 * sig / np.max(np.abs(sig))).astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(HF dir, draft HF dir, [35 s wav, 12 s wav]); the draft shares the
    encoder geometry with one decoder layer."""
    root = tmp_path_factory.mktemp("offline")
    hf, _ = hf_checkpoint(root / "hf")
    draft, _ = hf_checkpoint(root / "draft", seed=2, decoder_layers=1)
    for d in (hf, draft):
        write_tokenizer(os.path.join(d, "tokenizer.json"))
    wavs = []
    for i, seconds in enumerate((35.0, 12.0)):
        path = str(root / f"clip{i}.wav")
        tio.write_wav(path, speech_like(seconds, i))
        wavs.append(path)
    return hf, draft, wavs


@functools.lru_cache(maxsize=None)
def engines(hf):
    """Each package's engine, loaded once through its own loader."""
    from whisperlive_tpu.loader import load_engine

    return load_engine("tiny", hf), tloader.load_engine("tiny", hf, device="cpu")


def run_both(monkeypatch, tmp_path, argv, cached=None):
    """Both CLIs on the same argument list (the port's with --device cpu),
    each writing into its own dir; returns {file name: (jax, port)}."""
    if cached is not None:
        je, te = engines(cached)
        monkeypatch.setattr(jcli, "_load_engine", lambda *a, **k: je)
        monkeypatch.setattr(tloader, "load_engine", lambda *a, **k: te)
    outs = []
    for name, main, extra in (("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])):
        out = tmp_path / name
        assert main([*argv, "-o", str(out), *extra]) == 0
        outs.append({f: (out / f).read_text() for f in sorted(os.listdir(out))})
    assert outs[0].keys() == outs[1].keys() and outs[0]
    return {f: (outs[0][f], outs[1][f]) for f in outs[0]}


@pytest.mark.parametrize("fmt", ["txt", "srt", "vtt", "json"])
def test_transcribe_cli_matches_jax(files, monkeypatch, tmp_path, fmt):
    hf, _, wavs = files
    argv = [wavs[0], *FLAGS, "-tpu", hf, "-f", fmt]
    if fmt == "json":
        argv.append("--word_timestamps")
    for name, (j, t) in run_both(monkeypatch, tmp_path, argv, cached=hf).items():
        assert re.search(r"t\d+", t)  # visible text
        if fmt != "json":
            assert t == j, name
            continue
        assert_same_json(json.loads(j), json.loads(t))
        assert '"words"' in t


def assert_same_json(j, t):
    """Equal but for the probabilities, which float32 sums in another order
    leave within 1e-5 (language) and 1e-4 (words)."""
    assert abs(t.pop("language_probability") - j.pop("language_probability")) <= 1e-5
    for seg in (*t["segments"], *j["segments"]):
        seg["probs"] = [w.pop("probability") for w in seg.get("words", [])]
    for a, b in zip(j["segments"], t["segments"]):
        np.testing.assert_allclose(b.pop("probs"), a.pop("probs"), atol=1e-4, rtol=0)
    assert t == j


def test_batched_cli_matches_jax(files, monkeypatch, tmp_path):
    hf, _, wavs = files
    out = run_both(monkeypatch, tmp_path, [*wavs, *FLAGS, "-tpu", hf, "-f", "json",
                                            "--batched"], cached=hf)
    assert sorted(out) == ["clip0.json", "clip1.json"]
    for j, t in out.values():
        assert t == j


def test_draft_path_cli_matches_jax(files, monkeypatch, tmp_path, caplog):
    """--draft_path loads the draft through each package's own loader; the
    speculative seek loop is token-exact."""
    hf, draft, wavs = files
    with caplog.at_level(logging.INFO):
        out = run_both(monkeypatch, tmp_path, [wavs[1], *FLAGS, "-tpu", hf, "-f", "json",
                                                "--draft_path", draft])
    for j, t in out.values():
        assert t == j
    spec_lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith(
        "speculative:")]
    assert len(spec_lines) == 2 and spec_lines[0] == spec_lines[1]


def test_unknown_model_exits(files, tmp_path):
    _, _, wavs = files
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="unknown model size"):
            main([wavs[1], "--model", "huge", *extra])


def test_convert_cli_end_to_end(files, monkeypatch, tmp_path, caplog):
    """HF dir -> converted dir (with --verify); the converted dir
    transcribes exactly as the HF dir; a failed parity check and a missing
    transformers are reported."""
    hf, _, wavs = files
    out = str(tmp_path / "converted")
    with caplog.at_level(logging.INFO):
        tconvert_cli.main([hf, "-o", out, "--verify"])
    assert any("encoder parity max abs err" in r.getMessage() for r in caplog.records)
    assert sorted(os.listdir(out)) == ["config.json", "params.safetensors", "tokenizer.json"]
    texts = []
    for ckpt in (hf, out):
        dest = tmp_path / os.path.basename(ckpt)
        assert tcli.main([wavs[1], *FLAGS, "-tpu", ckpt, "-f", "srt", "-o", str(dest),
                          "--device", "cpu"]) == 0
        texts.append((dest / "clip1.srt").read_text())
    assert texts[0] == texts[1] and texts[0]

    monkeypatch.setattr(tconvert_cli, "verify_encoder", lambda *a: 1.0)
    with pytest.raises(SystemExit, match="parity check failed"):
        tconvert_cli.main([hf, "-o", str(tmp_path / "bad"), "--verify"])
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "transformers", None)
    with caplog.at_level(logging.WARNING):
        tconvert_cli.main([hf, "-o", str(tmp_path / "unverified"), "--verify"])
    assert any("transformers is not installed" in r.getMessage() for r in caplog.records)
    assert os.path.exists(tmp_path / "unverified" / "params.safetensors")


@pytest.mark.parametrize("flag", ["-tpu", "-fw", "-trt"])
def test_server_checkpoint_flags_load_the_dir(files, flag):
    """Each of the reference's checkpoint flags serves the dir's weights
    (the first non-empty of -tpu, -fw, -trt wins), and --draft_path the
    draft's; --cache_path is accepted with the reference's default."""
    hf, draft, _ = files
    argv = ["--model", "tiny", "--device", "cpu", "--no_warmup", "--no_continuous_batching",
            flag, hf, "--draft_path", draft, "-c", "/tmp/cache"]
    args = run_server.build_parser().parse_args(argv)
    assert args.cache_path == "/tmp/cache"
    assert run_server.build_parser().parse_args([]).cache_path == "~/.cache/whisper-live-tpu/"
    _, tree, tok = tloader.resolve_model("tiny", hf, device="cpu")
    _, dtree, _ = tloader.resolve_model("tiny", draft, device="cpu")
    backend = run_server.create_backend(args)
    try:
        eng = backend.scheduler.engine
        assert eng.cfg.n_audio_state == 64 and eng.tokenizer.decode([5]) == tok.decode([5])
        assert torch.equal(eng.params["decoder"]["embed"], tree["decoder"]["embed"])
        spec = backend.scheduler.spec_decoder
        assert spec is not None and spec.draft.cfg.n_text_layer == 1
        assert torch.equal(spec.draft.params["decoder"]["embed"], dtree["decoder"]["embed"])
        assert backend.model_name == hf
    finally:
        run_server.stop_backend(backend)


def test_server_warns_on_a_draft_distilled_at_another_context(files, tmp_path, caplog):
    _, draft, _ = files
    cfg, tree = tconvert.load_hf_checkpoint(draft)
    out = str(tmp_path / "draft512")
    tconvert.save_converted(out, cfg, tree, extra_meta={"distill_enc_ctx": 512})
    argv = ["--draft_path", out]
    with caplog.at_level(logging.WARNING):
        run_server.warn_draft_ctx(run_server.build_parser().parse_args(argv), False)
    assert any("enc_ctx=512" in r.getMessage() for r in caplog.records)
    tconvert.save_converted(out, cfg, tree, extra_meta={"distill_enc_ctx": 1500})
    with pytest.raises(SystemExit, match="enc_ctx=1500"):
        run_server.warn_draft_ctx(
            run_server.build_parser().parse_args([*argv, "--continuous_spec"]), True)


# ---------------------------------------------------------------------------
# audio files
# ---------------------------------------------------------------------------


def write_pcm_wav(path, pcm, width, rate, channels):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


@pytest.mark.parametrize("width,rate,channels", [(1, 16000, 1), (2, 16000, 1), (4, 16000, 1),
                                                 (2, 44100, 2), (2, 8000, 1)])
def test_wav_files_match_jax(tmp_path, width, rate, channels):
    rng = np.random.default_rng(width * rate + channels)
    n = rate // 2 * channels
    pcm = {1: lambda: rng.integers(0, 256, n).astype(np.uint8),
           2: lambda: rng.integers(-32768, 32767, n).astype(np.int16),
           4: lambda: rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)}[width]()
    path = tmp_path / "x.wav"
    write_pcm_wav(path, pcm, width, rate, channels)
    audio, sr = tio.read_wav(str(path))
    ref, ref_sr = jio.read_wav(str(path))
    assert sr == ref_sr == rate and audio.dtype == np.float32
    np.testing.assert_array_equal(audio, ref)
    assert len(audio) == rate // 2
    np.testing.assert_array_equal(tio.read_wav(path.read_bytes())[0], ref)
    np.testing.assert_array_equal(tio.load_audio(str(path)), jio.load_audio(str(path)))


def test_write_wav_and_resample_match_jax(tmp_path):
    audio = speech_like(1.0, 3)
    tio.write_wav(str(tmp_path / "t.wav"), audio)
    jio.write_wav(str(tmp_path / "j.wav"), audio)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    back, sr = tio.read_wav(str(tmp_path / "t.wav"))
    assert sr == 16000 and np.abs(back - audio).max() <= 2 / 32768
    assert tio.float_to_int16_bytes(audio) == jio.float_to_int16_bytes(audio)
    for orig, target in ((8000, 16000), (44100, 16000), (16000, 16000), (48000, 22050)):
        np.testing.assert_array_equal(tio.resample_audio(audio, orig, target),
                                      jio.resample_audio(audio, orig, target))


class BitWriter:
    """MSB-first bit packing for the FLAC writer below."""

    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, n: int) -> None:
        self.bits.extend((value >> i) & 1 for i in range(n - 1, -1, -1))

    def put_signed(self, value: int, n: int) -> None:
        self.put(value & ((1 << n) - 1), n)

    def put_rice(self, residual, k: int) -> None:
        for r in residual:
            v = (int(r) << 1) ^ (int(r) >> 63)  # zigzag
            self.bits.extend([0] * (v >> k) + [1])
            self.put(v & ((1 << k) - 1), k)

    def align(self) -> None:
        self.bits.extend([0] * (-len(self.bits) % 8))

    def to_bytes(self) -> bytes:
        self.align()
        return np.packbits(np.asarray(self.bits, np.uint8)).tobytes()


def flac_subframe(bw, samples, bps, kind):
    """One subframe: VERBATIM, or FIXED order 2 with one Rice partition."""
    bw.put(0, 1)
    if kind == "verbatim":
        bw.put(1, 6)
        bw.put(0, 1)
        for s in samples:
            bw.put_signed(int(s), bps)
        return
    order = 2
    bw.put(8 + order, 6)
    bw.put(0, 1)
    for s in samples[:order]:
        bw.put_signed(int(s), bps)
    s = samples.astype(np.int64)
    residual = s[2:] - (2 * s[1:-1] - s[:-2])
    bw.put(0, 2)  # Rice, 4-bit parameters
    bw.put(0, 4)  # one partition
    k = max(int(np.log2(np.abs(residual).mean() + 1)), 0)
    bw.put(k, 4)
    bw.put_rice(residual, k)


def flac_stream(channels: np.ndarray, kinds, block=1152, bps=16, side=False) -> bytes:
    """A FLAC stream of int PCM [n, ch] at 16 kHz: STREAMINFO, then frames of
    `block` samples whose subframes follow `kinds` in turn; side=True codes a
    stereo frame as left/side."""
    n, nch = channels.shape
    info = BitWriter()
    info.put(block, 16)
    info.put(block, 16)
    info.put(0, 24)
    info.put(0, 24)
    info.put(16000, 20)
    info.put(nch - 1, 3)
    info.put(bps - 1, 5)
    info.put(n, 36)
    info.put(0, 128)  # MD5 (unchecked)
    body = info.to_bytes()
    out = b"fLaC" + bytes([0x80]) + len(body).to_bytes(3, "big") + body
    for f, start in enumerate(range(0, n, block)):
        chunk = channels[start : start + block]
        bw = BitWriter()
        bw.put(0x3FFE, 14)
        bw.put(0, 2)
        bw.put(3 if len(chunk) == 1152 else 7, 4)  # 1152, or 16-bit size at the end
        bw.put(5, 4)  # 16 kHz
        bw.put(8 if side else nch - 1, 4)
        bw.put(4, 3)  # 16 bits per sample
        bw.put(0, 1)
        bw.put(f, 8)  # frame number (< 128: one UTF-8 byte)
        if len(chunk) != 1152:
            bw.put(len(chunk) - 1, 16)
        bw.put(0, 8)  # CRC-8 (unchecked)
        kind = kinds[f % len(kinds)]
        if side:
            flac_subframe(bw, chunk[:, 0], bps, kind)
            flac_subframe(bw, chunk[:, 0] - chunk[:, 1], bps + 1, kind)
        else:
            for c in range(nch):
                flac_subframe(bw, chunk[:, c], bps, kind)
        bw.align()
        bw.put(0, 16)  # CRC-16 (unchecked)
        out += bw.to_bytes()
    return out


@pytest.mark.parametrize("nch,side", [(1, False), (2, False), (2, True)])
def test_flac_decoder_matches_jax(tmp_path, nch, side):
    audio = speech_like(0.2, 5)  # 3200 samples: two full frames and a short one
    pcm = np.stack([np.round(audio * (12000 + 3000 * c)) for c in range(nch)], 1).astype(
        np.int64)
    data = flac_stream(pcm, ("verbatim", "fixed"), side=side)
    decoded, sr = tflac.read_flac_bytes(data)
    ref, ref_sr = jflac.read_flac_bytes(data)
    assert sr == ref_sr == 16000
    np.testing.assert_array_equal(decoded, ref)
    expect = (pcm.astype(np.float64) / 32768.0).mean(axis=1).astype(np.float32)
    np.testing.assert_array_equal(decoded, expect)
    path = tmp_path / "x.flac"
    path.write_bytes(data)
    np.testing.assert_array_equal(tio.load_audio(str(path)), jio.load_audio(str(path)))
