"""The port's roofline model (utils/roofline.py) against the JAX package's.

Every cost function's fields equal JAX's to 1e-12 relative for every
WHISPER_CONFIGS entry over a grid of batch, cache length, cross context and
bits; step_time_roof matches for the same measured-peaks dict. The peaks
are the H100's alone (no TPU entry; the fallback is the nominal H100 pair
unless WL_EFFECTIVE_* override it). measure_effective_peaks at the JAX
test's tiny shapes on the CPU returns the six envelopes, all positive, and
raises when a probe fails. The continuous scheduler's step_cross_pos counts
the cross positions K5 reads: min(cross_len, cross_ctx) for each occupied
slot, times its lanes.
"""

import dataclasses
import itertools

import numpy as np
import pytest

from whisperlive_tpu.models.whisper import WHISPER_CONFIGS as JCONFIGS
from whisperlive_tpu.utils import roofline as jroof
from whisperlive_tpu_torch.engine import continuous as tcont
from whisperlive_tpu_torch.engine.engine import TranscribeOptions, WhisperEngine
from whisperlive_tpu_torch.engine.scheduler import BatchRequest
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.ops import attention as attn_ops
from whisperlive_tpu_torch.utils import roofline as troof

REL = 1e-12
KEYS = {"tflops", "int8_gbps", "int8_geps", "bf16_gbps", "bf16_geps", "int8_mm_gbps"}


def _same(a, b):
    """Every field of two StepCosts (or two floats) equal to REL relative."""
    if isinstance(a, float):
        assert b == pytest.approx(a, rel=REL, abs=0.0)
        return
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fb[k] == pytest.approx(fa[k], rel=REL, abs=0.0), k
    assert b.bytes == pytest.approx(a.bytes, rel=REL, abs=0.0)


@pytest.mark.parametrize("name", sorted(JCONFIGS))
def test_cost_model_matches_jax(name):
    jcfg, tcfg = JCONFIGS[name], tw.WHISPER_CONFIGS[name]
    for batch, cache, ctx, bits, wbits in itertools.product(
            (1, 5, 16), (16, 144, 448), (None, 512, 640), (4, 8, 16), (8, 16)):
        _same(jroof.decode_step_cost(jcfg, batch, cache, ctx, bits, wbits),
              troof.decode_step_cost(tcfg, batch, cache, ctx, bits, wbits))
        pos = batch * (ctx or jcfg.n_audio_ctx) * 0.75
        _same(jroof.continuous_step_cost(jcfg, batch, cache, pos, bits, wbits),
              troof.continuous_step_cost(tcfg, batch, cache, pos, bits, wbits))
    for batch, prompt, ctx in itertools.product((1, 4), (16, 64, 256), (None, 512)):
        _same(jroof.window_insert_flops(jcfg, batch, prompt, ctx),
              troof.window_insert_flops(tcfg, batch, prompt, ctx))
        for bits in (4, 8):
            _same(jroof.window_flops(jcfg, batch, prompt, prompt + 128, 120, ctx, bits),
                  troof.window_flops(tcfg, batch, prompt, prompt + 128, 120, ctx, bits))


@pytest.mark.parametrize("with_mm", [True, False])
def test_step_time_roof_matches_jax_for_the_same_peaks(with_mm):
    peaks = {"tflops": 612.5, "int8_gbps": 1710.0, "int8_geps": 1710.0, "bf16_gbps": 2210.0,
             "bf16_geps": 1105.0}
    if with_mm:
        peaks["int8_mm_gbps"] = 1290.0
    for name in ("tiny", "large-v3"):
        jcfg, tcfg = JCONFIGS[name], tw.WHISPER_CONFIGS[name]
        for wbits, bits in ((8, 8), (16, 8), (8, 16)):
            js = jroof.decode_step_cost(jcfg, 8, 144, 640, bits, wbits)
            ts = troof.decode_step_cost(tcfg, 8, 144, 640, bits, wbits)
            _same(jroof.step_time_roof(js, peaks), troof.step_time_roof(ts, peaks))
            jc = jroof.continuous_step_cost(jcfg, 8, 320, 3 * 512.0, bits, wbits)
            tc = troof.continuous_step_cost(tcfg, 8, 320, 3 * 512.0, bits, wbits)
            _same(jroof.step_time_roof(jc, peaks), troof.step_time_roof(tc, peaks))


def test_peaks_are_the_h100s(monkeypatch):
    assert troof.nominal_peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert troof.DEFAULT_PEAK == (989e12, 3.35e12)
    for kind in ("TPU v5 lite", "v5e", "v6e", "unknown-device"):
        assert troof.nominal_peaks(kind) == troof.DEFAULT_PEAK
    assert not any(k in key for key in troof.DEVICE_PEAKS for k in ("tpu", "v4", "v5", "v6"))
    monkeypatch.delenv("WL_EFFECTIVE_TFLOPS", raising=False)
    monkeypatch.delenv("WL_EFFECTIVE_HBM_GBPS", raising=False)
    assert troof.effective_peaks() == pytest.approx((989e12, 3.35e12), rel=REL)
    step = troof.decode_step_cost(tw.WHISPER_CONFIGS["large-v3"], 8, 144)
    assert troof.step_time_roof(step, {}) == pytest.approx(
        max(step.flops / 989e12, step.bytes / 3.35e12), rel=REL)
    monkeypatch.setenv("WL_EFFECTIVE_TFLOPS", "500")
    monkeypatch.setenv("WL_EFFECTIVE_HBM_GBPS", "2000")
    assert troof.effective_peaks() == pytest.approx((500e12, 2000e9), rel=REL)
    # the same override reads the same in the JAX package
    assert troof.effective_peaks() == pytest.approx(jroof.effective_peaks(), rel=REL)


def test_measure_effective_peaks_on_the_cpu():
    """The probes at the JAX test's tiny shapes: the six envelopes, all
    positive, and a step roof built on them; a spent budget stops early."""
    peaks = troof.measure_effective_peaks("cpu", iters=2, n=128, chain=2,
                                          kv_shape=(2, 2, 64, 8), inner=2)
    assert set(peaks) == KEYS
    assert all(v > 0 and np.isfinite(v) for v in peaks.values())
    assert peaks["int8_geps"] == peaks["int8_gbps"]
    assert peaks["bf16_geps"] == peaks["bf16_gbps"] / 2
    cfg = tw.WHISPER_CONFIGS["tiny"]
    r1 = troof.step_time_roof(troof.decode_step_cost(cfg, 1, 144), peaks)
    r8 = troof.step_time_roof(troof.decode_step_cost(cfg, 8, 144), peaks)
    assert 0 < r1 < r8
    assert set(troof.measure_effective_peaks("cpu", iters=1, n=32, chain=1, seconds_budget=0.0,
                                             kv_shape=(1, 1, 16, 8), inner=1)) == {"tflops"}


def test_a_failing_probe_raises(monkeypatch):
    """The JAX probe logs and returns what it has; the port's raises, so a
    kernel that does not launch cannot hide behind the nominal fallback."""
    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(attn_ops, "cross_attention_int8", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        troof.measure_effective_peaks("cpu", iters=1, n=32, chain=1,
                                      kv_shape=(1, 1, 16, 8), inner=1)


DIMS = dict(
    n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
    n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)


def _speech(seconds, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("lanes", [1, 2])
def test_step_cross_pos_counts_what_k5_reads(lanes):
    """One window at a time, so every tick has one occupied slot: a 2 s
    window encodes at the 512-position bucket (K5 reads 512 positions of
    its rows), a 12 s one at 1500, capped at the slot's cross_ctx of 640.
    The JAX pool would count its whole 640-position slab for both."""
    cfg = tw.WhisperConfig(**DIMS)
    eng = WhisperEngine(cfg, tw.init_params(cfg, 0), device="cpu", batch_buckets=(1, 2))
    opts = TranscribeOptions(language="en", temperatures=(0.0,), log_prob_threshold=None,
                             no_speech_threshold=None, compression_ratio_threshold=None,
                             max_new_tokens=8, beam_size=lanes)
    for seconds, cross_len in ((2.0, 512), (12.0, 640)):
        cs = tcont.ContinuousScheduler(eng, n_slots=2, steps_per_chunk=4, prompt_pad=16,
                                       ring=64, cross_ctx=640, beam_width=lanes)
        cs.start()
        try:
            cs.submit(BatchRequest(audio=_speech(seconds, 3), options=opts)).result(timeout=300)
        finally:
            cs.stop()  # joins the worker: the last tick's counts are in
        ts = cs.tick_stats
        assert ts["ticks"] > 0 and ts["step_rows"] == ts["ticks"] * lanes
        assert ts["step_cross_pos"] == ts["step_rows"] * cross_len
