"""The frozen cost model: 14 d^2 of linear weights a decoder layer, each
kernel byte counted once a call, and a roofline share that stays at or
under 100% when the kernel takes its least time."""

import pytest

from benchmark import costmodel as cm
from benchmark.harness import Run, reader
from benchmark.weights import dims

LARGE_V3 = {"d_model": 1280, "decoder_attention_heads": 20, "decoder_ffn_dim": 5120,
            "decoder_layers": 32, "encoder_attention_heads": 20, "encoder_ffn_dim": 5120,
            "encoder_layers": 32, "max_source_positions": 1500, "max_target_positions": 448,
            "num_mel_bins": 128, "vocab_size": 51866}


def test_a_decoder_layer_holds_14_d_squared():
    dm = dims(LARGE_V3)
    d, L = 1280, 32
    one_step = cm.k2_cost(dm, steps=1, tokens=0)
    scales = L * 2 * (6 * d + 4 * d + d)  # bf16, one per output channel
    assert one_step.bytes == 14 * d * d * L + scales
    assert one_step.bytes / 1e6 == pytest.approx(734.0, abs=1.0)  # MB of int8 weights
    tok = cm.k2_cost(dm, steps=0, tokens=1)
    assert tok.flops == 28 * d * d * L
    assert cm.decoder_token_flops(dm, 0, 0.0, False) - L * 4 * d == 28 * d * d * L


def test_kernel_bytes_are_counted_once_a_call():
    dm = dims(LARGE_V3)
    # K1: q, k, v read and out written once, bf16, every encoder layer
    p = 1500
    assert cm.k1_cost(dm, 30.0).bytes == 32 * 4 * p * 1280 * 2
    assert cm.k1_cost(dm, 30.0).flops == 32 * 4 * p * p * 1280
    # K2: x read and out written per token, weights once per step
    two = cm.k2_cost(dm, steps=3, tokens=5)
    assert two.bytes == 3 * cm.k2_cost(dm, 1, 0).bytes + 5 * cm.k2_cost(dm, 0, 1).bytes
    # K5: the int8 K|V rows of the real positions once, q, out, length, flag
    k5 = cm.k5_cost(dm, tokens=1, pos_tokens=400)
    hd = 64
    assert k5.bytes == 32 * (20 * 2 * hd * 400 + 20 * 6 * hd + 5)


def test_least_time_names_its_bound():
    c = cm.Cost(flops=989e12, bytes=1.0)
    assert c.least_s() == pytest.approx(1.0) and c.bound() == "compute"
    m = cm.Cost(flops=1.0, bytes=3.35e12)
    assert m.least_s() == pytest.approx(1.0) and m.bound() == "memory"


def _stream_run(kernel_s: float) -> Run:
    dm = dims(LARGE_V3)
    steps = [{"tokens": 12, "pos_tokens": 12 * 400}, {"tokens": 3, "pos_tokens": 3 * 250}]
    trace = {"spans": {("step", 0): {"void int8_matmul_kernel<2>(x)": kernel_s[0],
                                     "void cross_attention_kernel<Int8Packed, 1>(x)": kernel_s[1]},
                       ("step", 1): {"void int8_matmul_kernel<2>(x)": kernel_s[2],
                                     "void cross_attention_kernel<Int8Packed, 1>(x)": kernel_s[3],
                                     "void int8_matmul_t_kernel<1>(x)": 9.0}},
             "busy_s": 0.1, "window_s": 1.0, "n_device_events": 5}
    run = Run(kind="stream", dims=dm, mix={}, seconds=1.0, setup_s=0.0, trace=trace)
    run.data = {"steps": steps, "steps_per_chunk": 8}
    return run


def test_a_roofline_at_the_least_time_reads_100_and_never_more():
    dm = dims(LARGE_V3)
    k2 = [cm.k2_cost(dm, 8, 12).least_s(), cm.k2_cost(dm, 3, 3).least_s()]
    k5 = [cm.k5_cost(dm, 12, 4800).least_s(), cm.k5_cost(dm, 3, 750).least_s()]
    run = _stream_run([k2[0], k5[0], k2[1], k5[1]])
    assert reader("k2_roofline.stream").read(run) == pytest.approx(100.0)
    assert reader("k5_roofline.stream").read(run) == pytest.approx(100.0)
    slow = _stream_run([2 * k2[0], 2 * k5[0], 2 * k2[1], 2 * k5[1]])
    assert reader("k2_roofline.stream").read(slow) == pytest.approx(50.0)
    # K3 (int8_matmul_t) is not K2
    assert reader("k2_roofline.stream").read(slow) < 100


def test_a_roofline_with_nothing_to_read_is_left_out():
    run = _stream_run([0.0, 0.0, 0.0, 0.0])
    assert reader("k2_roofline.stream").read(run) is None
    run.trace = None
    assert reader("k5_roofline.stream").read(run) is None
    assert reader("idle_share.stream").read(run) is None
