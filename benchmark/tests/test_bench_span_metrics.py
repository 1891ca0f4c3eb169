"""The readers of the program's spans and device counters, and of the
device time of the traced steps and batches, on synthetic runs: each keeps
what ended inside the run's window (or the traced stretch), and reads
nothing without a reading, without the program's counters or spans (a
parent without them) or where the span log dropped part of the window."""

import pytest

from benchmark.harness import Run, reader
from benchmark.weights import dims
from whisperlive_tpu_torch.utils import profiling

from .test_bench_costmodel import LARGE_V3

S = 10**9
# a window far from any real span of this process (monotonic seconds)
W0 = 10**7


def _run(kind, **data):
    run = Run(kind=kind, dims=dims(LARGE_V3), mix={}, seconds=10.0, setup_s=1.0)
    run.data = data
    return run


@pytest.fixture
def log(monkeypatch):
    fresh = profiling.SpanLog()
    monkeypatch.setattr(profiling, "LOG", fresh)
    return fresh


def test_request_stages_are_medians_of_the_spans_that_ended_in_the_window(log):
    run = _run("stream", window=(W0, W0 + 10))
    for i, (q, r, p) in enumerate([(0.1, 1.0, 0.002), (0.3, 2.0, 0.004), (0.2, 1.5, 0.010)]):
        t = (W0 + 1 + i) * S
        log.record_span("request.queued", t, t + int(q * S), rid=i)
        log.record_span("request.resident", t, t + int(r * S), rid=i)
        log.record_span("request.push", t, t + int(p * S), rid=i)
    # ended before the window, and after it: left out
    log.record_span("request.queued", (W0 - 5) * S, (W0 - 1) * S)
    log.record_span("request.resident", (W0 + 9) * S, (W0 + 12) * S)
    assert reader("queue_wait_s.stream").read(run) == pytest.approx(0.2)
    assert reader("residence_s.stream").read(run) == pytest.approx(1.5)
    assert reader("push_lag_ms.stream").read(run) == pytest.approx(4.0)
    # nothing recorded in another window
    assert reader("queue_wait_s.stream").read(_run("stream", window=(W0 + 20, W0 + 30))) is None


def test_a_ring_that_dropped_part_of_the_window_reads_nothing(monkeypatch):
    small = profiling.SpanLog(capacity=2)
    monkeypatch.setattr(profiling, "LOG", small)
    for i in range(3):
        small.record_span("request.push", (W0 + 1 + i) * S, (W0 + 1 + i) * S + 1000)
    assert reader("push_lag_ms.stream").read(_run("stream", window=(W0, W0 + 10))) is None
    # a window that starts after the dropped span is whole
    late = _run("stream", window=(W0 + 2, W0 + 10))
    assert reader("push_lag_ms.stream").read(late) == pytest.approx(1e-3)


def test_step_and_insert_device_times_are_the_traced_spans_kernels():
    run = _run("stream", steps_per_chunk=8)
    run.trace = {"spans": {("step", 3): {"k2": 0.030, "copy": 0.002},
                           ("step", 4): {"k2": 0.034, "k5": 0.014},
                           ("insert", 0): {"k1": 0.05, "k2": 0.02},
                           ("insert", 1): {"k1": 0.03}}}
    assert reader("step_device_ms.stream").read(run) == pytest.approx(1e3 * 0.080 / 16)
    assert reader("insert_device_ms.stream").read(run) == pytest.approx(50.0)
    run.trace = {"spans": {("step", 5): {"k2": 0.03}}}  # no insert in the stretch
    assert reader("insert_device_ms.stream").read(run) is None
    untraced = _run("stream", steps_per_chunk=8)
    for name in ("step_device_ms.stream", "insert_device_ms.stream"):
        assert reader(name).read(untraced) is None


def test_the_files_readers_sum_steps_and_average_prepares(log):
    run = _run("files", t0=W0)  # the window is [t0, t0 + seconds)
    t = (W0 + 1) * S
    log.record_span("engine.decode", t, t + int(1.2 * S), steps=100)
    log.record_span("engine.decode", t, t + int(0.3 * S), steps=20)
    log.record_span("engine.prepare", t, t + S, device_s=0.2)
    log.record_span("engine.prepare", t, t + S, device_s=None)
    log.record_span("engine.prepare", t, t + S, device_s=0.1)
    assert reader("decode_step_ms.files").read(run) == pytest.approx(1e3 * 1.5 / 120)
    assert reader("prepare_device_ms.files").read(run) == pytest.approx(150.0)
    # a CPU run: spans without device seconds
    cpu = _run("files", t0=W0 + 100)
    log.record_span("engine.decode", (W0 + 101) * S, (W0 + 102) * S, steps=4)
    log.record_span("engine.prepare", (W0 + 101) * S, (W0 + 102) * S, device_s=None)
    assert reader("decode_step_ms.files").read(cpu) == pytest.approx(250.0)
    assert reader("prepare_device_ms.files").read(cpu) is None


def test_decode_device_time_is_a_traced_batch_s_kernels_less_its_prepare(log):
    # batch 0 lies wholly in the stretch; batch 1 has no span of the program
    # (a parent's); batch 2 ended after the stretch
    run = _run("files", t0=W0, batches=[{"n": 0, "t0": W0 + 1, "t1": W0 + 2},
                                        {"n": 1, "t0": W0 + 3, "t1": W0 + 4},
                                        {"n": 2, "t0": W0 + 5}])
    t = (W0 + 1) * S
    log.record_span("engine.prepare", t + 1000, t + 2000, device_s=0.150)
    log.record_span("engine.decode", t + 3000, t + 4000, steps=80)
    log.record_span("engine.decode", t + 5000, t + 6000, steps=20)
    log.record_span("engine.decode", (W0 + 6) * S, (W0 + 7) * S, steps=50)  # no batch
    run.trace = {"spans": {("batch", 0): {"encoder": 0.140, "k2": 0.200, "mel": 0.010},
                           ("batch", 1): {"k2": 0.5}}}
    assert reader("decode_step_device_ms.files").read(run) == pytest.approx(1e3 * 0.2 / 100)
    run.trace = {"spans": {("batch", 1): {"k2": 0.5}}}
    assert reader("decode_step_device_ms.files").read(run) is None
    run.trace = None
    assert reader("decode_step_device_ms.files").read(run) is None


def test_a_program_without_the_span_log_reads_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "LOG")
    for name in ("queue_wait_s.stream", "residence_s.stream", "push_lag_ms.stream"):
        assert reader(name).read(_run("stream", window=(W0, W0 + 10))) is None
    for name in ("decode_step_ms.files", "prepare_device_ms.files"):
        assert reader(name).read(_run("files", t0=W0)) is None
