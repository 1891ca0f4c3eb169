"""The port's span log and device timer (utils/profiling.py) and the spans
the program records with them.

The log: nested spans record their parent and thread, the ring is bounded
and counts its drops, a span opens a record_function only while the
profiler records, and then stands among the profiler's events where the
log's clock pair puts it. The device timer records nothing off the card,
reads a pair into its span's device_s once its end has completed, and
records none for a stretch that raises. The program: a tiny random-weight
model (torch alone, CPU) behind ServeClient sessions on a
ContinuousScheduler records request.queued, request.resident,
request.resolve and request.push under one rid, whose stages add up to the
push's content age as the benchmark reads it; a BatchedTranscriber call
records one transcribe.batch span a window batch with the rows and bucket
that batch had.
"""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from whisperlive_tpu_torch.engine.continuous import ContinuousScheduler
from whisperlive_tpu_torch.engine.engine import TranscribeOptions, WhisperEngine
from whisperlive_tpu_torch.engine.scheduler import BatchScheduler
from whisperlive_tpu_torch.engine.tokenizer import TokenSpec, WhisperTokenizer
from whisperlive_tpu_torch.engine.transcribe import BatchedTranscriber
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.serving import backends as tbackends
from whisperlive_tpu_torch.serving.server import ServeClient
from whisperlive_tpu_torch.serving.session import SessionOptions
from whisperlive_tpu_torch.utils import profiling

torch.set_num_threads(2)


class Visible(WhisperTokenizer):
    """Text tokens decode to visible words, so every window has segments."""

    def decode(self, tokens):
        return "".join(f" t{int(t)}" for t in tokens if int(t) < self.spec.eot)


def _engine(batch_buckets=(1, 2, 4)):
    cfg = tw.WhisperConfig(80, 51865, 1500, 64, 4, 2, 448, 64, 4, 2)
    return WhisperEngine(cfg, tw.init_params(cfg, 0), device="cpu",
                         tokenizer=Visible(TokenSpec(51865, multilingual=True)),
                         batch_buckets=batch_buckets, decoder_int8=True, cross_kv_bits=8)


def _since(t0_ns, name):
    return [s for s in profiling.LOG.spans(name) if s.start_ns >= t0_ns]


def test_nested_spans_record_their_parent_and_thread():
    log = profiling.SpanLog()
    with log.span("outer", rid=7, n=1) as outer:
        with log.span("inner") as inner:
            pass
        inner.attrs["late"] = 2
    other = []
    t = threading.Thread(target=lambda: other.append(log.span("apart").__enter__()),
                         name="tracing-test")
    t.start()
    t.join()
    other[0].__exit__(None, None, None)
    assert [s.name for s in log.spans()] == ["inner", "outer", "apart"]
    assert inner.parent == outer.sid and outer.parent == 0
    assert inner.thread == outer.thread == threading.get_ident()
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert (outer.rid, outer.attrs, inner.rid, inner.attrs) == (7, {"n": 1}, None, {"late": 2})
    assert other[0].parent == 0 and other[0].thread != outer.thread
    assert log.thread_names[other[0].thread] == "tracing-test"
    rec = log.record_span("across", 5, 9, rid=3, x=1.5)
    assert (rec.start_ns, rec.end_ns, rec.parent, rec.rid, rec.attrs) == (5, 9, 0, 3, {"x": 1.5})


def test_the_ring_is_bounded_and_counts_its_drops():
    log = profiling.SpanLog(capacity=4)
    for i in range(6):
        log.record_span(f"s{i}", 10 * i, 10 * i + 5)
    assert [s.name for s in log.spans()] == ["s2", "s3", "s4", "s5"]
    assert log.dropped == 2 and log.dropped_end_ns == 15
    assert not log.whole_since(15) and log.whole_since(16)
    assert profiling.LOG.capacity == 65536


def test_a_span_opens_no_record_function_without_a_profiler(monkeypatch):
    opened = []
    record_function = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or record_function(name))
    with profiling.span("wl.quiet") as s:
        assert s._rf is None
    assert opened == []


def test_a_span_stands_on_the_profiler_timeline_where_the_clock_pair_puts_it():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with profiling.span("wl.warm"):  # the first record_function starts slowly
        pass
    with profiling.span("wl.traced") as s:
        torch.ones(8, 8) @ torch.ones(8, 8)
    prof.stop()
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "wl.traced"]
    assert len(events) == 1
    assert abs(events[0].start_ns() - profiling.LOG.to_epoch_ns(s.start_ns)) < 1_000_000


class _Event:
    """A stand-in for torch.cuda.Event: completes when the test says so,
    at a time the test gives it."""

    made: list = []

    def __init__(self, enable_timing=False):
        self.t_ms, self.done = None, False
        self.made.append(self)

    def record(self):
        self.t_ms = 10.0 * len(self.made)

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.t_ms - self.t_ms


def test_the_device_timer_reads_completed_pairs_and_nothing_off_the_card(monkeypatch):
    off = profiling.DeviceTimer("cpu")
    with profiling.span("engine.prepare", device_s=None) as s, off.time(s):
        pass
    assert not off.enabled and off._pending == [] and s.attrs["device_s"] is None

    monkeypatch.setattr(torch.cuda, "Event", _Event)
    _Event.made = []
    timer = profiling.DeviceTimer("cpu")
    timer.enabled = True  # the host's side only, on stand-in events
    with profiling.span("engine.prepare", device_s=None) as s, timer.time(s):
        pass
    raised = profiling.LOG.span("engine.prepare", device_s=None)
    with pytest.raises(ValueError):
        with raised, timer.time(raised):
            raise ValueError("a stretch that raises records no pair")
    assert len(timer._pending) == 1 and len(_Event.made) == 3
    timer.settle()  # the card has not reached the pair's end
    assert s.attrs["device_s"] is None and len(timer._pending) == 1
    for e in _Event.made:
        e.done = True
    timer.settle()
    assert timer._pending == [] and s.attrs["device_s"] == 0.010
    assert raised.attrs["device_s"] is None


async def _serve(backend, uid, audio, sent, stop_after):
    """One session fed in 0.25 s chunks until `stop_after` pushes arrived."""
    client = ServeClient(None, uid, SessionOptions(language="en", use_vad=False), backend,
                         send_json=sent)
    client.add_frames(audio[:16000])
    client.start()
    fed = 16000
    for _ in range(600):
        if len(backend.ages.get(uid, [])) >= stop_after:
            break
        client.add_frames(audio[fed:fed + 4000])
        fed += 4000
        await asyncio.sleep(0.05)
    await client.cleanup()


def test_a_served_request_s_spans_add_up_to_its_content_age(monkeypatch):
    monkeypatch.setattr(tbackends, "_DISABLE_GATES", True)
    monkeypatch.setattr(tbackends, "STREAMING_MAX_NEW_TOKENS", 6)
    eng = _engine()
    cs = ContinuousScheduler(eng, n_slots=2, steps_per_chunk=4, prompt_pad=64, ring=32)
    window = BatchScheduler(eng, max_batch_size=2)
    t0 = time.monotonic_ns()

    class Recording(tbackends.TorchBackend):
        """The benchmark's reading of content age: push time minus the
        result's audio_bound_at, taken in the push."""

        ages: dict = {}
        bound: dict = {}

        async def transcribe(self, chunk, options, **kw):
            result = await super().transcribe(chunk, options, **kw)
            self.bound[kw["uid"]] = result.audio_bound_at
            return result

    backend = Recording(window, continuous_scheduler=cs)

    def sender(uid):
        async def send_json(payload):
            if "segments" in payload:
                backend.ages.setdefault(uid, []).append(time.monotonic() - backend.bound[uid])
        return send_json

    rng = np.random.default_rng(1)
    audio = (rng.standard_normal(16000 * 40) * 0.1).astype(np.float32)
    cs.start()
    window.start()
    try:
        async def both():
            await asyncio.gather(*(_serve(backend, u, audio, sender(u), 3) for u in ("a", "b")))
        asyncio.run(both())
    finally:
        cs.stop()
        window.stop()
    pushes = _since(t0, "request.push")
    assert len(pushes) >= 6
    by_rid = {}
    for name in ("request.queued", "request.resident", "request.resolve", "request.push"):
        for s in _since(t0, name):
            by_rid.setdefault(s.rid, {}).setdefault(name, []).append(s)
    for push in pushes:
        got = by_rid[push.rid]
        assert set(got) == {"request.queued", "request.resident", "request.resolve",
                            "request.push"}
        (resident,), (resolve,) = got["request.resident"], got["request.resolve"]
        # contiguous stages from the slot grant (where a first attempt's
        # audio is bound) to the push
        assert resident.end_ns == resolve.start_ns and resolve.end_ns == push.start_ns
        stages = resident.seconds + resolve.seconds + push.seconds
        assert stages == pytest.approx(push.attrs["content_age_s"], abs=1e-3)
        assert got["request.queued"][-1].end_ns == resident.start_ns
    ages = sorted(a for v in backend.ages.values() for a in v)
    read = sorted(p.attrs["content_age_s"] for p in pushes)
    assert len(ages) == len(read)
    assert np.allclose(ages, read, atol=1e-3)
    ts = cs.tick_stats
    assert ts["ticks"] > 0 and ts["insert_calls"] > 0


def test_each_window_batch_is_one_transcribe_batch_span():
    eng = _engine()
    sizes = []
    prepare, decode = eng.prepare, eng.decode_with_fallback

    def rec_prepare(audio):
        sizes.append([len(audio)])
        return prepare(audio)

    def rec_decode(cross, prompts, sots, options, seed=0):
        sizes[-1].append(len(prompts))
        return decode(cross, prompts, sots, options, seed=seed)

    eng.prepare, eng.decode_with_fallback = rec_prepare, rec_decode
    rng = np.random.default_rng(2)
    files = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
             for s in (35.0, 35.0, 10.0)]
    opts = TranscribeOptions(language="en", max_new_tokens=4, without_timestamps=True,
                             temperatures=(0.0,), log_prob_threshold=None,
                             compression_ratio_threshold=None, no_speech_threshold=None)
    t0 = time.monotonic_ns()
    BatchedTranscriber(eng).transcribe(files, opts)
    batches = _since(t0, "transcribe.batch")
    assert [[s.attrs["bucket"], s.attrs["rows"]] for s in batches] == sizes
    assert sizes[0] == [4, 3] and len(batches) >= 2
    prepares, decodes = _since(t0, "engine.prepare"), _since(t0, "engine.decode")
    assert len(prepares) == len(batches) and len(decodes) >= len(batches)
    for s in prepares + decodes:  # no events on a CPU device
        assert s.attrs.get("device_s") is None
        assert any(b.sid == s.parent or b.start_ns <= s.start_ns <= s.end_ns <= b.end_ns
                   for b in batches)
    assert all(1 <= s.attrs["steps"] <= 4 for s in decodes)
