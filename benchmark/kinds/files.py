"""Offline files: BatchedTranscriber.transcribe calls run back to back, each
over a set of files (the CLI's --batched path; the reference's
BatchedInferencePipeline).

The mix fixes the files a call (the engine's largest batch bucket), their
durations, the decode budget, timestamps off, language detection and the
quality gates. Each call's files advance through their 30 s windows
together, so its batches shrink through the smaller buckets as files end.

Recorded: every window batch (its real audio seconds, rows and bucket, host
time from prepare to the decode's results, and the work it did), and for
the check each window's audio, prompt, detected language and served tokens.
A call still running when the window closes stops at its next batch.
The calls run on the main thread; a traced run profiles whole batches from
the first that starts in the window's last trace_s seconds to the one the
window closes in, so that stopping the profiler falls after the window.
"""

from __future__ import annotations

import time

import torch

from benchmark import generator, harness
from benchmark.harness import Run, build_engine
from benchmark.trace import Profile
from benchmark.weights import dims


class WindowClosed(Exception):
    """Raised into a running call when the measured window has closed."""


class _Recorder:
    """Hooks on the engine's prepare, language detection and decode (the
    calls BatchedTranscriber makes for each window batch)."""

    def __init__(self, engine, cuda: bool, head_dim: int):
        self.batches: list[dict] = []
        self.kv_bits = None  # the cross-KV width of every batch's prepare
        self.stop_at = float("inf")
        self.memory_peak = 0
        self.trace_at = None  # when the traced stretch may start
        self.stopped = None  # the profile of the stretch, reduced once the window closes
        self._prof = None
        self._cur: dict | None = None
        prepare, detect, decode = (engine.prepare, engine.detect_language_from_cross,
                                   engine.decode_with_fallback)
        tok = engine.tokenizer.spec

        def rec_prepare(audio):
            now = time.monotonic()
            if now >= self.stop_at:
                self.memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
                self._stop_trace()
                raise WindowClosed
            if self.trace_at is not None and self._prof is None and now >= self.trace_at:
                self._prof = Profile(cuda)
                self.trace_at = None
            n = len(self.batches)
            # one span from the encode to the decode's results, which sync:
            # every kernel of the batch runs inside it
            span = torch.profiler.record_function(f"bench.batch#{n}")
            span.__enter__()
            self._cur = {"t0": time.monotonic(), "audio": audio, "n": n, "languages": None,
                         "span": span,
                         "real_s": [generator.real_samples(r) / generator.SAMPLE_RATE
                                    for r in audio]}
            enc, cross = prepare(audio)
            bits = harness.cross_kv_bits(cross, head_dim)
            self.kv_bits = bits if self.kv_bits in (None, bits) else -1
            return enc, cross

        def rec_detect(cross):
            out = detect(cross)
            self._cur["languages"] = [tok.language_token(code) for code, _ in out]
            return out

        def rec_decode(cross, prompts, sots, options, seed=0):
            cur = self._cur
            results = decode(cross, prompts, sots, options, seed=seed)
            cur["t1"] = time.monotonic()
            cur.pop("span").__exit__(None, None, None)
            cur["prompts"] = [[int(t) for t in p] for p in prompts]
            cur["served"] = [[int(t) for t in r.tokens] for r in results]
            cur["rows"] = len(prompts)
            cur["bucket"] = len(cur["audio"])
            self.batches.append(cur)
            return results

        engine.prepare = rec_prepare
        engine.detect_language_from_cross = rec_detect
        engine.decode_with_fallback = rec_decode

    def _stop_trace(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self.stopped, self._prof = self._prof, None


def _options(mix: dict, max_new: int, initial_prompt=None):
    from whisperlive_tpu_torch.engine.engine import TranscribeOptions

    gates = {} if mix["gates"] else dict(temperatures=(0.0,), log_prob_threshold=None,
                                         compression_ratio_threshold=None,
                                         no_speech_threshold=None)
    return TranscribeOptions(language=mix["language"], max_new_tokens=max_new,
                             without_timestamps=not mix["timestamps"],
                             initial_prompt=initial_prompt, **gates)


def _warm(transcriber, mix: dict, bank) -> None:
    """The shapes the mix's calls reach, on short decodes (the cache length
    bucket is the same at any budget up to 128 tokens): one call whose
    batches fill every batch bucket from the largest down, one whose prompts
    reach the largest prompt bucket."""
    n = mix["files_per_call"]
    sr = generator.SAMPLE_RATE
    counts, left = [], n
    while left:
        counts.append((left + 1) // 2)
        left -= counts[-1]
    # windows a file: the first half of the files end after one window, a
    # quarter after two, ... so the live rows halve at each batch
    lengths, windows = [], 1
    for c in counts:
        lengths += [int((30 * windows - 29) * sr)] * c
        windows += 1
    files = [bank.bank[i % len(bank.bank)][: lengths[i]] for i in range(n)]
    transcriber.transcribe(files, _options(mix, mix["warm_tokens"]))
    short = [f[: 5 * sr] for f in files]
    transcriber.transcribe(short, _options(mix, mix["warm_tokens"], "warm " * 60))


def run(config: dict, mix: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> Run:
    from whisperlive_tpu_torch.engine.transcribe import BatchedTranscriber

    cuda = torch.device(device).type == "cuda"
    dm = dims(config)
    engine = build_engine(config, seed, device)
    bank = generator.FileBank(mix, seed)
    transcriber = BatchedTranscriber(engine)
    _warm(transcriber, mix, bank)
    rec = _Recorder(engine, cuda, dm["d"] // dm["n_text_head"])
    options = _options(mix, mix["max_new_tokens"])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    t_end = t0 + seconds
    rec.stop_at = t_end
    if trace:
        rec.trace_at = t_end - mix["trace_s"]
    error = None
    calls = 0
    try:
        while True:
            transcriber.transcribe(bank.call(calls), options)
            calls += 1
    except WindowClosed:
        pass
    except Exception as e:  # every window of the run counts as unanswered
        error = e
        rec.memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        rec._stop_trace()
    trace_out = rec.stopped.result() if rec.stopped is not None else None
    done = [b for b in rec.batches if b["t1"] <= t_end]
    records = []
    for b in rec.batches:
        for j in range(b["rows"]):
            records.append({"audio": b["audio"][j], "enc_ctx": dm["n_audio_ctx"],
                            "prompt": b["prompts"][j], "served": b["served"][j], "history": [],
                            "timestamps": mix["timestamps"],
                            "language": None if b["languages"] is None else b["languages"][j]})
    attempted = sum(b["rows"] for b in rec.batches if b["t0"] < t_end)
    run_ = Run(kind="files", dims=dm, mix=mix, seconds=seconds, setup_s=t0 - t_start,
               attempted=attempted, failed=attempted if error is not None else 0,
               trace=trace_out, memory_peak_bytes=int(rec.memory_peak),
               records=[r for r in records if r["served"]], cross_kv_bits=rec.kv_bits)
    run_.data = {"batches": rec.batches, "done": done, "t0": t0, "calls": calls,
                 "error": None if error is None else repr(error)}
    for b in rec.batches:
        b.pop("audio", None)
    del engine, transcriber
    if cuda:
        torch.cuda.empty_cache()
    return run_
