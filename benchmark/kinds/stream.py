"""Live streams: in-process ServeClient sessions on one TorchBackend over a
ContinuousScheduler, the server CLI's serving path with the websocket
replaced by a collector.

The mix fixes the streams, their pre-buffered audio and start stagger, the
chunk size (sent in real time), the slot pool's geometry, the session
options and two emulations of trained weights in the backend: a cap on the
un-committed tail fed to the program, and a decode budget per audio second
(random weights never emit EOT; speech decodes a few tokens a second, then
stops).

Recorded: every segment push with its content age (push time minus the
decoded audio's capture time), the scheduler's tick_stats at the window's
edges, every request submitted and whether it came back, and for the check
each finished window's audio, prompt, carried prefix and served tokens.
"""

from __future__ import annotations

import asyncio
import dataclasses
import threading
import time

import numpy as np
import torch

from benchmark import generator, harness
from benchmark.harness import Run, build_engine
from benchmark.trace import profile_stretch
from benchmark.weights import dims


def _warm_pool(cs, enc_ctx: int) -> None:
    """Every insert bucket at the pool's one encoder context this mix uses,
    a step chunk and a release, then a fresh state (ContinuousScheduler's
    own warm-up also runs the full-context bucket, which an 8 s tail never
    reaches)."""
    from whisperlive_tpu_torch.engine.continuous import INSERT_BUCKETS
    from whisperlive_tpu_torch.engine.engine import TranscribeOptions, _bucket
    from whisperlive_tpu_torch.ops import mel as mel_ops

    eng, cb = cs.engine, cs.cb
    cb.init_state()
    prompt, sot = eng.build_prompt(TranscribeOptions(), language="en")
    for j in INSERT_BUCKETS:
        if j > _bucket(cb.n_slots, INSERT_BUCKETS):
            continue
        cb.insert(np.zeros((j, mel_ops.N_SAMPLES), np.float32), [prompt] * j, [sot] * j,
                  [True] * j, [min(i, cb.n_slots - 1) for i in range(j)], [0.0] * j,
                  [True] * j, [1.0] * j, [8] * j, enc_ctx=enc_ctx)
    cb.step()
    cb.release([0])
    cb.init_state()


class _Recorder:
    """Hooks on the scheduler and its pool (instance attributes wrapping the
    program's methods): spans for the trace, step and insert records, and
    the check's records."""

    def __init__(self, cs):
        self.cs = cs
        self.steps: list[dict] = []
        self.inserts: list[dict] = []
        self.finished: list[dict] = []
        self.submitted: list = []
        self._seat: dict[int, dict] = {}
        self._by_req: dict[int, tuple] = {}
        self._gen: dict[int, int] = {}
        cb = cs.cb
        insert, step = cb.insert, cb.step
        insert_take, resolve, submit = cs._insert_take, cs._resolve, cs.submit

        def rec_insert(windows, prompts, sot_idx, lang_known, slot_ids, temps, ts_en, rep,
                       max_new, **kw):
            enc_ctx = kw.get("enc_ctx")
            n = 2 * enc_ctx * 160
            for i, s in enumerate(slot_ids):
                self._seat[s] = {"audio": np.asarray(windows[i][:n], np.float32).copy(),
                                 "prompt": [int(t) for t in prompts[i]],
                                 "enc_ctx": int(enc_ctx), "timestamps": bool(ts_en[i]),
                                 "language": None}
                self._gen[s] = 0
            n_ins = len(self.inserts)
            t0 = time.monotonic()
            with torch.profiler.record_function(f"bench.insert#{n_ins}"):
                out = insert(windows, prompts, sot_idx, lang_known, slot_ids, temps, ts_en,
                             rep, max_new, **kw)
            self.inserts.append({"t0": t0, "t1": time.monotonic(), "windows": len(slot_ids)})
            return out

        def rec_step():
            n = len(self.steps)
            t0 = time.monotonic()
            with torch.profiler.record_function(f"bench.step#{n}"):
                status = step()
            t1 = time.monotonic()
            k = cb.beam_width
            tokens, pos_tokens = 0, 0
            for s, info in list(cs._slots.items()):
                g = int(status[s * k, 2])
                new = max(g - self._gen.get(s, 0), 0)
                self._gen[s] = g
                tokens += new
                pos_tokens += new * max(1, round(info.duration * 50))
            self.steps.append({"t0": t0, "t1": t1, "rows": len(cs._slots), "tokens": tokens,
                               "pos_tokens": pos_tokens})
            return status

        def rec_insert_take(take, free, enc_ctx):
            insert_take(take, free, enc_ctx)
            for (req, _), slot in zip(take, free):
                if slot in self._seat:
                    self._by_req[id(req)] = (req, self._seat.pop(slot))

        def rec_resolve(info, res, final_failed, fetched=None):
            got = self._by_req.pop(id(info.req), None)
            if got is not None:
                rec = got[1]
                prefix = [int(t) for t in info.prefix]
                toks = [int(t) for t in res.tokens]
                rec.update(history=prefix, served=toks[len(prefix):], t_done=time.monotonic(),
                           audio_s=info.duration)
                self.finished.append(rec)
            return resolve(info, res, final_failed, fetched)

        def rec_submit(req):
            self.submitted.append((time.monotonic(), req))
            return submit(req)

        cb.insert, cb.step = rec_insert, rec_step
        cs._insert_take, cs._resolve, cs.submit = rec_insert_take, rec_resolve, rec_submit


def run(config: dict, mix: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> Run:
    from whisperlive_tpu_torch.engine.continuous import ContinuousScheduler
    from whisperlive_tpu_torch.engine.scheduler import BatchScheduler
    from whisperlive_tpu_torch.serving import backends as backends_mod
    from whisperlive_tpu_torch.serving.server import ServeClient
    from whisperlive_tpu_torch.serving.session import SessionOptions

    cuda = torch.device(device).type == "cuda"
    dm = dims(config)
    pool, sess = mix["pool"], mix["session"]
    backends_mod._DISABLE_GATES = not sess["gates"]
    engine = build_engine(config, seed, device)
    cs = ContinuousScheduler(engine, n_slots=pool["slots"],
                             steps_per_chunk=pool["steps_per_chunk"], prompt_pad=pool["prompt_pad"],
                             ring=pool["ring"], cross_ctx=pool["cross_ctx"])
    _warm_pool(cs, pool["enc_ctx"])
    cs.start()
    window_sched = BatchScheduler(engine, max_batch_size=pool["window_batch"],
                                  batch_window_ms=pool["window_batch_ms"])
    window_sched.start()
    rec = _Recorder(cs)
    traffic = generator.stream_traffic(mix, seed, seconds)
    cap = int(mix["tail_cap_s"] * generator.SAMPLE_RATE)
    tps = mix["tokens_per_audio_s"]
    pushes: list[tuple[float, str, float]] = []
    last_bound: dict[str, float] = {}

    class BenchBackend(backends_mod.TorchBackend):
        """The emulations of trained weights: the tail cap and the decode
        budget per audio second."""

        def _adjust_options(self, topts, chunk):
            budget = max(4, int(len(chunk) / generator.SAMPLE_RATE * tps))
            return dataclasses.replace(
                topts, max_new_tokens=min(budget, topts.max_new_tokens or budget))

        async def transcribe(self, chunk, options, **kw):
            chunk = chunk[-cap:]
            inner = kw.get("refresh_audio")
            if inner is not None:
                kw["refresh_audio"] = lambda: (lambda f: None if f is None else f[-cap:])(inner())
            result = await super().transcribe(chunk, options, **kw)
            if result is not None:
                last_bound[kw.get("uid", "")] = result.audio_bound_at
            return result

    backend = BenchBackend(window_sched, continuous_scheduler=cs)
    backend.request_timeout_s = mix["drain_s"]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    t0 = time.monotonic() + mix["stagger_s"] + mix["settle_s"]  # the window's start

    async def drive() -> dict:
        clients = {}
        t_end = t0 + seconds
        chunk = mix["chunk_samples"]
        pre = int(mix["prebuffer_s"] * generator.SAMPLE_RATE)
        due = {s["uid"]: t0 + s["start_s"] for s in traffic}
        fed = {s["uid"]: 0 for s in traffic}
        audio = {s["uid"]: s["audio"] for s in traffic}
        opts = SessionOptions(language=sess["language"], use_vad=sess["use_vad"])
        stats: dict = {}

        def sender(uid):
            async def send_json(payload):
                if "segments" in payload:
                    now = time.monotonic()
                    pushes.append((now, uid, now - last_bound.get(uid, now)))
            return send_json

        while True:
            now = time.monotonic()
            if "t0" not in stats and now >= t0:
                stats["t0"] = dict(cs.tick_stats)
                stats["t0_time"] = now
            if now >= t_end:
                stats["t1"] = dict(cs.tick_stats)
                stats["t1_time"] = now
                break
            for s in traffic:
                uid = s["uid"]
                if now < due[uid]:
                    continue
                if uid not in clients:
                    c = ServeClient(None, uid, opts, backend, send_json=sender(uid))
                    c.add_frames(audio[uid][:pre])
                    fed[uid] = pre
                    c.start()
                    clients[uid] = c
                else:
                    c = clients[uid]
                    c.add_frames(audio[uid][fed[uid]: fed[uid] + chunk])
                    fed[uid] += chunk
                due[uid] += chunk / generator.SAMPLE_RATE
            nxt = min(min(due.values()), t_end, t0 if "t0" not in stats else t_end)
            await asyncio.sleep(max(0.0, nxt - time.monotonic()))
        stats["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
        # close: every stream stops after the request it has in flight
        for c in clients.values():
            c.exit = True
            c._new_audio.set()
        tasks = [c._task for c in clients.values() if c._task is not None]
        await asyncio.wait(tasks, timeout=mix["drain_s"])
        for c in clients.values():
            await c.cleanup()
        return stats

    out: dict = {}
    # the streams run on a thread of their own; the main thread traces
    driver = threading.Thread(target=lambda: out.update(stats=asyncio.run(drive())),
                              name="bench-streams")
    driver.start()
    # a stretch in the middle of the window; starting and stopping the profiler
    # take seconds of host time on the streams' core, which the window carries
    prof = (profile_stretch(t0 + (seconds - mix["trace_s"]) / 2, mix["trace_s"], cuda)
            if trace else None)
    driver.join()
    tr = prof.result() if prof is not None else None
    stats = out["stats"]
    kv_bits = harness.cross_kv_bits(cs.cb.state["cross_kv"], dm["d"] // dm["n_text_head"])
    cs.stop()
    window_sched.stop()
    t_end = t0 + seconds
    in_window = [r for t, r in rec.submitted if t0 <= t < t_end]
    unanswered = sum(1 for r in in_window
                     if not r.future.done() or r.future.cancelled()
                     or r.future.exception() is not None)
    run_ = Run(kind="stream", dims=dm, mix=mix, seconds=seconds, setup_s=t0 - t_start,
               attempted=len(in_window), failed=unanswered,
               trace=tr, memory_peak_bytes=int(stats["memory_peak_bytes"]),
               records=[r for r in rec.finished if r["served"] and t0 <= r["t_done"] < t_end],
               cross_kv_bits=kv_bits)
    run_.data = {
        "pushes": [(t, uid, age) for t, uid, age in pushes if t0 <= t < t_end],
        "ticks": {k: stats["t1"][k] - stats["t0"][k] for k in stats["t0"]},
        "slots": pool["slots"], "steps_per_chunk": pool["steps_per_chunk"],
        "steps": rec.steps,  # the trace's step spans are numbered by this list
        "window": (t0, t_end),
        "finished": [r for r in rec.finished if t0 <= r["t_done"] < t_end],
        "streams": mix["streams"],
    }
    fin = run_.data["finished"]
    if fin:
        run_.data["diagnostics"] = {
            "windows_finished": len(fin),
            "share_with_prefix": sum(1 for r in fin if r["history"]) / len(fin),
            "served_tokens_mean": sum(len(r["served"]) for r in fin) / len(fin),
            "prefix_tokens_mean": sum(len(r["history"]) for r in fin) / len(fin),
            "audio_s_mean": sum(r["audio_s"] for r in fin) / len(fin),
            "updates_by_third": [sum(1 for t, _, _ in run_.data["pushes"]
                                     if t0 + k * seconds / 3 <= t < t0 + (k + 1) * seconds / 3)
                                 for k in range(3)]}
    del engine, cs, backend
    if cuda:
        torch.cuda.empty_cache()
    return run_
