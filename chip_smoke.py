"""Drive the PyTorch port's serving paths once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; without CUDA it exits 1 before printing
a result):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the five CUDA kernels from whisperlive_tpu_torch/csrc with nvcc
   (one process per source, in parallel).
3. Hold each kernel against its plain PyTorch version on the card at the
   serving paths' shapes (large-v3) in bf16, with the stated tolerance,
   and time both (CUDA events, median of 20 runs of 10 calls), plus one
   PyTorch call that computes the same function where there is one (the
   port never calls it). K1 is also checked at the 512-position encoder
   context; K2 and K3 at the window batch's M=4 and the continuous pool's
   M=8 (each kernel's entry reports the pool's shape); K5 at [8,20,64] x [8,20,640,128] with mixed lengths, half the
   rows active and an active row of length 0, and timed at 8/8, 4/8 and
   1/8 rows active.
4. Serve the window path: large-v3 at full width with random bf16 weights
   from a seed, a WhisperEngine, BatchScheduler(max_batch_size=4) and
   TorchBackend, warmed up; two streaming sessions through the port's
   TranscriptionServer connection handler on an in-process websocket.
5. Serve the continuous path on the same engine: ContinuousScheduler
   (8 slots, 8 steps per chunk, cross cap 640, encoder buckets 512 and
   1500) behind TorchBackend; three ~8 s streaming sessions, the third
   joining 2 s late so that a window joins a running decode, one with the
   VAD gate off. Each path's launch counters are reset just before its
   sessions and read just after; every kernel of the path must have
   launched, and the slot state must lie on the card.
6. Check the output against a reference: the window path's encoder states
   and teacher-forced logits, and the continuous step (decode_step_masked
   on an 8-slot pool with per-slot cross_len and free rows, teacher
   forced), each against the same engine with every kernel wrapper
   swapped for its plain version; values must agree within the tolerance, be finite and have
   the expected shapes, and on the continuous step the argmax must agree
   on every active row up to ties within twice the measured error.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import asyncio
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from whisperlive_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler
from whisperlive_tpu_torch.engine.engine import WhisperEngine
from whisperlive_tpu_torch.engine.scheduler import BatchResult, BatchScheduler
from whisperlive_tpu_torch.engine.tokenizer import TokenSpec, WhisperTokenizer
from whisperlive_tpu_torch.models import whisper as wmod
from whisperlive_tpu_torch.ops import _kernels
from whisperlive_tpu_torch.ops import attention as attn_ops
from whisperlive_tpu_torch.ops import quant_matmul as qmm
from whisperlive_tpu_torch.serving import backends as backends_mod
from whisperlive_tpu_torch.serving.server import ClientManager, TranscriptionServer
from whisperlive_tpu_torch.serving.session import SessionOptions

MODEL = "large-v3"
SEED = 0
BATCH = 4
MAX_NEW_TOKENS = 48
WINDOW_SESSION_S = 5.0
CONT_SESSION_S = 8.0
CONT_SLOTS = 8
FRAME_S = 0.5

# H100 SXM peaks (NVIDIA datasheet): HBM bytes/s, dense bf16 FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12

KERNELS = {
    "fused_attention": ("whisperlive_tpu_torch/csrc/fused_attention.cu",
                        "whisperlive_tpu/ops/attention.py:583"),
    "int8_matmul": ("whisperlive_tpu_torch/csrc/int8_matmul.cu",
                    "whisperlive_tpu/ops/quant_matmul.py:29"),
    "int8_matmul_t": ("whisperlive_tpu_torch/csrc/int8_matmul_t.cu",
                      "whisperlive_tpu/ops/quant_matmul.py:40"),
    "cross_attention_int8": ("whisperlive_tpu_torch/csrc/cross_attention_int8.cu",
                             "whisperlive_tpu/ops/attention.py:158"),
    "cross_attention_int8_skip": ("whisperlive_tpu_torch/csrc/cross_attention_int8_skip.cu",
                                  "whisperlive_tpu/ops/attention.py:212"),
}
# the kernels each serving path must launch
WINDOW_PATH = ("fused_attention", "int8_matmul", "int8_matmul_t", "cross_attention_int8")
CONTINUOUS_PATH = ("fused_attention", "int8_matmul", "int8_matmul_t",
                   "cross_attention_int8_skip")


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def speech_like(seconds: float, seed: int = 0) -> np.ndarray:
    """Harmonics with syllabic amplitude modulation (passes the VAD gate)."""
    t = np.arange(int(16000 * seconds)) / 16000.0
    rng = np.random.default_rng(seed)
    f0 = 140 + 40 * np.sin(2 * np.pi * 2.1 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
    sig = sig * (0.55 + 0.45 * np.sin(2 * np.pi * 3.7 * t)) + 0.02 * rng.standard_normal(t.shape)
    return (0.12 * sig / np.max(np.abs(sig))).astype(np.float32)


class VisibleTokenizer(WhisperTokenizer):
    """Decodes each text token to a visible word: the repository has no BPE
    vocabulary, and empty text would keep the session from sending segments."""

    def decode(self, tokens):
        return "".join(f" t{int(t)}" for t in tokens if int(t) < self.spec.eot)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def median_ms(fn, warmup: int = 3, iters: int = 20, reps: int = 10) -> float:
    """Device time of one call: the median over `iters` samples of a run of
    `reps` calls between two CUDA events. Each run is queued behind a
    ~10 ms spin kernel so that the host has enqueued every call before the
    first starts; the events then bound device work only, not the Python
    and launch overhead of a single call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # GPU cycles
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(n_bytes: float, n_flops: float) -> dict:
    """Least time on the card: the larger of bytes over HBM rate and bf16
    operations over the tensor-core peak."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def library_time(name: str, fn) -> float | None:
    """Time one PyTorch call computing the same function; None where this
    PyTorch has no CUDA implementation of it."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"{name}: library call unavailable here ({type(e).__name__}: "
            f"{str(e).splitlines()[0][:120]})")
        return None
    return median_ms(fn)


def compare(name, shape, kernel_fn, ref_fn, rel_tol, rows=None):
    """Kernel vs plain version (on `rows` of the output only, when given)."""
    out = kernel_fn()
    torch.cuda.synchronize()
    ref = ref_fn()
    check(out.shape == ref.shape and out.dtype == ref.dtype,
          f"{name} {shape}: kernel gave {tuple(out.shape)} {out.dtype}, "
          f"plain {tuple(ref.shape)} {ref.dtype}")
    check(bool(torch.isfinite(out).all()), f"{name} {shape}: non-finite output")
    if rows is not None:
        out, ref = out[rows], ref[rows]
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = rel_tol * scale
    ms, plain_ms = median_ms(kernel_fn), median_ms(ref_fn)
    log(f"{name} {shape}: max_abs_err={err:.6g} tol={tol:.6g} ({rel_tol:g} x max|ref|="
        f"{scale:.6g}) kernel_ms={ms:.6g} plain_ms={plain_ms:.6g}")
    check(err <= tol, f"{name} {shape}: max_abs_err {err} > tolerance {tol}")
    return {"shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def kernel_phase(dev: torch.device) -> dict:
    cfg = wmod.WHISPER_CONFIGS[MODEL]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h, hd, t_enc, d = cfg.n_audio_head, cfg.head_dim, cfg.n_audio_ctx, cfg.n_text_state
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    results = {}
    # K1: encoder self-attention, bf16 output; flash (unnormalised bf16
    # probabilities) vs two-pass softmax round differently: 2^-6 of max|ref|.
    # T = 1500 on the window path, 512 on the continuous path's short tails.
    for b, t in ((BATCH, t_enc), (8, 512)):
        q, k, v = (randn(b, t, h, hd) for _ in range(3))
        r = compare(
            "fused_attention", f"q/k/v [{b},{t},{h},{hd}]",
            lambda: attn_ops.fused_attention(q, k, v),
            lambda: attn_ops.fused_attention_ref(q, k, v), 2.0**-6)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # [B, H, T, hd]
        r["library_ms"] = library_time("sdpa", lambda: sdpa(qh, kh, vh))
        r.update(bound(4 * b * t * h * hd * 2, 4 * b * h * t * t * hd))
        log(f"fused_attention [{b},{t}]: library (sdpa) {r['library_ms']} ms, "
            f"bound {r['bound_ms']:.6g} ms ({r['bound_by']})")
        results.setdefault("fused_attention", r)

    # K2: decoder linears at the window path's decode M=B, the continuous
    # pool's M=CONT_SLOTS (the kernel's second 4-row M tile) and prefill
    # M=B*16; bf16 output, f32 sums in another order: 2^-7 of max|ref|
    k2 = []
    decode_shapes = ((d, d), (d, 4 * d), (4 * d, d))
    for m, kk, n in ([(BATCH, kk, n) for kk, n in decode_shapes]
                     + [(CONT_SLOTS, kk, n) for kk, n in decode_shapes]
                     + [(BATCH * 16, d, 4 * d)]):
        x, w8, s = randn(m, kk), int8(kk, n), randn(n, scale=0.01).abs()
        r = compare(
            "int8_matmul", f"x [{m},{kk}] w8 [{kk},{n}]",
            lambda x=x, w8=w8, s=s: qmm.int8_matmul(x, w8, s),
            lambda x=x, w8=w8, s=s: qmm.int8_matmul_ref(x, w8, s), 2.0**-7)
        w8_nk = w8.t().contiguous()  # the library call's [N, K] layout, made once
        r["library_ms"] = library_time(
            "_weight_int8pack_mm", lambda x=x, w=w8_nk, s=s: torch._weight_int8pack_mm(x, w, s))
        r.update(bound(m * kk * 2 + kk * n + n * 2 + m * n * 2, 2 * m * kk * n))
        log(f"int8_matmul [{m},{kk}]x[{kk},{n}]: library (_weight_int8pack_mm) "
            f"{r['library_ms']} ms, bound {r['bound_ms']:.6g} ms ({r['bound_by']})")
        k2.append(r)
    # the entry reports the continuous pool's decode fc1 shape (the main
    # path's) and the worst error over every shape
    results["int8_matmul"] = dict(k2[4], max_abs_err=max(r["max_abs_err"] for r in k2))

    # K3: tied-embedding logits at the window path's M=B and the continuous
    # pool's M=CONT_SLOTS; f32 output and f32 sums: 1e-5 of max|ref|
    v_ = cfg.n_vocab
    w8, s = int8(v_, d), randn(v_, scale=0.01).abs()
    k3 = []
    for m in (BATCH, CONT_SLOTS):
        x = randn(m, d)
        r = compare(
            "int8_matmul_t", f"x [{m},{d}] w8 [{v_},{d}]",
            lambda x=x: qmm.int8_matmul_t(x, w8, s),
            lambda x=x: qmm.int8_matmul_t_ref(x, w8, s), 1e-5)
        r["library_ms"] = library_time(
            "_weight_int8pack_mm", lambda x=x: torch._weight_int8pack_mm(x, w8, s))
        r.update(bound(m * d * 2 + v_ * d + v_ * 2 + m * v_ * 4, 2 * m * d * v_))
        log(f"int8_matmul_t [{m},{d}]: library (_weight_int8pack_mm) {r['library_ms']} ms, "
            f"bound {r['bound_ms']:.6g} ms ({r['bound_by']})")
        k3.append(r)
    # the entry reports the continuous pool's shape (the main path's)
    results["int8_matmul_t"] = dict(k3[1], max_abs_err=max(r["max_abs_err"] for r in k3))

    # K4: decode cross-attention, f32 output; a probability that rounds to
    # the other bf16 neighbour moves the output by ~2^-9 of it: 1e-3 of max|ref|
    q, kvp = randn(BATCH, h, hd, scale=0.05), int8(BATCH, h, t_enc, 2 * hd)
    k4 = [compare(
        "cross_attention_int8", f"q [{BATCH},{h},{hd}] kvp [{BATCH},{h},{t_enc},{2 * hd}]",
        lambda: attn_ops.cross_attention_int8(q, kvp),
        lambda: attn_ops.cross_attention_int8_ref(q, kvp), 1e-3)]
    lengths = torch.tensor([t_enc, 700, 1, 0][:BATCH], dtype=torch.int32, device=dev)
    k4.append(compare(
        "cross_attention_int8", f"... lengths {lengths.tolist()}",
        lambda: attn_ops.cross_attention_int8(q, kvp, lengths),
        lambda: attn_ops.cross_attention_int8_ref(q, kvp, lengths), 1e-3))
    results["cross_attention_int8"] = dict(
        k4[0], max_abs_err=max(r["max_abs_err"] for r in k4), library_ms=None,
        **bound(BATCH * h * (t_enc * 2 * hd + hd * 2 + hd * 4), 4 * BATCH * h * t_enc * hd))

    # K5: the continuous step's cross-attention at the smoke pool's shape;
    # tolerance as K4's family on the card: 2^-6 of max|ref| on active rows
    b5, t5 = CONT_SLOTS, 640
    q, kvp = randn(b5, h, hd, scale=0.05), int8(b5, h, t5, 2 * hd)

    def k5_case(label, lens, act):
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        ac = torch.tensor(act, device=dev)
        r = compare(
            "cross_attention_int8_skip",
            f"q [{b5},{h},{hd}] kvp [{b5},{h},{t5},{2 * hd}] {label}",
            lambda: attn_ops.cross_attention_int8_skip(q, kvp, ln, ac),
            lambda: attn_ops.cross_attention_int8_skip_ref(q, kvp, ln, ac), 2.0**-6, rows=ac)
        n_bytes = sum(h * (min(n, t5) or t5) * 2 * hd + h * hd * 6
                      for n, a in zip(lens, act) if a) + b5 * 5
        n_flops = sum(4 * h * (min(n, t5) or t5) * hd for n, a in zip(lens, act) if a)
        r.update(bound(n_bytes, n_flops))
        log(f"cross_attention_int8_skip {label}: bound {r['bound_ms']:.6g} ms ({r['bound_by']})")
        return r

    mixed = [640, 300, 1, 640, 512, 17, 640, 100]
    k5 = [k5_case("all active, lengths mixed", mixed, [True] * b5),
          k5_case("half active", mixed, [i % 2 == 0 for i in range(b5)]),
          k5_case("one active row, len 0", [0] + mixed[1:], [True] + [False] * (b5 - 1))]
    occupancy = {}
    for n_act in (8, 4, 1):
        occupancy[n_act] = k5_case(f"{n_act}/{b5} active, len {t5}", [t5] * b5,
                                   [i < n_act for i in range(b5)])
    log("cross_attention_int8_skip occupancy: " + ", ".join(
        f"{n}/{b5} active {r['ms']:.6g} ms (bound {r['bound_ms']:.6g})"
        for n, r in occupancy.items()))
    results["cross_attention_int8_skip"] = dict(
        occupancy[8], max_abs_err=max(r["max_abs_err"] for r in k5 + list(occupancy.values())),
        library_ms=None)
    return results


# ---------------------------------------------------------------------------
# Phases 4 and 5: the serving paths
# ---------------------------------------------------------------------------


class ConnectionClosedOK(Exception):
    """Ends the fake connection ("Closed" in the name: a normal close)."""


class FakeWebSocket:
    """In-process websocket: a queue of incoming messages, recorded sends."""

    CLOSE = object()

    def __init__(self):
        self.incoming: asyncio.Queue = asyncio.Queue()
        self.sent: list[dict] = []

    async def recv(self):
        item = await self.incoming.get()
        if item is self.CLOSE:
            raise ConnectionClosedOK()
        return item

    async def send(self, message):
        self.sent.append(json.loads(message))

    async def close(self, *args):
        pass


class CountingBackend(backends_mod.TorchBackend):
    """TorchBackend that records every call: the serving layer logs and
    swallows backend exceptions, so the smoke test counts them itself."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calls: list[dict] = []
        self.started: dict[str, int] = {}

    async def transcribe(self, chunk, options, **kw):
        t0 = time.monotonic()
        self.started[kw.get("uid")] = self.started.get(kw.get("uid"), 0) + 1
        try:
            result = await super().transcribe(chunk, options, **kw)
            error = None
        except Exception as e:  # recorded, then re-raised to the session
            result, error = None, e
        self.calls.append(dict(uid=kw.get("uid"), seconds=len(chunk) / 16000.0,
                               latency_s=time.monotonic() - t0, result=result, error=error))
        if error is not None:
            raise error
        return result

    def n_calls(self, uid: str) -> int:
        return sum(1 for c in self.calls if c["uid"] == uid)


async def run_session(server, backend, uid, language, audio, delay_s=0.0, use_vad=True):
    await asyncio.sleep(delay_s)
    ws = FakeWebSocket()
    handshake = {"uid": uid, "language": language, "task": "transcribe", "model": MODEL,
                 "use_vad": use_vad}
    ws.incoming.put_nowait(json.dumps(handshake))
    task = asyncio.create_task(server.recv_audio(ws))
    step = int(16000 * FRAME_S)
    for off in range(0, len(audio), step):
        ws.incoming.put_nowait(audio[off:off + step].tobytes())
        await asyncio.sleep(FRAME_S)  # real-time pace
    ws.incoming.put_nowait(b"END_OF_AUDIO")
    # after the end of audio the session transcribes what is left of its
    # tail: close once a call has finished after it (or, with no call in
    # flight, the whole tail was already committed)
    at_eos = backend.n_calls(uid)
    client = server.client_manager.get_client(ws)
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        done = backend.n_calls(uid)
        drained = done == backend.started.get(uid, 0) and client and \
            client.session.buffered_duration() <= 1e-6
        if done > at_eos or (done and drained):
            break
        await asyncio.sleep(0.1)
    ws.incoming.put_nowait(FakeWebSocket.CLOSE)
    await task
    return ws


def serve(backend, sessions) -> tuple[list, float]:
    """Run the sessions through the server's connection handler, with every
    launch counter reset to 0 just before; returns (sockets, wall seconds).
    The caller stops its schedulers and then reads the counters."""
    server = TranscriptionServer()  # attributes as serve() sets them
    server.backend = backend
    server.backend_name = "torch"
    server.client_manager = ClientManager(max_clients=4, max_connection_time=600)

    async def all_sessions():
        return await asyncio.gather(*(run_session(server, backend, **s) for s in sessions))

    _kernels.reset_launches()
    t0 = time.monotonic()
    sockets = asyncio.run(all_sessions())
    torch.cuda.synchronize()
    return sockets, time.monotonic() - t0


def check_calls(backend, uids, min_calls):
    for c in backend.calls:
        res = c["result"]
        log(f"call {c['uid']}: {c['seconds']:.6g} s of audio, latency {c['latency_s']:.6g} s, "
            f"{len(res.raw_tokens) if isinstance(res, BatchResult) else 0} tokens, "
            f"error={c['error']!r}")
    check(len(backend.calls) >= min_calls, f"only {len(backend.calls)} backend calls")
    for c in backend.calls:
        check(c["error"] is None, f"backend call raised: {c['error']!r}")
        check(isinstance(c["result"], BatchResult), f"backend returned {c['result']!r}")
    check({c["uid"] for c in backend.calls} == set(uids), "every session must reach the backend")


def check_sockets(sockets):
    for ws in sockets:
        check(any(m.get("message") == "SERVER_READY" for m in ws.sent), "no SERVER_READY")
        check(any("segments" in m for m in ws.sent), "no segments reached the client")


def build_engine(dev: torch.device, cfg: wmod.WhisperConfig, batch_buckets) -> WhisperEngine:
    backends_mod._DISABLE_GATES = True  # random weights: first attempt passes
    backends_mod.STREAMING_MAX_NEW_TOKENS = MAX_NEW_TOKENS
    t0 = time.monotonic()
    params = wmod.init_params(cfg, SEED, torch.bfloat16, dev)
    engine = WhisperEngine(cfg, params, device=dev, batch_buckets=batch_buckets,
                           tokenizer=VisibleTokenizer(TokenSpec(cfg.n_vocab, multilingual=True)))
    del params
    torch.cuda.synchronize(dev)
    log(f"engine: {MODEL} random bf16 weights (seed {SEED}), decoder int8, cross-KV "
        f"{engine.cross_kv_bits}-bit, built in {time.monotonic() - t0:.6g} s")
    leaves = []
    wmod.tree_map(leaves.append, engine.params)
    check(all(t.device.type == "cuda" for t in leaves), "engine parameters off the card")
    return engine


def window_phase(engine: WhisperEngine) -> dict:
    t0 = time.monotonic()
    engine.warmup(batch_sizes=set(engine.batch_buckets))
    log(f"window warmup: {time.monotonic() - t0:.6g} s")

    engine_calls = []
    transcribe_batch = engine.transcribe_batch

    def recorded_transcribe_batch(audio, prompts, *args, **kw):
        start = time.monotonic()
        out = transcribe_batch(audio, prompts, *args, **kw)
        results, _, cross = out
        engine_calls.append(dict(
            batch=audio.shape[0], n_real=len(prompts), seconds=time.monotonic() - start,
            tokens=sum(len(r.tokens) + 1 for r in results),
            cross_devices={t.device.type for t in cross.values() if t is not None}))
        return out

    engine.transcribe_batch = recorded_transcribe_batch
    scheduler = BatchScheduler(engine, max_batch_size=BATCH, batch_window_ms=50)
    scheduler.start()
    try:
        backend = CountingBackend(scheduler, model_name=MODEL)
        sessions = [
            dict(uid="window-en", language="en", audio=speech_like(WINDOW_SESSION_S, 1)),
            dict(uid="window-detect", language=None, audio=speech_like(WINDOW_SESSION_S, 2)),
        ]
        sockets, wall = serve(backend, sessions)
    finally:
        scheduler.stop()
        del engine.transcribe_batch
    launches = dict(_kernels.launches)

    check_calls(backend, [s["uid"] for s in sessions], 4)
    for e in engine_calls:
        log(f"engine batch {e['n_real']}/{e['batch']}: {e['seconds']:.6g} s, "
            f"{e['tokens']} decoded tokens, {e['tokens'] / e['seconds']:.6g} tokens/s")
    busy = sum(e["seconds"] for e in engine_calls)
    tokens = sum(e["tokens"] for e in engine_calls)
    log(f"window sessions: {wall:.6g} s wall, {len(backend.calls)} backend calls, "
        f"{len(engine_calls)} engine batches, decode {tokens} tokens in {busy:.6g} s "
        f"engine time = {tokens / max(busy, 1e-9):.6g} tokens/s")
    log(f"window path launch counts: {launches}")
    for name in WINDOW_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched by the window path")
    check(all(e["cross_devices"] == {"cuda"} for e in engine_calls), "cross-KV off the card")
    check_sockets(sockets)
    check(any("language" in m for m in sockets[1].sent), "detected language never sent")
    return launches


def continuous_phase(engine: WhisperEngine) -> dict:
    cs = ContinuousScheduler(engine, n_slots=CONT_SLOTS, steps_per_chunk=8, cross_ctx=640,
                             enc_buckets=(512, 1500))
    t0 = time.monotonic()
    cs.warmup()
    log(f"continuous warmup: {time.monotonic() - t0:.6g} s")
    window = BatchScheduler(engine, max_batch_size=BATCH, batch_window_ms=50)
    window.start()
    cs.start()
    try:
        backend = CountingBackend(window, model_name=MODEL, continuous_scheduler=cs)
        routed = []
        pick = backend._pick_scheduler
        backend._pick_scheduler = lambda *a: routed.append(pick(*a)) or routed[-1]
        sessions = [
            dict(uid="cont-en", language="en", audio=speech_like(CONT_SESSION_S, 5)),
            dict(uid="cont-detect", language=None, audio=speech_like(CONT_SESSION_S, 6),
                 use_vad=False),
            dict(uid="cont-late", language="en", audio=speech_like(CONT_SESSION_S - 2.0, 7),
                 delay_s=2.0),
        ]
        sockets, wall = serve(backend, sessions)
    finally:
        cs.stop()  # joins the worker: no chunk is in flight below
        window.stop()
    launches = dict(_kernels.launches)
    state_devices = set()
    wmod.tree_map(lambda t: state_devices.add(t.device.type), cs.cb.state)
    steps = cs.cb.gstep
    idle_steps = int(cs.cb.state["idle_row_steps"])

    check_calls(backend, [s["uid"] for s in sessions], 6)
    check(all(s is cs for s in routed), "a continuous-path request went to the window path")
    ts = cs.tick_stats
    log(f"continuous sessions: {wall:.6g} s wall, {len(backend.calls)} backend calls, "
        f"{ts['ticks']} chunks, {steps} steps, mean step {ts['step_s'] / max(steps, 1) * 1e3:.6g}"
        f" ms (host clock, chunk dispatch + status copy over steps), insert "
        f"{ts['insert_s']:.6g} s in {ts['insert_calls']} inserts of {ts['insert_windows']} "
        f"windows, harvest {ts['harvest_s']:.6g} s, steps with inactive rows "
        f"{idle_steps}/{steps} = {idle_steps / max(steps, 1):.6g}, mean occupied rows per "
        f"chunk {ts['step_rows'] / max(ts['ticks'], 1):.6g} of {CONT_SLOTS}")
    log(f"continuous path launch counts: {launches}; per step: " + ", ".join(
        f"{n} {launches[n] / max(steps, 1):.6g}" for n in CONTINUOUS_PATH))
    for name in CONTINUOUS_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched by the continuous path")
    check(state_devices == {"cuda"}, f"slot state on {state_devices}, not the card")
    check(steps > 0 and launches["cross_attention_int8_skip"] ==
          steps * engine.cfg.n_text_layer, "K5 must launch once per decoder layer per step")
    check_sockets(sockets)
    check(any("language" in m for m in sockets[1].sent), "detected language never sent")
    profile_continuous_step(cs)
    return launches


def profile_continuous_step(cs: ContinuousScheduler, chunks: int = 2) -> None:
    """torch.profiler over `chunks` step chunks of the serving pool with
    three slots decoding: CUDA kernel launches per step and the device's
    busy share of the wall time. Device time sums the CUDA events only (a
    CPU op's device time repeats its kernels'); a profiler that records no
    CUDA event is reported as not measured."""
    cb = cs.cb
    cb.init_state()
    prompt, sot = cs.engine.build_prompt(
        backends_mod.transcribe_options_from_session(SessionOptions(language="en")),
        language="en")
    windows = np.zeros((3, 480000), np.float32)
    for i in range(3):
        windows[i, :96000] = speech_like(6.0, 20 + i)
    cb.insert(windows, [prompt] * 3, [sot] * 3, [True] * 3, [0, 1, 2], [0.0] * 3, [True] * 3,
              [1.0] * 3, [cb.ring - 1] * 3, enc_ctx=512)
    cb.step()  # warm
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(chunks):
            cb.step()
        wall = time.monotonic() - t0
    events = prof.key_averages()
    launch_keys = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                   "cuLaunchKernelEx")
    n_launch = sum(e.count for e in events if e.key in launch_keys)
    on_card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in on_card)
    n_steps = chunks * cb.steps_per_chunk
    device = (f"device time {device_us / 1e3 / n_steps:.6g} ms per step in "
              f"{len(on_card)} kinds of CUDA event, device busy share "
              f"{device_us / 1e6 / wall:.6g}" if on_card
              else "device time not measured (no CUDA events recorded)")
    log(f"continuous step profile ({n_steps} steps, 3 of {cb.n_slots} slots decoding): "
        f"{n_launch / n_steps:.6g} kernel launches per step, wall {wall / n_steps * 1e3:.6g} "
        f"ms per step under the profiler, {device}")


# ---------------------------------------------------------------------------
# Phase 6: output against the plain versions
# ---------------------------------------------------------------------------


PLAIN = {
    "fused_attention": attn_ops.fused_attention_ref,
    "int8_matmul": qmm.int8_matmul_ref,
    "int8_matmul_t": qmm.int8_matmul_t_ref,
    "cross_attention_int8": lambda q, kvp, lengths=None, active=None: (
        attn_ops.cross_attention_int8_ref(q, kvp, lengths) if active is None
        else attn_ops.cross_attention_int8_skip_ref(q, kvp, lengths, active)),
}


def plain_run(fn):
    """fn() with every kernel wrapper that models/whisper.py calls swapped
    for its plain version; no kernel may launch."""
    saved = {name: getattr(wmod, name) for name in PLAIN}
    try:
        for name, plain in PLAIN.items():
            setattr(wmod, name, plain)
        before = dict(_kernels.launches)
        out = fn()
        check(_kernels.launches == before, "the plain run launched a kernel")
        return out
    finally:
        for name, kernel in saved.items():
            setattr(wmod, name, kernel)


def compare_logits(label, a, b, rel_tol, shape):
    """Max error within rel_tol of max|b|. Returns whether the argmax agrees
    on every row up to ties: a row whose two argmaxes differ must have them
    within 2 x max_abs_err of each other in b (random weights give flat
    logits, and bf16 rounding then decides such a near-tie either way)."""
    check(a.shape == shape and a.dtype == torch.float32, f"{label}: logits {a.shape}")
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    ka, kb = a.argmax(-1), b.argmax(-1)
    rows = torch.nonzero(ka != kb).flatten()
    gaps = (b[rows, kb[rows]] - b[rows, ka[rows]]).tolist()
    log(f"reference: {label} max_abs_err={err:.6g} tol={rel_tol * scale:.6g} "
        f"argmax equal on {shape[0] - len(gaps)}/{shape[0]} rows"
        + (f"; rows {rows.tolist()} differ by plain-logit gaps {gaps} "
           f"(ties: <= {2 * err:.6g})" if gaps else ""))
    check(bool(torch.isfinite(a).all()) and err <= rel_tol * scale, f"{label} disagrees")
    return all(g <= 2 * err for g in gaps)


def window_reference(engine: WhisperEngine, steps: int = 4, rel_tol: float = 5e-2) -> None:
    """Encoder states and teacher-forced logits of the kernel path against
    the plain path."""
    cfg, dev = engine.cfg, engine.device
    audio = np.zeros((2, 480000), np.float32)
    audio[0, :128000] = speech_like(8.0, 3)
    audio[1, :64000] = speech_like(4.0, 4)
    prompt, _ = engine.build_prompt(
        backends_mod.transcribe_options_from_session(SessionOptions(language="en")))
    prompts = torch.tensor([prompt, prompt], dtype=torch.int32, device=dev)
    plen = torch.full((2,), len(prompt), dtype=torch.int32, device=dev)

    def run(tokens=None):
        with torch.inference_mode():
            enc, cross = engine.prepare(audio)
            self_kv = wmod.init_self_kv(cfg, 2, len(prompt) + steps, device=dev)
            logits = [wmod.decode_prefill(engine.params, cfg, prompts, plen, self_kv, cross)]
            forced = tokens if tokens is not None else []
            for i in range(steps):  # greedy on the kernel path, forced on both
                if tokens is None:
                    forced.append(logits[-1].argmax(-1).to(torch.int32))
                logits.append(wmod.decode_step(engine.params, cfg, forced[i], plen + i,
                                               len(prompt) + i, plen, len(prompt), self_kv,
                                               cross))
            return enc, logits, forced

    enc_k, logits_k, tokens = run()
    enc_r, logits_r, _ = plain_run(lambda: run(tokens))
    check(enc_k.shape == (2, cfg.n_audio_ctx, cfg.n_audio_state), f"encoder {enc_k.shape}")
    err = (enc_k.float() - enc_r.float()).abs().max().item()
    scale = enc_r.float().abs().max().item()
    log(f"reference: encoder states max_abs_err={err:.6g} tol={rel_tol * scale:.6g}")
    check(bool(torch.isfinite(enc_k.float()).all()) and err <= rel_tol * scale,
          "encoder states disagree with the plain path")
    for i, (a, b) in enumerate(zip(logits_k, logits_r)):
        compare_logits(f"window logits step {i}", a, b, rel_tol, (2, cfg.n_vocab))


def continuous_reference(engine: WhisperEngine, steps: int = 4, rel_tol: float = 5e-2) -> None:
    """The continuous step (decode_step_masked with per-slot cross_len and
    active rows, K5 on the kernel path) teacher forced from one inserted
    slot state of the serving pool's size, against the plain path. Active
    and free (inactive) rows lie in both 4-row M tiles of K2 and K3."""
    cfg, dev = engine.cfg, engine.device
    cb = ContinuousEngine(engine, n_slots=CONT_SLOTS, prompt_pad=64, ring=16,
                          steps_per_chunk=1, cross_ctx=640, enc_buckets=(512,))
    cb.init_state()
    prompt, sot = engine.build_prompt(
        backends_mod.transcribe_options_from_session(SessionOptions(language="en")),
        language="en")
    # (slot, seconds, encoder bucket); slots 3 and 4 stay free
    seats = ((0, 4.0, 512), (1, 6.0, 512), (5, 3.0, 512), (6, 8.0, 512), (2, 9.0, 1500),
             (7, 12.0, 1500))
    for enc_ctx in (512, 1500):
        wave = [(slot, sec) for slot, sec, e in seats if e == enc_ctx]
        windows = np.zeros((len(wave), 480000), np.float32)
        for i, (slot, seconds) in enumerate(wave):
            windows[i, : int(16000 * seconds)] = speech_like(seconds, 10 + slot)
        n = len(wave)
        cb.insert(windows, [prompt] * n, [sot] * n, [True] * n, [slot for slot, _ in wave],
                  [0.0] * n, [True] * n, [1.0] * n, [8] * n, enc_ctx=enc_ctx)
    st = cb.state
    want_len = [640] * CONT_SLOTS
    for slot, _, enc_ctx in seats:
        want_len[slot] = min(enc_ctx, 640)
    check(st["cross_len"].tolist() == want_len, f"cross_len {st['cross_len'].tolist()}")
    active = st["active"].clone()
    want_active = [i in {slot for slot, _, _ in seats} for i in range(CONT_SLOTS)]
    check(active.tolist() == want_active, f"active {active.tolist()}")
    plen = st["prompt_len"].clone()
    j = torch.arange(cb.cache_len, device=dev)[None, :]

    def run(tokens=None):
        self_kv = st["self_kv"].clone()
        logits = [st["logits"].clone()]
        forced = tokens if tokens is not None else []
        with torch.inference_mode():
            for i in range(steps):
                if tokens is None:
                    forced.append(logits[-1].argmax(-1).to(torch.int32))
                mask = (j < plen[:, None]) | ((j >= cb.prompt_pad) & (j < cb.prompt_pad + i))
                logits.append(wmod.decode_step_masked(
                    engine.params, cfg, forced[i], plen + i, cb.prompt_pad + i, mask, self_kv,
                    st["cross_kv"], cross_len=st["cross_len"], active=active))
        return logits, forced

    n5 = _kernels.launches["cross_attention_int8_skip"]
    logits_k, tokens = run()
    check(_kernels.launches["cross_attention_int8_skip"] == n5 + steps * cfg.n_text_layer,
          "the continuous step did not go through K5")
    logits_r, _ = plain_run(lambda: run(tokens))
    for i, (a, b) in enumerate(zip(logits_k[1:], logits_r[1:])):
        same = compare_logits(f"continuous logits step {i} (active rows)", a[active], b[active],
                              rel_tol, (len(seats), cfg.n_vocab))
        check(same, f"continuous step {i}: argmax differs from the plain path on an active "
              "row by more than a tie")


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card",
              file=sys.stderr)
        return 1
    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    _kernels.library()
    log(f"kernel build + load: {time.monotonic() - t0:.6g} s ({_kernels.library_path().name})")

    from whisperlive_tpu_torch.device import resolve_device

    resolve_device(dev)  # the engine's numerics policy (TF32 off)
    measured = kernel_phase(dev)
    engine = build_engine(dev, wmod.WHISPER_CONFIGS[MODEL], (1, 2, BATCH))
    window_launches = window_phase(engine)
    continuous_launches = continuous_phase(engine)
    window_reference(engine)
    continuous_reference(engine)

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        # launches on the path this kernel serves: the continuous path (this
        # slice's main path) for its kernels, the window path for K4
        path = continuous_launches if name in CONTINUOUS_PATH else window_launches
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": path[name], **measured[name]})
    log(f"chip_smoke total: {time.monotonic() - t_start:.6g} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
