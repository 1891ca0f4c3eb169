"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; without CUDA it exits 1 before printing
a result):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the four CUDA kernels from whisperlive_tpu_torch/csrc with nvcc.
3. Hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes (large-v3, B=4) in bf16, with the stated
   tolerance, and time both (CUDA events, 3 warm-ups, median of 20).
4. Serve: large-v3 at full width with random bf16 weights from a seed, a
   WhisperEngine, BatchScheduler(max_batch_size=4) and TorchBackend,
   warmed up; then two streaming sessions (one with language "en", one
   detecting it) through TranscriptionServer's connection handler with an
   in-process websocket. Every launch counter is reset just before the
   sessions and read just after; every kernel must have launched.
5. Check the output against a reference on a small input: the same
   engine with every kernel wrapper swapped for its plain version, teacher
   forced on the same tokens; encoder states and logits must agree and be
   finite with the expected shapes.

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

from whisperlive_tpu.engine.tokenizer import TokenSpec, WhisperTokenizer
from whisperlive_tpu.serving.server import ClientManager, TranscriptionServer
from whisperlive_tpu.serving.session import SessionOptions
from whisperlive_tpu_torch.engine.engine import WhisperEngine
from whisperlive_tpu_torch.engine.scheduler import BatchResult, BatchScheduler
from whisperlive_tpu_torch.models import whisper as wmod
from whisperlive_tpu_torch.ops import _kernels
from whisperlive_tpu_torch.ops import attention as attn_ops
from whisperlive_tpu_torch.ops import quant_matmul as qmm
from whisperlive_tpu_torch.serving import backends as backends_mod

MODEL = "large-v3"
SEED = 0
BATCH = 4
MAX_NEW_TOKENS = 48
SESSION_AUDIO_S = 6.0
FRAME_S = 0.5

KERNELS = {
    "fused_attention": ("whisperlive_tpu_torch/csrc/fused_attention.cu",
                        "whisperlive_tpu/ops/attention.py:583"),
    "int8_matmul": ("whisperlive_tpu_torch/csrc/int8_matmul.cu",
                    "whisperlive_tpu/ops/quant_matmul.py:29"),
    "int8_matmul_t": ("whisperlive_tpu_torch/csrc/int8_matmul_t.cu",
                      "whisperlive_tpu/ops/quant_matmul.py:40"),
    "cross_attention_int8": ("whisperlive_tpu_torch/csrc/cross_attention_int8.cu",
                             "whisperlive_tpu/ops/attention.py:158"),
}


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


def compare(name, shape, kernel_fn, ref_fn, rel_tol):
    out = kernel_fn()
    torch.cuda.synchronize()
    ref = ref_fn()
    check(out.shape == ref.shape and out.dtype == ref.dtype,
          f"{name} {shape}: kernel gave {tuple(out.shape)} {out.dtype}, "
          f"plain {tuple(ref.shape)} {ref.dtype}")
    check(bool(torch.isfinite(out).all()), f"{name} {shape}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = rel_tol * scale
    ms, plain_ms = median_ms(kernel_fn), median_ms(ref_fn)
    log(f"{name} {shape}: max_abs_err={err:.6g} tol={tol:.6g} ({rel_tol:g} x max|ref|="
        f"{scale:.6g}) kernel_ms={ms:.6g} plain_ms={plain_ms:.6g}")
    check(err <= tol, f"{name} {shape}: max_abs_err {err} > tolerance {tol}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def kernel_phase(dev: torch.device) -> dict:
    cfg = wmod.WHISPER_CONFIGS[MODEL]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h, hd, t_enc, d = cfg.n_audio_head, cfg.head_dim, cfg.n_audio_ctx, cfg.n_text_state

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    results = {}
    # K1: encoder self-attention, bf16 output; flash (unnormalised bf16
    # probabilities) vs two-pass softmax round differently: 2^-6 of max|ref|
    q, k, v = (randn(BATCH, t_enc, h, hd) for _ in range(3))
    results["fused_attention"] = compare(
        "fused_attention", f"q/k/v [{BATCH},{t_enc},{h},{hd}]",
        lambda: attn_ops.fused_attention(q, k, v),
        lambda: attn_ops.fused_attention_ref(q, k, v), 2.0**-6)

    # K2: decoder linears at decode M=B and prefill M=B*16; bf16 output,
    # f32 sums in another order: 2^-7 of max|ref|
    k2 = []
    for m, kk, n in ((BATCH, d, d), (BATCH, d, 4 * d), (BATCH, 4 * d, d), (BATCH * 16, d, 4 * d)):
        x, w8, s = randn(m, kk), int8(kk, n), randn(n, scale=0.01).abs()
        k2.append(compare(
            "int8_matmul", f"x [{m},{kk}] w8 [{kk},{n}]",
            lambda x=x, w8=w8, s=s: qmm.int8_matmul(x, w8, s),
            lambda x=x, w8=w8, s=s: qmm.int8_matmul_ref(x, w8, s), 2.0**-7))
    # the entry reports the decode fc1 shape's times and the worst error
    results["int8_matmul"] = dict(k2[1], max_abs_err=max(r["max_abs_err"] for r in k2))

    # K3: tied-embedding logits, f32 output and f32 sums: 1e-5 of max|ref|
    x, w8, s = randn(BATCH, d), int8(cfg.n_vocab, d), randn(cfg.n_vocab, scale=0.01).abs()
    results["int8_matmul_t"] = compare(
        "int8_matmul_t", f"x [{BATCH},{d}] w8 [{cfg.n_vocab},{d}]",
        lambda: qmm.int8_matmul_t(x, w8, s), lambda: qmm.int8_matmul_t_ref(x, w8, s), 1e-5)

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
    results["cross_attention_int8"] = dict(k4[0], max_abs_err=max(r["max_abs_err"] for r in k4))
    return results


# ---------------------------------------------------------------------------
# Phase 4: the serving path
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

    async def transcribe(self, chunk, options, **kw):
        t0 = time.monotonic()
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


async def run_session(server, backend, uid, language, audio):
    ws = FakeWebSocket()
    handshake = {"uid": uid, "language": language, "task": "transcribe", "model": MODEL}
    ws.incoming.put_nowait(json.dumps(handshake))
    task = asyncio.create_task(server.recv_audio(ws))
    step = int(16000 * FRAME_S)
    for off in range(0, len(audio), step):
        ws.incoming.put_nowait(audio[off:off + step].tobytes())
        await asyncio.sleep(FRAME_S)  # real-time pace
    ws.incoming.put_nowait(b"END_OF_AUDIO")
    # after the end of audio the session keeps re-transcribing its tail:
    # close once a call has finished after it, and at least 3 in all
    wanted = max(backend.n_calls(uid) + 1, 3)
    deadline = time.monotonic() + 300
    while backend.n_calls(uid) < wanted and time.monotonic() < deadline:
        await asyncio.sleep(0.1)
    ws.incoming.put_nowait(FakeWebSocket.CLOSE)
    await task
    return ws


def serving_phase(dev: torch.device, cfg: wmod.WhisperConfig, batch_buckets):
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
    t0 = time.monotonic()
    engine.warmup(batch_sizes=set(batch_buckets))
    log(f"warmup: {time.monotonic() - t0:.6g} s")

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
        server = TranscriptionServer()  # attributes as serve() sets them
        server.backend = backend
        server.backend_name = "torch"
        server.client_manager = ClientManager(max_clients=4, max_connection_time=600)

        async def both():
            return await asyncio.gather(
                run_session(server, backend, "session-en", "en", speech_like(SESSION_AUDIO_S, 1)),
                run_session(server, backend, "session-detect", None,
                            speech_like(SESSION_AUDIO_S, 2)),
            )

        _kernels.reset_launches()
        t0 = time.monotonic()
        sockets = asyncio.run(both())
        torch.cuda.synchronize(dev)
        wall = time.monotonic() - t0
        launches = dict(_kernels.launches)
    finally:
        scheduler.stop()

    for c in backend.calls:
        res = c["result"]
        log(f"call {c['uid']}: {c['seconds']:.6g} s of audio, latency {c['latency_s']:.6g} s, "
            f"{len(res.raw_tokens) if isinstance(res, BatchResult) else 0} tokens, "
            f"error={c['error']!r}")
    for e in engine_calls:
        log(f"engine batch {e['n_real']}/{e['batch']}: {e['seconds']:.6g} s, "
            f"{e['tokens']} decoded tokens, {e['tokens'] / e['seconds']:.6g} tokens/s")
    busy = sum(e["seconds"] for e in engine_calls)
    tokens = sum(e["tokens"] for e in engine_calls)
    log(f"sessions: {wall:.6g} s wall, {len(backend.calls)} backend calls, "
        f"{len(engine_calls)} engine batches, decode {tokens} tokens in {busy:.6g} s "
        f"engine time = {tokens / max(busy, 1e-9):.6g} tokens/s")
    log(f"launch counts during the sessions: {launches}")

    check(len(backend.calls) >= 4, f"only {len(backend.calls)} backend calls")
    for c in backend.calls:
        check(c["error"] is None, f"backend call raised: {c['error']!r}")
        check(isinstance(c["result"], BatchResult), f"backend returned {c['result']!r}")
    check({c["uid"] for c in backend.calls} == {"session-en", "session-detect"},
          "both sessions must reach the backend")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the serving path")
    leaves = []
    wmod.tree_map(leaves.append, engine.params)
    check(all(t.device.type == "cuda" for t in leaves), "engine parameters off the card")
    check(all(e["cross_devices"] == {"cuda"} for e in engine_calls), "cross-KV off the card")
    for ws in sockets:
        check(any(m.get("message") == "SERVER_READY" for m in ws.sent), "no SERVER_READY")
        check(any("segments" in m for m in ws.sent), "no segments reached the client")
    check(any("language" in m for m in sockets[1].sent), "detected language never sent")
    return launches, engine


# ---------------------------------------------------------------------------
# Phase 5: output against the plain versions on a small input
# ---------------------------------------------------------------------------


def reference_phase(engine: WhisperEngine, steps: int = 4, rel_tol: float = 5e-2) -> None:
    """Encoder states and teacher-forced logits of the kernel path against
    the same engine with every kernel wrapper replaced by its plain version."""
    cfg, dev = engine.cfg, engine.device
    audio = np.zeros((2, 480000), np.float32)
    audio[0, :128000] = speech_like(8.0, 3)
    audio[1, :64000] = speech_like(4.0, 4)
    prompt, _ = engine.build_prompt(
        backends_mod.transcribe_options_from_session(SessionOptions(language="en")))
    prompts = torch.tensor([prompt, prompt], dtype=torch.int32, device=dev)
    plen = torch.full((2,), len(prompt), dtype=torch.int32, device=dev)

    def run():
        with torch.inference_mode():
            enc, cross = engine.prepare(audio)
            self_kv = wmod.init_self_kv(cfg, 2, len(prompt) + steps, device=dev)
            logits = [wmod.decode_prefill(engine.params, cfg, prompts, plen, self_kv, cross)]
            return enc, cross, self_kv, logits

    enc_k, cross_k, kv_k, logits_k = run()
    tokens = []
    for i in range(steps):  # greedy on the kernel path, forced on both
        tok = logits_k[-1].argmax(-1).to(torch.int32)
        tokens.append(tok)
        with torch.inference_mode():
            logits_k.append(wmod.decode_step(engine.params, cfg, tok, plen + i, len(prompt) + i,
                                             plen, len(prompt), kv_k, cross_k))
    swapped = {"fused_attention": attn_ops.fused_attention_ref,
               "cross_attention_int8": attn_ops.cross_attention_int8_ref,
               "int8_matmul": qmm.int8_matmul_ref, "int8_matmul_t": qmm.int8_matmul_t_ref}
    saved = {name: getattr(wmod, name) for name in swapped}
    try:
        for name, fn in swapped.items():
            setattr(wmod, name, fn)
        before = dict(_kernels.launches)
        enc_r, cross_r, kv_r, logits_r = run()
        for i, tok in enumerate(tokens):
            with torch.inference_mode():
                logits_r.append(wmod.decode_step(engine.params, cfg, tok, plen + i,
                                                 len(prompt) + i, plen, len(prompt), kv_r,
                                                 cross_r))
        check(_kernels.launches == before, "the plain run launched a kernel")
    finally:
        for name, fn in saved.items():
            setattr(wmod, name, fn)

    check(enc_k.shape == (2, cfg.n_audio_ctx, cfg.n_audio_state), f"encoder {enc_k.shape}")
    err = (enc_k.float() - enc_r.float()).abs().max().item()
    scale = enc_r.float().abs().max().item()
    log(f"reference: encoder states max_abs_err={err:.6g} tol={rel_tol * scale:.6g}")
    check(bool(torch.isfinite(enc_k.float()).all()) and err <= rel_tol * scale,
          "encoder states disagree with the plain path")
    for i, (a, b) in enumerate(zip(logits_k, logits_r)):
        check(a.shape == (2, cfg.n_vocab) and a.dtype == torch.float32, f"logits {a.shape}")
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        log(f"reference: logits step {i} max_abs_err={err:.6g} tol={rel_tol * scale:.6g} "
            f"argmax equal={bool((a.argmax(-1) == b.argmax(-1)).all())}")
        check(bool(torch.isfinite(a).all()) and err <= rel_tol * scale,
              f"logits at step {i} disagree with the plain path")


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card",
              file=sys.stderr)
        return 1
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
    launches, engine = serving_phase(dev, wmod.WHISPER_CONFIGS[MODEL], (1, 2, BATCH))
    reference_phase(engine)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], **measured[name]}
        for name, (src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
