"""Time design variants of one hand-written kernel side by side on one card.

    python3 kernel_variants.py k1|k2|k3|k6|k7

Each variant is a text edit of the kernel's committed source in
whisperlive_tpu_torch/csrc/; "as built" is the source itself. One nvcc
process per variant, all started together, each into its own shared library
under build/variants/<kernel>/, with what `-Xptxas -v` reports for it. Every
variant that computes the kernel's function is held against the kernel's
plain version, then timed as chip_smoke.py times kernels (median of 20 runs
of 10 calls queued behind a spin kernel). "as built" is timed first and
again last, so that drift of the card shows; a variant that fails to build,
launch or agree is reported and skipped. The last line is one JSON object
with every number. Needs a CUDA card; exits 1 without one.

k1  K1 (fused_attention.cu) at the window path's [4,1500,20,64] and the
    continuous insert's [8,512,20,64] (2^-6 of max|ref|), beside
    scaled_dot_product_attention, with the instruction mix of each
    variant's key loop (`cuobjdump -sass`).
k2  K2 (int8_matmul.cu) at the continuous pool's decode shapes (M = 8:
    d x d, fc1, fc2 of large-v3) and prefill x [64,1280] x [1280,5120]
    (2^-7 of max|ref|), timed cold (rotating over distinct weight copies
    that exceed the L2) and over chip_smoke's decode-step sweep (256
    calls, 32 layers of distinct weights), after three floors of the
    method: an empty spin kernel, and the as-built K2 on one 64 x 64 tile
    and on two slices of it (a cluster of two).
k3  K3 (int8_matmul_t.cu) at chip_smoke's M = 1, 4, 8, 16, 40 against the
    large-v3 embedding [51866,1280] (1e-5 of max|ref|), timed cold as
    chip_smoke times it, beside its bound and one PyTorch reduction that
    only reads the same embedding copies (an observation). Two variants
    compute no output and are not checked: "copies only" (the copying warp
    streams every tile through the ring and the other warps only release
    the stages: the floor of K3's own copy mechanism in this timing) and
    "no stores" (everything but the stores of out).
k6  K6 and K5's window form (cross_attention.cu, Int8Packed at Tq > 1) at the
    window route's [1,20,Tq,64] x [1,20,1500,128] with lengths and the
    8-slot pool's [8,20,Tq,64] x [8,20,640,128] with 8/8 active, at Tq = 5
    (the verify window at k = 4) and 8, and at Tq = 1 (K4's and K5's
    instantiation at the same B and T), timed cold as chip_smoke times the
    cross-attention kernels (2^-6 of each row's max|ref|), beside the
    bound. "no math" computes no output and is not checked: it keeps the
    copy wave, the softmax's statistics over zero scores and the two
    exchanges, and drops the score and PV products, the floor of this
    design. "S / 2" and "S x 2" take half and twice the split that
    splits_for picks (twice needs clusters of 16, the non-portable size);
    "2 CTAs an SM" lets a window's instantiation take 128 registers; the
    others change how many queries a score or PV pass takes and how many
    independent sums a query's score takes.
k7  K7 and K8 (cross_attention.cu, Int4Halves) at K7's window-path
    [4,20,64] x 2x[4,20,1500,32] unmasked and the 8-slot pool's
    [8,20,64] x 2x[8,20,640,32] with mixed lengths, and K8 at the pool's
    [8,20,Tq,64] with mixed lengths at Tq = 5 and 8, timed cold as k6
    times them (2^-6 of each row's max|ref|), beside the bound: "as built",
    "no math" (the floor of the design, as in k6), "S / 2" and "S x 2".
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import torch

import chip_smoke
from whisperlive_tpu_torch.models import whisper as wmod
from whisperlive_tpu_torch.ops import _kernels
from whisperlive_tpu_torch.ops import attention as attn_ops
from whisperlive_tpu_torch.ops import quant_matmul as qmm

OUT_DIR = Path(__file__).resolve().parent / "build" / "variants"


class Built(NamedTuple):
    lib: ctypes.CDLL
    ptxas: str
    path: Path


def build_all(source: str, entries: tuple[str, ...], variants: dict) -> dict[str, Built]:
    """Compile every variant of csrc/<source> (in parallel) and load its C
    entry points `entries`; a variant that fails to build is reported and
    left out."""
    src = (_kernels.CSRC_DIR / source).read_text()
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        d = OUT_DIR / Path(source).stem / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(text)
        shutil.copy(_kernels.CSRC_DIR / "common.cuh", d)
        procs[name] = (d, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / "lib.so"),
             str(d / source)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (d, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            print(f"variant {name!r} failed to build:\n{err}", flush=True)
            continue
        lib = ctypes.CDLL(str(d / "lib.so"))
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = _kernels._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        built[name] = Built(lib, chip_smoke.ptxas_summary(err), d / "lib.so")
    if "as built" not in built:
        raise RuntimeError("the committed source failed to build")
    return built


def check_rc(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"launch failed: {rc}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def each_variant(built: dict[str, Built], run) -> list[dict]:
    """run(name, variant) -> row for every variant, "as built" first and
    last; a variant whose run raises is reported with its error."""
    rows = []
    for name in [*built, "as built"]:
        try:
            row = {"variant": name, "ptxas": built[name].ptxas, **run(name, built[name])}
        except RuntimeError as e:
            print(f"{name}: {e}", flush=True)
            row = {"variant": name, "ptxas": built[name].ptxas, "error": str(e)}
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# K1: the encoder's flash attention
# ---------------------------------------------------------------------------

K1_VARIANTS = {
    "as built": [],
    "exp2f": [("wl::exp2_approx(", "exp2f(")],
    "3 stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "8 warps x 16 rows": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    "64 queries a CTA": [("constexpr int kBq = 128; ", "constexpr int kBq = 64; ")],
    "128 keys a tile": [("constexpr int kBk = 64; ", "constexpr int kBk = 128;")],
    "3 CTAs an SM": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 3)")],
}
K1_SHAPES = ((4, 1500), (8, 512))
HEADS, HEAD_DIM = 20, 64


def loop_mix(lib_path: Path) -> dict[str, int]:
    """Instructions of the key loop's body as compiled (the span of the
    longest backward branch in `cuobjdump -sass`; it includes the Q load
    and the ragged-tile masking, which run on one pass only): the total,
    and the tensor-core products, SFU exponentials and ldmatrix among them."""
    cuobjdump = Path(_kernels._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    ins = [(int(m.group(1), 16), m.group(2)) for m in
           re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", sass)]
    loops = [(int(m.group(1), 16), addr) for addr, text in ins
             if (m := re.search(r"BRA\s+0x([0-9a-f]+)", text)) and int(m.group(1), 16) < addr]
    lo, hi = max(loops, key=lambda span: span[1] - span[0])
    body = [re.sub(r"^@!?U?P\w+\s+", "", text).split()[0] for addr, text in ins
            if lo <= addr <= hi]
    return {"total": len(body), "hmma": sum(op.startswith("HMMA") for op in body),
            "mufu_ex2": sum(op.startswith("MUFU.EX2") for op in body),
            "ldsm": sum(op.startswith("LDSM") for op in body)}


def k1_attention(lib: ctypes.CDLL, q, k, v, out) -> None:
    b, t, h, hd = q.shape
    check_rc(lib.wl_fused_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                                    t, h, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                    hd**-0.5, stream()))


def run_k1(built: dict[str, Built]) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []
    for b, t in K1_SHAPES:
        q, k, v = (torch.randn((b, t, HEADS, HEAD_DIM), generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        cases.append((b, t, q, k, v, attn_ops.fused_attention_ref(q, k, v).float(),
                      chip_smoke.median_ms(lambda: sdpa(qh, kh, vh))))

    def run(name: str, variant: Built) -> dict:
        row = {"key_loop": loop_mix(variant.path), "shapes": []}
        for b, t, q, k, v, ref, sdpa_ms in cases:
            out = torch.empty_like(q)
            k1_attention(variant.lib, q, k, v, out)
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            if not err <= ref.abs().max().item() / 64:
                raise RuntimeError(f"[{b},{t}]: error {err} over 2^-6 of max|ref|")
            ms = chip_smoke.median_ms(lambda: k1_attention(variant.lib, q, k, v, out))
            n_flops = 4 * b * HEADS * t * t * HEAD_DIM
            row["shapes"].append({"shape": [b, t, HEADS, HEAD_DIM], "ms": ms,
                                  "tflops": n_flops / ms * 1e-9, "sdpa_ms": sdpa_ms,
                                  "sdpa_ratio": ms / sdpa_ms, "max_abs_err": err})
            print(f"[{b},{t}] {name:18s} {ms:.6g} ms {n_flops / ms * 1e-9:.6g} TFLOP/s "
                  f"{ms / sdpa_ms:.6g}x sdpa ({sdpa_ms:.6g} ms); key loop {row['key_loop']}",
                  flush=True)
        return row
    return {"variants": each_variant(built, run)}


# ---------------------------------------------------------------------------
# K2: the decoder's int8 weight-only linear
# ---------------------------------------------------------------------------

K2_TARGET = "constexpr int kTargetCtas = 264;"
K2_STAGES = "NT <= 2 ? 8 : NT == 4 ? 6 : 4;"
K2_VARIANTS = {
    "as built": [],
    "no split over K": [(K2_TARGET, K2_TARGET.replace("264", "1"))],
    "132 CTAs target": [(K2_TARGET, K2_TARGET.replace("264", "132"))],
    "528 CTAs target": [(K2_TARGET, K2_TARGET.replace("264", "528"))],
    "4 stages at every NT": [(K2_STAGES, "4;")],
    "8 warps, 128 columns": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
                             (K2_STAGES, "NT <= 2 ? 4 : 3;")],
    "8 slices at most": [("constexpr int kMaxSplits = 4;", "constexpr int kMaxSplits = 8;")],
    "6 stages at NT <= 2": [(K2_STAGES, "NT <= 4 ? 6 : 4;")],
}


def k2_matmul(lib: ctypes.CDLL, x, w8, s) -> torch.Tensor:
    """The wrapper's launch with this library."""
    (m, k), n = x.shape, w8.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    check_rc(lib.wl_int8_matmul(x.data_ptr(), w8.data_ptr(), s.data_ptr(), out.data_ptr(), m, k,
                                n, stream()))
    return out


def run_k2(built: dict[str, Built]) -> dict:
    cfg = wmod.WHISPER_CONFIGS[chip_smoke.MODEL]
    d = cfg.n_text_state
    randn, int8 = chip_smoke.random_makers(torch.device("cuda"), chip_smoke.SEED)
    lib0 = built["as built"].lib
    floors = {"empty spin kernel": chip_smoke.median_ms(lambda: torch.cuda._sleep(1))}
    for label, k in (("one 64x64 tile", 64), ("two slices of it", 128)):
        x, w8, s = randn(1, k), int8(k, 64), randn(64, scale=0.01).abs()
        floors[label] = chip_smoke.median_ms(lambda x=x, w8=w8, s=s: k2_matmul(lib0, x, w8, s))
    for label, ms in floors.items():
        print(f"floor, {label}: {ms * 1e3:.6g} us", flush=True)

    shapes = [(chip_smoke.CONT_SLOTS, d, d), (chip_smoke.CONT_SLOTS, d, 4 * d),
              (chip_smoke.CONT_SLOTS, 4 * d, d), (chip_smoke.BATCH * 16, d, 4 * d)]
    cases = []
    for m, k, n in shapes:
        copies = -(-chip_smoke.COLD_BYTES // (k * n))
        cases.append((m, k, n, randn(m, k), [int8(k, n) for _ in range(copies)],
                      randn(n, scale=0.01).abs()))
    sweep = chip_smoke.step_sweep_calls(randn, int8, cfg)

    def run(name: str, variant: Built) -> dict:
        lib = variant.lib
        row = {"cold_us": {}}
        for m, k, n, x, w8s, s in cases:
            ref = qmm.int8_matmul_ref(x, w8s[0], s).float()
            err = (k2_matmul(lib, x, w8s[0], s).float() - ref).abs().max().item()
            if not err <= 2.0**-7 * ref.abs().max().item():
                raise RuntimeError(f"[{m},{k}]x[{k},{n}]: error {err} over 2^-7 of max|ref|")
            ms = chip_smoke.median_ms(chip_smoke.rotating(
                [lambda w=w: k2_matmul(lib, x, w, s) for w in w8s]), iters=10, reps=len(w8s))
            row["cold_us"][f"[{m},{k}]x[{k},{n}]"] = ms * 1e3

        def step():
            for x, w, s in sweep:
                k2_matmul(lib, x, w, s)
        row["sweep_us"] = chip_smoke.median_ms(step, warmup=2, iters=10, reps=1,
                                               spin_cycles=60_000_000) * 1e3
        print(f"{name:22s} sweep {row['sweep_us']:.6g} us; cold "
              + ", ".join(f"{key} {v:.6g}" for key, v in row["cold_us"].items()), flush=True)
        return row
    return {"floors_us": {k: v * 1e3 for k, v in floors.items()},
            "variants": each_variant(built, run)}


# ---------------------------------------------------------------------------
# K3: the tied-embedding logits
# ---------------------------------------------------------------------------

K3_FULL_WAIT = "wl::mbar_wait(&full[st], (i / stages) & 1);"
K3_SCALES_READ = "wl::named_barrier_sync(kReduceBarrier, kReduceThreads);"
K3_CTAS = "constexpr int kMaxCtasPerSm = 2;"
K3_RING = "constexpr int kMinStages = 2, kMaxStages = 8;"
K3_PLAN = "(occupancy == per_sm && per_sm * depth < kTilesPerSm)"
K3_VARIANTS = {
    "as built": [],
    "copies only": [(K3_FULL_WAIT, K3_FULL_WAIT + " if (true) { __syncwarp(); if (lane == 0)"
                     " wl::mbar_arrive(&empty[st]); continue; }"),
                    (K3_SCALES_READ, K3_SCALES_READ + " return;")],
    "no stores": [("const int cols = N - n0 - r;", "const int cols = N - n0 - r - (1 << 30);")],
    "4-byte stores only": [("cols >= 4 && (reinterpret_cast<uintptr_t>(o) & 15) == 0", "false")],
    "one CTA an SM": [(K3_CTAS, K3_CTAS.replace("2", "1"))],
    "ring of 2 tiles": [(K3_RING, K3_RING.replace("8", "2"))],
    "ring of 3 tiles": [(K3_RING, K3_RING.replace("2", "3").replace("8", "3"))],
    "ring of 4 tiles": [(K3_RING, K3_RING.replace("2", "4").replace("8", "4"))],
    "deepest ring": [(K3_PLAN, "(occupancy == per_sm)")],
}
K3_NO_OUTPUT = ("copies only", "no stores")


def k3_matmul_t(lib: ctypes.CDLL, x, w8, s) -> torch.Tensor:
    """The wrapper's launch with this library."""
    (m, k), n = x.shape, w8.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    check_rc(lib.wl_int8_matmul_t(x.data_ptr(), w8.data_ptr(), s.data_ptr(), out.data_ptr(), m,
                                  k, n, stream()))
    return out


def run_k3(built: dict[str, Built]) -> dict:
    cfg = wmod.WHISPER_CONFIGS[chip_smoke.MODEL]
    d, v = cfg.n_text_state, cfg.n_vocab
    randn, int8 = chip_smoke.random_makers(torch.device("cuda"), chip_smoke.SEED)
    copies = -(-chip_smoke.COLD_BYTES // (v * d))
    w8s, s = [int8(v, d) for _ in range(copies)], randn(v, scale=0.01).abs()
    xs = {m: randn(m, d) for m in chip_smoke.K3_ROWS}
    cold_timing = {"iters": 10, "reps": 10 * copies}
    read_ms = chip_smoke.median_ms(chip_smoke.rotating(
        [lambda w=w: w.view(torch.int64).sum() for w in w8s]), **cold_timing)
    print(f"a PyTorch int64 sum reading the {v * d / 1e6:.6g} MB embedding, cold: "
          f"{read_ms * 1e3:.6g} us", flush=True)
    bounds_us = {m: chip_smoke.k3_bound(m, d, v)["bound_ms"] * 1e3 for m in xs}

    def run(name: str, variant: Built) -> dict:
        row = {"checked": name not in K3_NO_OUTPUT, "cold_us": {}, "max_abs_err": {}}
        for m, x in xs.items():
            out = k3_matmul_t(variant.lib, x, w8s[0], s)
            if row["checked"]:
                ref = qmm.int8_matmul_t_ref(x, w8s[0], s)
                err = (out - ref).abs().max().item()
                if not err <= 1e-5 * ref.abs().max().item():
                    raise RuntimeError(f"M={m}: error {err} over 1e-5 of max|ref|")
                row["max_abs_err"][m] = err
            row["cold_us"][m] = chip_smoke.median_ms(chip_smoke.rotating(
                [lambda w=w, x=x: k3_matmul_t(variant.lib, x, w, s) for w in w8s]),
                **cold_timing) * 1e3
        print(f"{name:20s} cold " + ", ".join(
            f"M={m} {us:.6g} us ({us / bounds_us[m]:.6g}x bound)"
            for m, us in row["cold_us"].items()), flush=True)
        return row
    return {"embedding": [v, d], "copies": copies, "bound_us": bounds_us,
            "read_us": read_ms * 1e3, "variants": each_variant(built, run)}


# ---------------------------------------------------------------------------
# K6 and K5's window form: the speculative verify's int8 cross-attention
# ---------------------------------------------------------------------------

K6_SPLITS = "> kMaxChunkOf<Codec>[tq]) s *= 2;\n    return s;"
K6_SPLIT_CHECK = "(S != 1 && S != 2 && S != 4 && S != 8)"
K6_RAISED = "if (raised != cudaSuccess) return static_cast<int>(raised);"
K6_PV_TQ = "constexpr int kPvTq = kTq <= 5 ? kTq : (kTq + 1) / 2;"
K6_SCORE_TQ = "constexpr int kScoreTq = kTq <= 6 ? kTq : (kTq + 1) / 2;"
K6_BOUNDS = "kTq == 1 ? 1 : 3)"
K6_CLUSTERS_OF_16 = [  # splits_for's own choice stays within 8
    ("constexpr int kMaxSplits = 8;", "constexpr int kMaxSplits = 16;"),
    ("while (s < kMaxSplits && bh * s", "while (s < 8 && bh * s"),
    ("while (s < kMaxSplits && (T + s", "while (s < 8 && (T + s"),
    (K6_SPLIT_CHECK, "(S != 1 && S != 2 && S != 4 && S != 8 && S != 16)"),
    (K6_RAISED, K6_RAISED + " cudaFuncSetAttribute(cross_attention_kernel<Codec, kTq>, "
     "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);"),
]
K6_VARIANTS = {
    "as built": [],
    "no math": [("            float dot[kTq];\n            score_of(j, dot);",
                 "            float dot[kTq];\n            for (int t = 0; t < kTq; ++t) "
                 "dot[t] = r0 + j < len ? 0.0f : wl::kNegInf;"),
                ("if (j < rows) score_of(j, dot);",
                 "if (j < rows) dot[0] = r0 + j < len ? 0.0f : wl::kNegInf;"),
                ("for (int j = pr; j < rows; j += kPvLanes)",
                 "for (int j = pr; j < rows - (1 << 30); j += kPvLanes)")],
    "S / 2": [(K6_SPLITS, K6_SPLITS.replace("return s;", "return s > 1 ? s / 2 : 1;"))],
    "S x 2": K6_CLUSTERS_OF_16 + [(K6_SPLITS, K6_SPLITS.replace("return s;", "return 2 * s;"))],
    "2 CTAs an SM": [(K6_BOUNDS, "kTq == 1 ? 1 : 2)")],
    "one score pass at every Tq": [(K6_SCORE_TQ, "constexpr int kScoreTq = kTq;")],
    "PV in one pass": [(K6_PV_TQ, "constexpr int kPvTq = kTq;")],
    "four score sums a query": [("constexpr int kChains = kTq == 1 ? 4 : kTq == 2 ? 2 : 1;",
                                 "constexpr int kChains = 4;")],
}
K6_NO_OUTPUT = ("no math",)
K6_ENTRIES = ("wl_cross_attention_int8_window", "wl_cross_attention_int8_skip_window")


def k6_window(lib: ctypes.CDLL, q, kvp, ln, act) -> torch.Tensor:
    """The wrappers' launch with this library: K6 without `act`, else K5's
    window form."""
    b, h, tq, hd = q.shape
    t = kvp.shape[2]
    out = torch.empty((b, h, tq, hd), dtype=torch.float32, device=q.device)
    if act is None:
        check_rc(lib.wl_cross_attention_int8_window(q.data_ptr(), kvp.data_ptr(), ln.data_ptr(),
                                                    out.data_ptr(), b, h, t, tq, hd**-0.5,
                                                    stream()))
    else:
        check_rc(lib.wl_cross_attention_int8_skip_window(
            q.data_ptr(), kvp.data_ptr(), ln.data_ptr(), act.data_ptr(), out.data_ptr(), b, h, t,
            tq, hd**-0.5, stream()))
    return out


def run_k6(built: dict[str, Built]) -> dict:
    cfg = wmod.WHISPER_CONFIGS[chip_smoke.MODEL]
    h, hd, t_enc = cfg.n_audio_head, cfg.head_dim, cfg.n_audio_ctx
    b5, t5 = chip_smoke.CONT_SLOTS, chip_smoke.K5_T
    randn, int8 = chip_smoke.random_makers(torch.device("cuda"), chip_smoke.SEED)
    cases = []
    for b, t, masked in ((1, t_enc, False), (b5, t5, True)):
        ln = torch.full((b,), t, dtype=torch.int32, device="cuda")
        act = torch.ones(b, dtype=torch.bool, device="cuda") if masked else None
        n_bytes = b * h * t * 2 * hd
        copies = -(-chip_smoke.COLD_BYTES // n_bytes)
        kvps = [int8(b, h, t, 2 * hd) for _ in range(copies)]
        for tq in (1, chip_smoke.SPEC_K + 1, 8):
            q = randn(b, h, tq, hd, scale=0.05)
            ref = attn_ops.cross_attention_int8_window_ref(q, kvps[0], ln)
            work = (n_bytes + b * h * tq * hd * 6 + b * 5, 4 * b * h * tq * t * hd)
            cases.append((f"[{b},{h},{tq},{hd}] x [{b},{h},{t},{2 * hd}]", q, kvps, ln, act, ref,
                          chip_smoke.bound(*work)["bound_ms"] * 1e3))

    def run(name: str, variant: Built) -> dict:
        row = {"checked": name not in K6_NO_OUTPUT, "cold_us": {}, "max_abs_err": {}}
        for label, q, kvps, ln, act, ref, _ in cases:
            out = k6_window(variant.lib, q, kvps[0], ln, act)
            if row["checked"]:
                err = (out - ref).abs().flatten(1).amax(1)
                tol = 2.0**-6 * ref.abs().flatten(1).amax(1)
                if not bool((err <= tol).all()):
                    raise RuntimeError(f"{label}: error {err.tolist()} over 2^-6 of each row's "
                                       "max|ref|")
                row["max_abs_err"][label] = err.max().item()
            row["cold_us"][label] = chip_smoke.median_ms(chip_smoke.rotating(
                [lambda k=k, q=q, ln=ln, act=act: k6_window(variant.lib, q, k, ln, act)
                 for k in kvps]), iters=10, reps=len(kvps)) * 1e3
        print(f"{name:14s} cold " + ", ".join(f"{label} {us:.6g} us"
                                               for label, us in row["cold_us"].items()),
              flush=True)
        return row
    return {"bound_us": {c[0]: c[6] for c in cases}, "variants": each_variant(built, run)}


# ---------------------------------------------------------------------------
# K7 and K8: the int4 cross-attention, the same source over the Int4Halves
# codec
# ---------------------------------------------------------------------------

K7_VARIANTS = {name: K6_VARIANTS[name] for name in ("as built", "no math", "S / 2", "S x 2")}
K7_NO_OUTPUT = ("no math",)
K7_ENTRIES = ("wl_cross_attention_int4", "wl_cross_attention_int4_window")


def k7_int4(lib: ctypes.CDLL, q, k4, v4, ln) -> torch.Tensor:
    """The wrappers' launch with this library: K7 for a [B, H, 64] q, else
    K8; `ln` may be None."""
    b, h, t = k4.shape[:3]
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    len_ptr = None if ln is None else ln.data_ptr()
    args = (q.data_ptr(), k4.data_ptr(), v4.data_ptr(), len_ptr, out.data_ptr(), b, h, t)
    if q.dim() == 3:
        check_rc(lib.wl_cross_attention_int4(*args, HEAD_DIM**-0.5, stream()))
    else:
        check_rc(lib.wl_cross_attention_int4_window(*args, q.shape[2], HEAD_DIM**-0.5, stream()))
    return out


def run_k7(built: dict[str, Built]) -> dict:
    cfg = wmod.WHISPER_CONFIGS[chip_smoke.MODEL]
    h, hd, t_enc = cfg.n_audio_head, cfg.head_dim, cfg.n_audio_ctx
    b5, t5 = chip_smoke.CONT_SLOTS, chip_smoke.K5_T
    mixed = [640, 300, 1, 640, 512, 17, 640, 100]
    randn, int8 = chip_smoke.random_makers(torch.device("cuda"), chip_smoke.SEED)
    cases = []
    for b, t, tq, lens in ((chip_smoke.BATCH, t_enc, 1, None), (b5, t5, 1, mixed),
                           (b5, t5, chip_smoke.SPEC_K + 1, mixed), (b5, t5, 8, mixed)):
        used = [t] * b if lens is None else [min(n, t) or t for n in lens]
        n_bytes = sum(h * n * hd for n in used)  # the K and V rows one call reads
        copies = -(-chip_smoke.COLD_BYTES // n_bytes)
        kvs = [(int8(b, h, t, hd // 2), int8(b, h, t, hd // 2)) for _ in range(copies)]
        ln = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = randn(*((b, h, hd) if tq == 1 else (b, h, tq, hd)), scale=chip_smoke.Q_SCALE_INT4)
        ref = (attn_ops.cross_attention_int4_ref(q, *kvs[0], ln) if tq == 1 else
               attn_ops.cross_attention_int4_window_ref(q, *kvs[0], ln))
        work = (n_bytes + b * h * tq * hd * 6 + (0 if ln is None else 4 * b),
                sum(4 * h * tq * n * hd for n in used))
        label = (f"[{b},{h},{tq},{hd}] x 2x[{b},{h},{t},{hd // 2}]"
                 + ("" if lens is None else " lengths mixed"))
        cases.append((label, q, kvs, ln, ref, chip_smoke.bound(*work)["bound_ms"] * 1e3))

    def run(name: str, variant: Built) -> dict:
        row = {"checked": name not in K7_NO_OUTPUT, "cold_us": {}, "max_abs_err": {}}
        for label, q, kvs, ln, ref, _ in cases:
            out = k7_int4(variant.lib, q, *kvs[0], ln)
            if row["checked"]:
                err = (out - ref).abs().flatten(1).amax(1)
                tol = 2.0**-6 * ref.abs().flatten(1).amax(1)
                if not bool((err <= tol).all()):
                    raise RuntimeError(f"{label}: error {err.tolist()} over 2^-6 of each row's "
                                       "max|ref|")
                row["max_abs_err"][label] = err.max().item()
            row["cold_us"][label] = chip_smoke.median_ms(chip_smoke.rotating(
                [lambda kv=kv, q=q, ln=ln: k7_int4(variant.lib, q, *kv, ln) for kv in kvs]),
                iters=10, reps=len(kvs)) * 1e3
        print(f"{name:10s} cold " + ", ".join(f"{label} {us:.6g} us"
                                               for label, us in row["cold_us"].items()),
              flush=True)
        return row
    return {"bound_us": {c[0]: c[5] for c in cases}, "variants": each_variant(built, run)}


KERNELS = {
    "k1": ("fused_attention.cu", ("wl_fused_attention",), K1_VARIANTS, run_k1),
    "k2": ("int8_matmul.cu", ("wl_int8_matmul",), K2_VARIANTS, run_k2),
    "k3": ("int8_matmul_t.cu", ("wl_int8_matmul_t",), K3_VARIANTS, run_k3),
    "k6": ("cross_attention.cu", K6_ENTRIES, K6_VARIANTS, run_k6),
    "k7": ("cross_attention.cu", K7_ENTRIES, K7_VARIANTS, run_k7),
}


def main(argv: list[str]) -> int:
    if len(argv) != 1 or argv[0] not in KERNELS:
        print(f"usage: python3 kernel_variants.py {'|'.join(KERNELS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 1
    source, entries, variants, run = KERNELS[argv[0]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    built = build_all(source, entries, variants)
    for name, variant in built.items():
        print(f"{name}: {variant.ptxas}", flush=True)
    print(json.dumps({"card": card, "kernel": argv[0], **run(built)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
