"""Time design variants of K2 (csrc/int8_matmul.cu) side by side on one card.

    python3 k2_variants.py

Each variant is a text edit of the committed source; "as built" is the
source itself. One nvcc process per variant, all started together, each
into its own shared library under build/k2_variants/, with what
`-Xptxas -v` reports for it. Every variant is held against int8_matmul_ref
(2^-7 of max|ref|) at the continuous pool's decode shapes (M = 8: d x d,
fc1, fc2 of large-v3) and prefill x [64,1280] x [1280,5120], then timed
cold as chip_smoke.py times K2 (rotating over distinct weight copies that
exceed the L2), and over chip_smoke's decode-step sweep (256 calls, 32
layers of distinct weights). Three floors of the method come first: an
empty spin kernel (torch.cuda._sleep(1)), and the as-built K2 on one
64 x 64 tile (one CTA, one 4 KB stage) and on two slices of it (a cluster
of two, the split-K chain). "as built" is timed first and again last, so
that drift of the card shows; a variant that fails to build, launch or
agree is reported and skipped. The last line is one JSON object with every
number. Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from whisperlive_tpu_torch.models import whisper as wmod
from whisperlive_tpu_torch.ops import _kernels
from whisperlive_tpu_torch.ops import quant_matmul as qmm

TARGET = "constexpr int kTargetCtas = 264;"
VARIANTS = {
    "as built": [],
    "no split over K": [(TARGET, TARGET.replace("264", "1"))],
    "132 CTAs target": [(TARGET, TARGET.replace("264", "132"))],
    "528 CTAs target": [(TARGET, TARGET.replace("264", "528"))],
    "4 stages at every NT": [("NT <= 2 ? 8 : NT == 4 ? 6 : 4;", "4;")],
    "8 warps, 128 columns": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
                             ("NT <= 2 ? 8 : NT == 4 ? 6 : 4;", "NT <= 2 ? 4 : 3;")],
    "8 slices at most": [("constexpr int kMaxSplits = 4;", "constexpr int kMaxSplits = 8;")],
    "6 stages at NT <= 2": [("NT <= 2 ? 8 : NT == 4 ? 6 : 4;", "NT <= 4 ? 6 : 4;")],
}
OUT_DIR = Path(__file__).resolve().parent / "build" / "k2_variants"


def build_all() -> dict[str, tuple[ctypes.CDLL, str]]:
    """Compile every variant (in parallel); -> name: (library, ptxas report)."""
    src = (_kernels.CSRC_DIR / "int8_matmul.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        d = OUT_DIR / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / "int8_matmul.cu").write_text(text)
        shutil.copy(_kernels.CSRC_DIR / "common.cuh", d)
        procs[name] = (d, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / "lib.so"),
             str(d / "int8_matmul.cu")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            print(f"variant {name!r} failed to build:\n{err}", flush=True)
            continue
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.wl_int8_matmul.argtypes = _kernels._SIGNATURES["wl_int8_matmul"]
        lib.wl_int8_matmul.restype = ctypes.c_int
        libs[name] = (lib, chip_smoke.ptxas_summary(err))
    return libs


def matmul(lib: ctypes.CDLL, x, w8, s) -> torch.Tensor:
    """The wrapper's launch with this library."""
    (m, k), n = x.shape, w8.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = lib.wl_int8_matmul(x.data_ptr(), w8.data_ptr(), s.data_ptr(), out.data_ptr(), m, k, n,
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: {rc}")
    return out


def time_variant(lib, cases, sweep) -> dict:
    """Check at every case, then time cold and over the sweep."""
    row = {"cold_us": {}}
    for m, k, n, x, w8s, s in cases:
        ref = qmm.int8_matmul_ref(x, w8s[0], s).float()
        err = (matmul(lib, x, w8s[0], s).float() - ref).abs().max().item()
        if not err <= 2.0**-7 * ref.abs().max().item():
            raise RuntimeError(f"[{m},{k}]x[{k},{n}]: error {err} over 2^-7 of max|ref|")
        ms = chip_smoke.median_ms(chip_smoke.rotating(
            [lambda w=w: matmul(lib, x, w, s) for w in w8s]), iters=10, reps=len(w8s))
        row["cold_us"][f"[{m},{k}]x[{k},{n}]"] = ms * 1e3

    def step():
        for x, w, s in sweep:
            matmul(lib, x, w, s)
    row["sweep_us"] = chip_smoke.median_ms(step, warmup=2, iters=10, reps=1,
                                           spin_cycles=60_000_000) * 1e3
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_variants: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = build_all()
    for name, (_, ptxas) in libs.items():
        print(f"{name}: {ptxas}", flush=True)
    cfg = wmod.WHISPER_CONFIGS[chip_smoke.MODEL]
    d = cfg.n_text_state
    randn, int8 = chip_smoke.random_makers(torch.device("cuda"), chip_smoke.SEED)
    lib0 = libs["as built"][0]
    floors = {"empty spin kernel": chip_smoke.median_ms(lambda: torch.cuda._sleep(1))}
    for label, k in (("one 64x64 tile", 64), ("two slices of it", 128)):
        x, w8, s = randn(1, k), int8(k, 64), randn(64, scale=0.01).abs()
        floors[label] = chip_smoke.median_ms(lambda x=x, w8=w8, s=s: matmul(lib0, x, w8, s))
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

    rows = []
    for name in [*libs, "as built"]:
        lib, ptxas = libs[name]
        try:
            row = {"variant": name, "ptxas": ptxas, **time_variant(lib, cases, sweep)}
        except RuntimeError as e:
            print(f"{name}: {e}", flush=True)
            rows.append({"variant": name, "ptxas": ptxas, "error": str(e)})
            continue
        rows.append(row)
        print(f"{name:22s} sweep {row['sweep_us']:.6g} us; cold "
              + ", ".join(f"{key} {v:.6g}" for key, v in row["cold_us"].items()), flush=True)
    print(json.dumps({"card": card, "floors_us": {k: v * 1e3 for k, v in floors.items()},
                      "variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
