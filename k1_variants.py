"""Time design variants of K1 (csrc/fused_attention.cu) side by side on one card.

    python3 k1_variants.py

Each variant is a text edit of the committed source; "as built" is the
source itself. One nvcc process per variant, all started together, each
into its own shared library under build/k1_variants/, with what
`-Xptxas -v` reports for it and the instruction mix of its key loop
(`cuobjdump -sass`). Every variant is held against
fused_attention_ref (2^-6 of max|ref|) at the window path's [4,1500,20,64]
and the continuous insert's [8,512,20,64], then timed as chip_smoke.py
times kernels (median of 20 runs of 10 calls), beside
scaled_dot_product_attention on the same inputs. "as built" is timed first
and again last, so that drift of the card shows. The last line is one JSON
object with every number. Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from whisperlive_tpu_torch.ops import _kernels
from whisperlive_tpu_torch.ops import attention as attn_ops

VARIANTS = {
    "as built": [],
    "exp2f": [("wl::exp2_approx(", "exp2f(")],
    "3 stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "8 warps x 16 rows": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    "64 queries a CTA": [("constexpr int kBq = 128; ", "constexpr int kBq = 64; ")],
    "128 keys a tile": [("constexpr int kBk = 64; ", "constexpr int kBk = 128;")],
    "3 CTAs an SM": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 3)")],
}
SHAPES = ((4, 1500), (8, 512))
HEADS, HEAD_DIM = 20, 64
OUT_DIR = Path(__file__).resolve().parent / "build" / "k1_variants"


def build_all() -> dict[str, tuple[ctypes.CDLL, str, dict]]:
    """Compile every variant (in parallel); -> name: (library, ptxas
    report, instruction mix of the key loop)."""
    src = (_kernels.CSRC_DIR / "fused_attention.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        d = OUT_DIR / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / "fused_attention.cu").write_text(text)
        shutil.copy(_kernels.CSRC_DIR / "common.cuh", d)
        procs[name] = (d, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / "lib.so"),
             str(d / "fused_attention.cu")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} failed to build:\n{err}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.wl_fused_attention.argtypes = _kernels._SIGNATURES["wl_fused_attention"]
        lib.wl_fused_attention.restype = ctypes.c_int
        libs[name] = (lib, chip_smoke.ptxas_summary(err), loop_mix(d / "lib.so"))
    return libs


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


def launch(lib: ctypes.CDLL, q, k, v, out) -> None:
    b, t, h, hd = q.shape
    rc = lib.wl_fused_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, h,
                                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], hd**-0.5,
                                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: {rc}")


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_variants: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = build_all()
    for name, (_, ptxas, mix) in libs.items():
        print(f"{name}: {ptxas}; key loop {mix}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for b, t in SHAPES:
        q, k, v = (torch.randn((b, t, HEADS, HEAD_DIM), generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        out = torch.empty_like(q)
        ref = attn_ops.fused_attention_ref(q, k, v).float()
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa_ms = chip_smoke.median_ms(lambda: sdpa(qh, kh, vh))
        n_flops = 4 * b * HEADS * t * t * HEAD_DIM
        for name in [*libs, "as built"]:
            lib, ptxas, mix = libs[name]
            launch(lib, q, k, v, out)
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            if not err <= ref.abs().max().item() / 64:
                raise RuntimeError(f"variant {name!r} [{b},{t}]: error {err} over 2^-6 of max|ref|")
            ms = chip_smoke.median_ms(lambda lib=lib: launch(lib, q, k, v, out))
            rows.append({"variant": name, "shape": [b, t, HEADS, HEAD_DIM], "ms": ms,
                         "tflops": n_flops / ms * 1e-9, "sdpa_ms": sdpa_ms,
                         "sdpa_ratio": ms / sdpa_ms, "max_abs_err": err, "ptxas": ptxas,
                         "key_loop": mix})
            print(f"[{b},{t}] {name:18s} {ms:.6g} ms {n_flops / ms * 1e-9:.6g} TFLOP/s "
                  f"{ms / sdpa_ms:.6g}x sdpa ({sdpa_ms:.6g} ms)", flush=True)
    print(json.dumps({"card": card, "variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
