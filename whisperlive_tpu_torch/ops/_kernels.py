"""Build, load and launch the port's CUDA kernels (csrc/*.cu).

On first use, `nvcc` compiles every source under whisperlive_tpu_torch/csrc
for sm_90a (one process per source, in parallel) and links them into one
shared library with a plain C interface, placed in
build/whisperlive_tpu_torch/ at the repository root and named by a hash of
the sources and flags; `ctypes` loads it. Nothing is built or loaded at
import time, so the CPU test suite imports every module without a CUDA
toolkit.

Every C launcher returns cudaGetLastError(); `launch` raises on a non-zero
code and only then counts the launch, so `launches[name]` is exactly the
number of times that kernel was enqueued since the last `reset_launches()`.
A CUDA graph's capture enqueues nothing: `capturing()` takes the launches
it records out of the counts, and each replay adds them back
(`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator

logger = logging.getLogger(__name__)

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "whisperlive_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

KERNELS = (
    "fused_attention", "int8_matmul", "int8_matmul_t", "cross_attention_int8",
    "cross_attention_int8_skip", "cross_attention_int8_window",
    "cross_attention_int8_skip_window", "cross_attention_int4", "cross_attention_int4_window",
)
launches: dict[str, int] = dict.fromkeys(KERNELS, 0)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "wl_fused_attention": [_P, _P, _P, _P, _I, _I, _I] + [_L] * 9 + [_F, _P],
    "wl_int8_matmul": [_P, _P, _P, _P, _I, _I, _I, _P],
    "wl_int8_matmul_t": [_P, _P, _P, _P, _I, _I, _I, _P],
    "wl_cross_attention_int8": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "wl_cross_attention_int8_skip": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "wl_cross_attention_int8_window": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "wl_cross_attention_int8_skip_window": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "wl_cross_attention_int4": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "wl_cross_attention_int4_window": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libwl_kernels-{digest.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the first failure's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [(p, *p.communicate()) for p in procs]
    for p, _, err in outs:
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(p.args)}\n{err}")
        if err.strip():
            logger.info("nvcc: %s", err.strip())


def build() -> Path:
    """Compile the kernels if this source set has not been built yet: one
    nvcc per source, all started together, then one link."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    _run_all([[_nvcc(), *compile_flags, "-c", "-o", str(o), str(s)]
              for s, o in zip(sources(), objs)])
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    os.replace(tmp, path)  # atomic: a concurrent build in another process sees all or nothing
    return path


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.wl_error_string.argtypes = [ctypes.c_int]
            lib.wl_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call the C launcher `wl_<name>`; raise on a CUDA error, else count."""
    lib = library()
    rc = getattr(lib, "wl_" + name)(*args)
    if rc != 0:
        msg = lib.wl_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")
    launches[name] += 1


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def capturing() -> Iterator[dict[str, int]]:
    """Around a CUDA graph's capture: yields a dict that holds, once the
    block exits, the launches the capture recorded (one replay's), which
    are taken out of `launches`."""
    before = dict(launches)
    recorded: dict[str, int] = {}
    try:
        yield recorded
    finally:
        for name, n in before.items():
            recorded[name] = launches[name] - n
            launches[name] = n


def add_launches(counts: dict[str, int], times: int = 1) -> None:
    """Count `times` replays of a CUDA graph whose capture recorded `counts`."""
    for name, n in counts.items():
        launches[name] += n * times
