"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA card (as many as the cell asks for): without one it exits
with code 2 and prints no result. --trace 0 reports the cell's end-to-end
metrics, --trace 1 its per-layer metrics from a traced stretch of the
window. The numbers the correctness check compared are printed beside
their limits, last on standard error and last in the result line.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs() -> None:
    """Kernel and extension caches at fixed paths inside the checkout."""
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"


def _one_core() -> None:
    """Run the process on one core, the last it may use, before any thread
    starts (threads inherit it). The program's Python threads (the pool's
    dispatch, the streams' event loop, the window scheduler) share one
    interpreter lock. On a virtual machine, every hand-off of that lock to a
    thread on another core waits for that core to wake: a 16-stream step
    took 83-87 ms unpinned and 75-77 ms pinned, on one H100 host."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cores[-1]})


def _finite(x):
    """JSON has no infinity: a non-finite number is printed as a string."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _cache_dirs()
    _one_core()
    sys.path.insert(0, str(ROOT))
    logging.basicConfig(level=logging.WARNING, format="%(asctime)s %(name)s %(message)s")

    import torch

    from benchmark import harness

    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"refused: the cell needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=T_START, spec=spec)
    result = _finite(result)
    info = result.pop("info", None)
    if info is not None:
        print("info " + json.dumps(info), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
