"""Readings that set a cell's correctness limits: the program's and the
control's numbers on many seeds, in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 10

For each seed it runs the cell's traffic through the program for a short
window (the cell's own load) and judges the run as a benchmark run is
judged (harness.judge, through the reference module the configuration
names). Then it puts the control in the program's place: that module's
control_records answers the sampled requests one precision step below the
configuration (for a Whisper, reference.py's decoder linears and embedding
at int4, decoding each sampled window greedily after the same prompt, as
many tokens as the program served, and detecting its language). Those
answers, judged by harness.judge in turn, have to come out not correct.
One JSON line a seed, with every compared number of both. The benchmark's
own runs never run this. Needs a CUDA card, like run.py.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell: str, seed: int, seconds: float, device: str = "cuda", config=None,
             mix_override=None) -> dict:
    """One seed's readings (see the module's docstring)."""
    import dataclasses
    import importlib

    from benchmark import generator, harness

    spec = harness.load_spec()
    c = harness.find_cell(spec, cell)
    config = config or harness.load_config(spec, c["config"])
    ref = harness.reference(config, c["config"], "control_records")
    mix = generator.load_mix(c["traffic"])
    if mix_override:
        mix.update(mix_override)
    limits = harness.load_limits(cell)
    kind = importlib.import_module(f"benchmark.kinds.{mix['kind']}")
    run = kind.run(config=config, mix=mix, seed=seed, seconds=seconds, trace=False,
                   device=device, t_start=time.monotonic())
    t_ref = time.monotonic()
    ok, checks = harness.judge(run, config, seed, device, limits)
    ref_s = time.monotonic() - t_ref
    sample = harness.sample_records(run.records, mix["check"]["sample"], seed)
    ctrl = dataclasses.replace(run, records=ref.control_records(config, seed, device, sample))
    c_ok, c_checks = harness.judge(ctrl, config, seed, device, limits)
    return {"cell": cell, "seed": seed, "attempted": run.attempted, "failed": run.failed,
            "reference_s": ref_s,
            "program": {"correct": ok, **{k: v["value"] for k, v in checks.items()}},
            "control": {"correct": c_ok, **{k: v["value"] for k, v in c_checks.items()}}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=10.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("refused: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(args.workload, seed, args.seconds)
        print(json.dumps(r, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
