"""The benchmark's core: BENCHMARK.json, the cells and their files, the
engine under test, the correctness check and the result line.

Everything a cell needs is found by name:

  configs/<config>.json     the model's sizes (HF config.json keys), the
                            precision it is served in ("serving") and its
                            "reference", the module that judges its runs;
  traffic/<traffic>.json    the mix's parameters; its "kind" names the
                            driver, kinds/<kind>.py, which runs the mix
                            through the program and records what it did;
  metrics/<metric>.py       one reader a metric (LAYER, UNIT, SOURCE,
                            MOVES, read(run) -> value or None);
  limits/<cell>.json        each compared number's limit and the readings
                            it was set from.

The program (whisperlive_tpu_torch) gives the system under test, its
counters and its spans; the yardstick (traffic, cost model, reference,
comparison, trace reduction) is here.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "whisperlive_tpu")


def load_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_config(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def metrics_for(spec: dict, cell: str, section: str) -> list[dict]:
    """The cell's metrics of `section`: those that list it, or that list no
    cells and move a metric the cell reports."""
    e2e = {m["name"] for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in spec[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def reader(name: str):
    """metrics/<name>.py as a module (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_limits(cell: str) -> dict:
    path = HERE / "limits" / f"{cell}.json"
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX package's, JAX's or
    Flax's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------


def visible_tokenizer(n_vocab: int):
    """The port's tokenizer over its byte vocabulary, decoding every text id
    to a visible word: random weights rarely emit byte ids, and text that
    decodes to nothing would keep sessions from pushing segments."""
    from whisperlive_tpu_torch.engine.tokenizer import TokenSpec, WhisperTokenizer

    class VisibleTokenizer(WhisperTokenizer):
        def decode(self, tokens):
            return "".join(f" t{int(t)}" for t in tokens if int(t) < self.spec.eot)

        def split_to_word_tokens(self, tokens):
            text = [int(t) for t in tokens if int(t) < self.spec.eot]
            return [f" t{t}" for t in text], [[t] for t in text]

    return VisibleTokenizer(TokenSpec(n_vocab, multilingual=n_vocab >= 51865))


def build_engine(config: dict, seed: int, device: str, batch_buckets=None):
    """The port's WhisperEngine on weights drawn from `seed` on `device`, at
    the precision the configuration serves."""
    import torch

    from benchmark.weights import dims, make_params
    from whisperlive_tpu_torch.engine.engine import DEFAULT_BATCH_BUCKETS, WhisperEngine
    from whisperlive_tpu_torch.models.whisper import WhisperConfig

    dm = dims(config)
    serving = config["serving"]
    cfg = WhisperConfig(dm["n_mels"], dm["n_vocab"], dm["n_audio_ctx"], dm["d"],
                        dm["n_audio_head"], dm["n_audio_layer"], dm["n_text_ctx"], dm["d"],
                        dm["n_text_head"], dm["n_text_layer"])
    cuda = torch.device(device).type == "cuda"
    dtype = getattr(torch, serving["weight_dtype"]) if cuda else torch.float32
    params = make_params(config, seed, device, dtype=dtype)
    return WhisperEngine(
        cfg, params, tokenizer=visible_tokenizer(dm["n_vocab"]),
        batch_buckets=batch_buckets or DEFAULT_BATCH_BUCKETS,
        decoder_int8=serving["decoder_weight_bits"] == 8,
        cross_kv_bits=serving["cross_kv_bits"], device=device,
        compute_dtype=getattr(torch, serving["compute_dtype"]) if cuda else torch.float32,
    )


@dataclasses.dataclass
class Run:
    """What a driver recorded: read by the metric readers and the check."""

    kind: str
    dims: dict
    mix: dict
    seconds: float
    setup_s: float
    attempted: int = 0
    failed: int = 0
    data: dict = dataclasses.field(default_factory=dict)
    trace: dict | None = None
    memory_peak_bytes: int = 0
    records: list = dataclasses.field(default_factory=list)  # for the check
    cross_kv_bits: int | None = None  # the width of the cross-KV the timed path wrote


def cross_kv_bits(cross: dict, head_dim: int) -> int:
    """The bits a value of the program's cross-KV holds, read from the
    layout its insert or prepare wrote: K|V int8 codes side by side (kv8),
    two int4 codes a byte (kv4), or float K and V (kv); -1 for any other."""
    import torch

    if "kv8" in cross:
        c = cross["kv8"]
        return 8 if c.dtype == torch.int8 and c.shape[-1] == 2 * head_dim else -1
    if "kv4" in cross:
        c = cross["kv4"]
        return 4 if c.dtype == torch.int8 and c.shape[-1] == head_dim // 2 else -1
    if "kv" in cross:
        return cross["kv"].element_size() * 8
    return -1


# ---------------------------------------------------------------------------
# Correctness
# ---------------------------------------------------------------------------


def sample_records(records: list, k: int, seed: int) -> list:
    """k records drawn from the seed, the one with the most served tokens
    always among them."""
    if not records:
        return []
    rng = np.random.default_rng([seed, 9])
    longest = max(range(len(records)), key=lambda i: len(records[i]["served"]))
    rest = [i for i in range(len(records)) if i != longest]
    pick = [longest] + list(rng.choice(rest, size=min(k - 1, len(rest)), replace=False))
    return [records[i] for i in sorted(pick)]


def reference(config: dict, name: str | None = None, entry: str = "judge"):
    """The module the configuration's "reference" key names (a path from the
    repository's root to a file under benchmark/), imported as a module of
    the benchmark package, with `entry` checked present. Each family's module judges its
    own runs: judge(run, config, seed, device, limits) -> (correct, checks),
    and puts its control in the program's place: control_records(config,
    seed, device, sample) -> records. `name` labels the configuration in a
    refusal (its source where not given)."""
    label = name or config.get("source", "given as a dict")
    rel = config.get("reference")
    if not isinstance(rel, str):
        raise SystemExit(f"configuration {label!r}: no 'reference' key naming the module "
                         "that judges its runs")
    path = (ROOT / rel).resolve()
    if not path.is_relative_to(HERE) or path.suffix != ".py" or not path.is_file():
        raise SystemExit(f"configuration {label!r}: its 'reference' {rel!r} is no Python file "
                         "under benchmark/")
    mod = importlib.import_module(".".join(path.relative_to(ROOT).with_suffix("").parts))
    if not callable(getattr(mod, entry, None)):
        raise SystemExit(f"configuration {label!r}: its 'reference' {rel!r} has no {entry}()")
    return mod


def judge(run: Run, config: dict, seed: int, device: str, limits: dict) -> tuple[bool, dict]:
    """Compare the sampled answers with the reference the configuration
    names. Returns (correct, {number: {"value", "limit"}})."""
    return reference(config).judge(run, config, seed, device, limits)


# ---------------------------------------------------------------------------
# One run of one cell
# ---------------------------------------------------------------------------


def device_info(device: str, chips: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    try:
        import subprocess

        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.split("\n")[0]
        info["power_limit"] = out.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, spec: dict | None = None,
             config: dict | None = None, mix_override: dict | None = None) -> dict:
    """Run one cell once and return the result object (the last line's
    content), with "checks" last. spec/config/mix_override serve the tests
    (a tiny configuration on the CPU)."""
    import torch

    from benchmark import generator

    t_start = time.monotonic() if t_start is None else t_start
    spec = spec or load_spec()
    cell = find_cell(spec, cell_name)
    config = config or load_config(spec, cell["config"])
    reference(config, cell["config"])  # a configuration with no judge stops before its run
    mix = generator.load_mix(cell["traffic"])
    if mix_override:
        mix.update(mix_override)
    kind = importlib.import_module(f"benchmark.kinds.{mix['kind']}")
    run = kind.run(config=config, mix=mix, seed=seed, seconds=seconds, trace=trace,
                   device=device, t_start=t_start)
    limits = load_limits(cell_name)
    correct, checks = judge(run, config, seed, device, limits)
    metrics, info = {}, {}
    for section in ("end_to_end", "per_layer"):
        for m in metrics_for(spec, cell_name, section):
            value = reader(m["name"]).read(run)
            if value is None:
                continue
            if section == ("per_layer" if trace else "end_to_end"):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            info[m["name"]] = value
    dev = device_info(device, cell["chips"])
    dev["memory_peak_bytes"] = run.memory_peak_bytes
    out: dict[str, Any] = {"correct": bool(correct), "attempted": run.attempted,
                           "failed": run.failed, "metrics": metrics, "device": dev}
    if trace:
        tr = run.trace or {}
        dev["busy_s"] = tr.get("busy_s", 0.0)
        dev["window_s"] = tr.get("window_s", 0.0)
        if tr:
            out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    info.update(run.data.get("diagnostics", {}))
    if run.trace:
        info["trace_events"] = run.trace["events"]
    out["info"] = info  # run.py prints it on standard error
    out["checks"] = checks
    # last, so that what the judge and the readers load is seen too
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {', '.join(found)}")
    return out
