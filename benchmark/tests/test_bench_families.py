"""A configuration is judged by the reference module it names, so a model
family other than Whisper runs through the harness with files of its own:
a toy family (its reference, configuration, traffic kind and limits, the
last three given here in place of files) runs through `run_cell` and
`control.readings` without the Whisper reference being built, and stops
where its judge loads JAX or the JAX package; a configuration without a
sound `reference` stops before its run; and the Whisper runs are judged
alike through the harness and through their reference called directly,
with the end-to-end readers keyed on what each run recorded."""

import importlib
import sys
import time
import types

import numpy as np
import pytest

from benchmark import control, generator, harness
from benchmark import reference as ref

from .conftest import CELLS, TINY

TOY = {"source": "toy", "reference": "benchmark/tests/toy_reference.py", "exponent": 2}
TOY_CELL = "toy.pushes"
TOY_MIX = {"name": "toy", "kind": "toy", "requests": 40, "check": {"sample": 12}}
TOY_LIMITS = {"wrong_answers": {"limit": 0}, "answers_compared": {"limit": 10}}


def _toy_kind(answer):
    """benchmark.kinds.toy: answers each request with `answer(x)` and pushes
    one update a request, with a content age drawn from the seed."""
    runs = []

    def run(config, mix, seed, seconds, trace, device, t_start):
        rng = np.random.default_rng(seed)
        xs = rng.integers(0, 1000, mix["requests"])
        ages = rng.uniform(0.1, 0.5, mix["requests"])
        r = harness.Run(kind="toy", dims={}, mix=mix, seconds=seconds, setup_s=0.25,
                        attempted=len(xs), failed=0,
                        records=[{"x": int(x), "served": [answer(int(x))]} for x in xs])
        r.data = {"pushes": [(i * seconds / len(xs), f"c{i % 4}", float(a))
                             for i, a in enumerate(ages)]}
        runs.append(r)
        return r

    return types.SimpleNamespace(run=run, runs=runs)


@pytest.fixture
def toy(monkeypatch):
    """The toy cell in the benchmark's spec, reporting the stream metrics;
    its mix and limits served as the files would serve them."""
    spec = harness.load_spec()
    e2e = [dict(m, workloads=m["workloads"] + [TOY_CELL])
           if m["name"] in ("updates_per_s", "update_p95_s") else m
           for m in spec["end_to_end"]]
    spec = dict(spec, end_to_end=e2e,
                configs=spec["configs"] + [{"name": "toy", "file": "toy.json"}],
                workloads=spec["workloads"] + [{"name": TOY_CELL, "config": "toy",
                                                "traffic": "toy", "chips": 1}])
    load_mix, load_limits = generator.load_mix, harness.load_limits
    monkeypatch.setattr(generator, "load_mix",
                        lambda name: dict(TOY_MIX) if name == "toy" else load_mix(name))
    monkeypatch.setattr(harness, "load_limits",
                        lambda cell: TOY_LIMITS if cell == TOY_CELL else load_limits(cell))
    monkeypatch.setattr(harness, "load_spec", lambda: spec)

    def never(*a, **kw):
        raise AssertionError("the Whisper reference was built for the toy family")

    monkeypatch.setattr(ref, "Whisper", never)

    def install(answer):
        kind = _toy_kind(answer)
        monkeypatch.setitem(sys.modules, "benchmark.kinds.toy", kind)
        return kind

    return types.SimpleNamespace(spec=spec, install=install)


@pytest.mark.parametrize("sound", [True, False])
def test_a_toy_family_runs_with_files_alone(toy, sound):
    kind = toy.install((lambda x: x * x) if sound else (lambda x: x * x + (x % 3 == 0)))
    res = harness.run_cell(TOY_CELL, 2 ** 33 + 5, 4.0, False, device="cpu", spec=toy.spec,
                           config=dict(TOY))
    assert res["correct"] is sound
    assert list(res["checks"]) == ["wrong_answers", "answers_compared"]
    assert (res["checks"]["wrong_answers"]["value"] == 0) is sound
    assert res["checks"]["answers_compared"]["value"] == 12
    # the stream cell's end-to-end metrics, read from the toy's pushes
    (run,) = kind.runs
    pushes = run.data["pushes"]
    assert set(res["metrics"]) == {"updates_per_s", "update_p95_s", "setup_s"}
    assert res["metrics"]["updates_per_s"]["value"] == 40 / 4.0
    assert res["metrics"]["update_p95_s"]["value"] == pytest.approx(
        np.percentile([a for _, _, a in pushes], 95))


def test_a_toy_familys_control_comes_out_not_correct(toy):
    toy.install(lambda x: x * x)
    r = control.readings(TOY_CELL, 2 ** 33 + 7, 4.0, device="cpu", config=dict(TOY))
    assert r["program"] == {"correct": True, "wrong_answers": 0, "answers_compared": 12}
    assert r["control"] == {"correct": False, "wrong_answers": 12, "answers_compared": 12}


@pytest.mark.parametrize("module, stops", [
    ("jax", True),
    ("flax.linen", True),
    ("whisperlive_tpu.models.m2m100", True),
    ("whisperlive_tpu_torch.models.m2m100", False),
])
def test_what_the_named_judge_loads_is_checked_before_a_result(toy, monkeypatch, module, stops):
    toy.install(lambda x: x * x)
    toy_ref = importlib.import_module("benchmark.tests.toy_reference")
    judge = toy_ref.judge

    def loading_judge(*args):
        monkeypatch.setitem(sys.modules, module, types.ModuleType(module))
        return judge(*args)

    monkeypatch.setattr(toy_ref, "judge", loading_judge)
    run = lambda: harness.run_cell(TOY_CELL, 2 ** 33 + 11, 4.0, False,  # noqa: E731
                                   device="cpu", spec=toy.spec, config=dict(TOY))
    if stops:
        with pytest.raises(SystemExit, match=module.split(".")[0]):
            run()
    else:
        assert run()["correct"] is True


@pytest.mark.parametrize("reference, says", [
    (None, "no 'reference' key"),
    ("tests/conftest.py", "is no Python file under benchmark/"),
    ("benchmark/../tests/conftest.py", "is no Python file under benchmark/"),
    ("benchmark/configs/large-v3.json", "is no Python file under benchmark/"),
    ("benchmark/tests/missing_reference.py", "is no Python file under benchmark/"),
    ("benchmark/metrics/rtfx.py", "has no judge()"),
])
def test_a_configuration_without_a_sound_reference_stops_before_its_run(toy, reference, says):
    kind = toy.install(lambda x: x * x)
    config = {k: v for k, v in TOY.items() if k != "reference"}
    if reference is not None:
        config["reference"] = reference
    with pytest.raises(SystemExit) as stop:
        harness.run_cell(TOY_CELL, 2 ** 33 + 9, 4.0, False, device="cpu", spec=toy.spec,
                         config=config)
    msg = str(stop.value)
    assert msg.startswith("configuration 'toy': ") and says in msg
    assert "'reference'" in msg and (reference is None or repr(reference) in msg)
    assert kind.runs == []


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_whisper_runs_are_judged_by_their_named_reference(kind):
    cell, over, seconds = CELLS[kind]
    seed = 2 ** 33 + 13
    mix = dict(generator.load_mix(harness.find_cell(harness.load_spec(), cell)["traffic"]),
               **over)
    run = importlib.import_module(f"benchmark.kinds.{kind}").run(
        config=dict(TINY), mix=mix, seed=seed, seconds=seconds, trace=False, device="cpu",
        t_start=time.monotonic())
    limits = harness.load_limits(cell)
    through_harness = harness.judge(run, dict(TINY), seed, "cpu", limits)
    direct = ref.judge(run, dict(TINY), seed, "cpu", limits)
    assert through_harness == direct
    checks = through_harness[1]
    assert list(checks) == ["widest_gap", "unanswered", "tokens_compared", "cross_kv_bits_off"]
    assert [c["limit"] for c in checks.values()] == [
        limits["widest_gap"]["limit"], 0, limits["tokens_compared"]["limit"], 0]
    # each end-to-end reader reads what the run recorded, not its kind's name
    data = run.data
    rate, rtfx = harness.reader("updates_per_s").read(run), harness.reader("rtfx").read(run)
    if kind == "stream":
        assert rate == len(data["pushes"]) / run.seconds and rtfx is None
    else:
        assert data["done"] and rate is None
        assert rtfx == sum(sum(b["real_s"][: b["rows"]]) for b in data["done"]) / (
            max(b["t1"] for b in data["done"]) - data["t0"])
