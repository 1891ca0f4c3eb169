"""The reference of a toy family, named by the toy configuration in
test_bench_families.py: its program answers each request with the request's
number raised to the configuration's `exponent`. `judge` counts the sampled
answers that differ from the reference's; `control_records` answers one too
high, as a control one step off would."""


def judge(run, config: dict, seed: int, device: str, limits: dict) -> tuple[bool, dict]:
    from benchmark import harness

    sample = harness.sample_records(run.records, run.mix["check"]["sample"], seed)
    wrong = sum(r["served"] != [r["x"] ** config["exponent"]] for r in sample)
    checks = {"wrong_answers": {"value": wrong, "limit": limits["wrong_answers"]["limit"]},
              "answers_compared": {"value": len(sample),
                                   "limit": limits["answers_compared"]["limit"]}}
    ok = (wrong <= checks["wrong_answers"]["limit"] and run.attempted > 0 and run.failed == 0
          and len(sample) >= checks["answers_compared"]["limit"])
    return ok, checks


def control_records(config: dict, seed: int, device: str, sample: list) -> list:
    return [dict(r, served=[r["x"] ** config["exponent"] + 1]) for r in sample]
