"""A run whose timed path is broken underneath comes out not correct. Each
test skips the harness's look for a card, drives the rest of a run at a
tiny width on the CPU with one fault planted in the program, and sees
`correct` false. The faults a serving cell can have: a step that returns
its state unchanged, half of the batch left out (its rows computed from the
other half's), and a token altered where it is produced. (No cell spans
chips, so no exchange between chips can be left out.)"""

import pytest

from benchmark import harness

from .conftest import CELLS, WIDE


def _run(kind: str, **extra):
    cell, over, seconds = CELLS[kind]
    over = dict(over, drain_s=3.0, **extra)
    return harness.run_cell(cell, 2 ** 32 + 101, seconds, False, device="cpu",
                            config=dict(WIDE), mix_override=over)


def test_step_that_leaves_the_state_unchanged(monkeypatch):
    from whisperlive_tpu_torch.engine import continuous, continuous_state

    def frozen_step(self):  # the status of the pool as it stands, no decode
        return self._fetch(continuous_state.pack_status(self.state, self.beam_width).float(),
                           rows=True)

    monkeypatch.setattr(continuous.ContinuousEngine, "step", frozen_step)
    res = _run("stream")
    assert not res["correct"]
    assert res["checks"]["unanswered"]["value"] > 0 or res["attempted"] == 0


def test_decode_step_that_returns_the_last_logits(monkeypatch):
    from whisperlive_tpu_torch.models import whisper as wmod

    last = {}
    orig = wmod.decode_step

    def stale(params, cfg, token, *a, **kw):
        out = orig(params, cfg, token, *a, **kw)
        key = tuple(out.shape)
        prev = last.get(key)
        last[key] = out
        return prev if prev is not None else out

    monkeypatch.setattr(wmod, "decode_step", stale)
    assert not _run("files")["correct"]


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_half_of_the_batch_left_out(kind, monkeypatch):
    """The batched op of each path computes half its rows and hands the
    other half copies: the encoder's windows (files), the continuous
    step's slot rows (streams)."""
    from whisperlive_tpu_torch.models import whisper as wmod

    name = "encode" if kind == "files" else "decode_step_masked"
    orig = getattr(wmod, name)

    def half(*a, **kw):
        out = orig(*a, **kw)
        b = out.shape[0]
        if b > 1:
            out = out.clone()
            out[b // 2:] = out[: b - b // 2]
        return out

    monkeypatch.setattr(wmod, name, half)
    assert not _run(kind)["correct"]


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_token_altered_where_produced(kind, monkeypatch):
    from whisperlive_tpu_torch.engine import continuous_step
    from whisperlive_tpu_torch.ops import decoding

    def bump(tok):
        tok = tok.clone()
        tok[0] = (tok[0] + 1) % 50000
        return tok

    if kind == "stream":
        orig = continuous_step._greedy
        monkeypatch.setattr(continuous_step, "_greedy",
                            lambda f: (lambda t, lp: (bump(t), lp))(*orig(f)))
    else:
        orig = decoding.sample_next
        monkeypatch.setattr(decoding, "sample_next",
                            lambda *a: (lambda t, lp: (bump(t), lp))(*orig(*a)))
    assert not _run(kind)["correct"]


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_cross_kv_a_step_below_the_configuration(kind, monkeypatch):
    """The program's own int4 cross-KV path switched on under a
    configuration that serves int8: its gaps stay below the program's bf16
    rounding, and the cross-KV width check fails it."""
    import importlib

    mod = importlib.import_module(f"benchmark.kinds.{kind}")
    orig = mod.build_engine

    def int4(config, *a, **kw):
        return orig(dict(config, serving=dict(config["serving"], cross_kv_bits=4)), *a, **kw)

    monkeypatch.setattr(mod, "build_engine", int4)
    res = _run(kind)
    assert not res["correct"]
    assert res["checks"]["cross_kv_bits_off"]["value"] == 4
