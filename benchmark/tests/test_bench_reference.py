"""The plain reference against the port, on the CPU: the token layout and
suppress set, the log-mel front end, the greedy rules, and whole runs of
both traffic kinds at a tiny width judged correct. The test imports both;
the reference imports nothing of the port."""

import numpy as np
import pytest
import torch

from benchmark import generator, harness
from benchmark import reference as ref

from .conftest import CELLS, TINY, WIDE


def test_tokens_and_suppress_set_match_the_port():
    from whisperlive_tpu_torch.engine.tokenizer import get_suppressed_tokens

    for n_vocab in (51865, 51866):
        tok = ref.Tokens(n_vocab)
        port = harness.visible_tokenizer(n_vocab)
        spec = port.spec
        assert (tok.sot, tok.eot, tok.no_speech, tok.no_timestamps, tok.ts_begin) == (
            spec.sot, spec.eot, spec.no_speech, spec.no_timestamps, spec.timestamp_begin)
        assert tok.languages == [spec.language_token(c) for c in spec.language_codes]
        assert tok.blank == port.encode(" ")[0]
        assert tok.suppress == get_suppressed_tokens(port, (-1,))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_the_port(n_mels):
    from whisperlive_tpu_torch.ops import mel

    mix = generator.load_mix("stream20")
    x = np.zeros((2, 163840), np.float32)
    x[0, :70000] = generator.speech_like(np.random.default_rng(1), 70000, mix["signal"])
    x[1] = generator.speech_like(np.random.default_rng(2), 163840, mix["signal"])
    a = ref.log_mel(torch.from_numpy(x), n_mels)
    b = mel.log_mel_spectrogram(torch.from_numpy(x), n_mels=n_mels)
    assert a.shape == b.shape == (2, 1024, n_mels)
    assert torch.allclose(a, b, atol=2e-4)


def _port_greedy(logits, history, tok, timestamps):
    from whisperlive_tpu_torch.ops import ring_rules
    from whisperlive_tpu_torch.ops.decoding import DecodingSpec, build_suppress_mask

    spec = DecodingSpec(n_vocab=tok.n_vocab, eot=tok.eot, blank=tok.blank,
                        no_speech=tok.no_speech, timestamp_begin=tok.ts_begin)
    tb = tok.ts_begin
    h = list(history)
    stamps = [t for t in h if t >= tb]
    row = lambda v, dt=torch.bool: torch.tensor([v], dtype=dt)  # noqa: E731
    out = ring_rules.apply_logit_rules_tracked(
        spec, logits[None].float(), build_suppress_mask(tok.n_vocab, tok.suppress),
        row(timestamps), row(len(h) == 0), row(len(h) >= 1 and h[-1] >= tb),
        row(len(h) < 2 or h[-2] >= tb), row(stamps[-1] if stamps else tb - 1, torch.int32))
    return int(out.argmax())


@pytest.mark.parametrize("timestamps", [True, False])
def test_greedy_rules_match_the_port(timestamps):
    tok = ref.Tokens(51866)
    tb = tok.ts_begin
    rng = np.random.default_rng(5)
    histories = [[], [tb], [tb, 500], [tb, 500, tb + 30], [tb, 500, tb + 30, tb + 30],
                 [700, 800], [tb + 1400, 3], [tb + 1490, 9, tb + 1495]]
    if not timestamps:
        histories = [[], [700], [700, 9]]
    for h in histories:
        for scale in (0.7, 3.0):
            logits = torch.from_numpy(rng.standard_normal(tok.n_vocab).astype(np.float32) * scale)
            # a timestamp block that sometimes wins on mass, sometimes not
            logits[tb:] -= float(rng.uniform(0, 8))
            port = _port_greedy(logits, h, tok, timestamps)
            assert ref.greedy_choice(logits, h, tok, timestamps) == port, (h, scale)
            assert ref.token_gaps(logits[None], h, [port], tok, timestamps) == [0.0]


@pytest.mark.parametrize("width", ["tiny", "wide"])
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_a_small_run_is_judged_correct(kind, width):
    cell, over, seconds = CELLS[kind]
    config = dict(TINY if width == "tiny" else WIDE)
    res = harness.run_cell(cell, 2 ** 33 + 11, seconds, False, device="cpu", config=config,
                           mix_override=over)
    checks = res["checks"]
    assert res["correct"], checks
    assert checks["widest_gap"]["value"] < 0.05
    assert checks["tokens_compared"]["value"] >= 100
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    assert "setup_s" in res["metrics"]
