"""Prompt construction (get_prompt, transcriber_faster_whisper.py:1480-1513)
in the port, held against the JAX engine's build_prompt.

The cases of tests/test_prompt.py, each run on the port's engine and on the
JAX engine built from the same config: both must give the same prompt
tokens and the same sot index, and the port's prompt must have the shape
the reference case asserts. The last case holds decode_with_fallback's
choice when every temperature fails the gates.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisperlive_tpu.engine.engine import DecodeResult as JResult
from whisperlive_tpu.engine.engine import TranscribeOptions as JOptions
from whisperlive_tpu.engine.engine import WhisperEngine as JEngine
from whisperlive_tpu.models import whisper as jw
from whisperlive_tpu_torch.engine.engine import DecodeResult as TResult
from whisperlive_tpu_torch.engine.engine import TranscribeOptions as TOptions
from whisperlive_tpu_torch.engine.engine import WhisperEngine as TEngine
from whisperlive_tpu_torch.models import whisper as tw

torch.set_num_threads(2)

DIMS = dict(
    n_mels=80, n_vocab=51865, n_audio_ctx=32, n_audio_state=64, n_audio_head=4,
    n_audio_layer=1, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=1,
)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) of the reference suite's config."""
    jcfg, tcfg = jw.WhisperConfig(**DIMS), tw.WhisperConfig(**DIMS)
    je = JEngine(jcfg, jw.init_params(jcfg), compute_dtype=jnp.float32)
    te = TEngine(tcfg, tw.init_params(tcfg, 0, device="cpu"), device="cpu")
    return je, te


def both(engines, previous_tokens=(), context_preseeded=False, **opts):
    """build_prompt on both engines with the same options; they must agree.
    Returns the port's (prompt, sot_index) and its tokenizer."""
    je, te = engines
    kw = dict(previous_tokens=list(previous_tokens), context_preseeded=context_preseeded)
    want = je.build_prompt(JOptions(**opts), **kw)
    got = te.build_prompt(TOptions(**opts), **kw)
    assert got == (list(want[0]), want[1])
    return got[0], got[1], te.tokenizer


def test_basic_sot_sequence(engines):
    prompt, sot_idx, tok = both(engines, language="en")
    assert prompt == [tok.sot, tok.spec.language_token("en"), tok.spec.transcribe]
    assert sot_idx == 0


def test_translate_task(engines):
    prompt, _, tok = both(engines, language="de", task="translate")
    assert prompt[2] == tok.spec.translate


def test_without_timestamps_appends_notimestamps(engines):
    prompt, _, tok = both(engines, language="en", without_timestamps=True)
    assert prompt[-1] == tok.no_timestamps


def test_initial_prompt_prefixed_with_sot_prev(engines):
    prompt, sot_idx, tok = both(engines, language="en", initial_prompt="hello")
    assert prompt[0] == tok.sot_prev
    assert prompt[1:1 + len(tok.encode(" hello"))] == tok.encode(" hello")
    assert prompt[sot_idx] == tok.sot


def test_initial_prompt_serving_vs_preseeded(engines):
    opts = dict(language="en", initial_prompt="hello")
    # serving: initial_prompt rides every window ahead of the session context
    prompt, _, tok = both(engines, previous_tokens=[500, 501], **opts)
    hello = tok.encode(" hello")
    assert prompt[0] == tok.sot_prev
    assert prompt[1:1 + len(hello)] == hello
    assert 500 in prompt and 501 in prompt
    # the offline seek loop seeds initial_prompt itself: not re-added, and
    # previous tokens ride ungated
    prompt2, _, _ = both(engines, previous_tokens=[500, 501], context_preseeded=True, **opts)
    assert prompt2[0] == tok.sot_prev
    assert prompt2[1:3] == [500, 501]
    assert prompt2[1:1 + len(hello)] != hello
    # a preseeded context ignores condition_on_previous_text
    prompt3, _, _ = both(engines, previous_tokens=[7, 8], context_preseeded=True,
                         language="en", condition_on_previous_text=False)
    assert prompt3[1:3] == [7, 8]


def test_hotwords_used_when_no_prefix(engines):
    prompt, _, tok = both(engines, language="en", hotwords="JAX TPU")
    assert prompt[0] == tok.sot_prev
    assert prompt[1:1 + len(tok.encode(" JAX TPU"))] == tok.encode(" JAX TPU")


def test_hotwords_dropped_with_a_prefix(engines):
    prompt, sot_idx, tok = both(engines, language="en", hotwords="JAX TPU", prefix="so far")
    assert sot_idx == 0 and tok.sot_prev not in prompt


def test_prefix_appended_after_sot_sequence(engines):
    prompt, sot_idx, tok = both(engines, language="en", prefix="so far")
    assert prompt[sot_idx + 3:] == tok.encode(" so far")


def test_condition_on_previous_disabled(engines):
    _, sot_idx, _ = both(engines, previous_tokens=[7, 8, 9], language="en",
                         condition_on_previous_text=False)
    assert sot_idx == 0  # no sot_prev block at all


def test_previous_tokens_truncated_to_half_ctx(engines):
    prev = list(range(600, 1000))
    prompt, sot_idx, _ = both(engines, previous_tokens=prev, language="en")
    # at most n_text_ctx // 2 - 1 = 223 previous tokens survive
    assert sot_idx <= 224
    assert prompt[1:sot_idx] == prev[-(sot_idx - 1):]


def test_prompt_fits_largest_bucket_trims_prev_first(engines):
    """Previous tokens and a prefix past half the context: the prompt fits
    the largest prompt bucket, the sot sequence and the prefix's tail
    intact (the previous text is trimmed first)."""
    prefix = " ".join(["word"] * 300)
    prompt, sot_idx, tok = both(engines, previous_tokens=list(range(300, 524)),
                                language="en", prefix=prefix)
    te = engines[1]
    assert len(prompt) <= te.prompt_buckets[-1]
    assert prompt[sot_idx] == tok.sot
    assert prompt[sot_idx + 1] == tok.spec.language_token("en")
    prefix_tokens = tok.encode(" " + prefix)[-(te.cfg.n_text_ctx // 2 - 1):]
    assert prompt[-len(prefix_tokens):] == prefix_tokens


def test_all_temperatures_fail_keeps_best_attempt(engines):
    """When every temperature fails the gates, both engines return the best
    attempt (highest avg_logprob among those under the compression-ratio
    limit), stamped with the final temperature
    (transcriber_faster_whisper.py:1464-1477)."""
    attempts = [  # (tokens, avg_logprob, compression_ratio, temperature)
        ([1, 2], -0.5, 9.0, 0.0),  # best logprob, compression ratio too high
        ([3, 4], -1.4, 1.0, 0.5),  # the winner
        ([5, 6], -3.0, 1.0, 1.0),
    ]
    out = []
    for eng, result, options in ((engines[0], JResult, JOptions),
                                 (engines[1], TResult, TOptions)):
        queue = iter([[result(np.array(t), lp, 0.0, cr, temp)] for t, lp, cr, temp in attempts])
        eng.decode_batch = lambda *a, queue=queue, **k: next(queue)
        try:
            opts = options(language="en", temperatures=(0.0, 0.5, 1.0), log_prob_threshold=-1.0,
                           compression_ratio_threshold=2.4, no_speech_threshold=None)
            (res,) = eng.decode_with_fallback(None, [[1]], [0], opts)
        finally:
            del eng.decode_batch
        out.append((list(res.tokens), res.avg_logprob, res.temperature))
    assert out[1] == out[0] == ([3, 4], -1.4, 1.0)
