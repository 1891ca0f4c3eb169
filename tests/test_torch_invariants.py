"""Fixed-shape invariants of the port (tests/test_tpu_invariants.py, held
against the port): batch-bucket padding must not change an item's decode,
the largest prompt bucket bounds the prompt as the JAX engine bounds it,
and the window scheduler stays fair under load.

The padding case runs the port's engine at float and at int8
(decoder_int8=True, cross_kv_bits=8) on the reference suite's config, with
the JAX engine on the same parameters (from_jax_params) beside it: the
item's tokens alone and padded into a batch of 2 must be equal, its
avg_logprob within 1e-4, and the tokens equal to the JAX engine's. The
reference's two "no recompile" cases have no counterpart until the port
captures CUDA graphs.
"""

import functools
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_scheduler import FakeEngine
from whisperlive_tpu.engine.engine import TranscribeOptions as JOptions
from whisperlive_tpu.engine.engine import WhisperEngine as JEngine
from whisperlive_tpu.engine.scheduler import BatchRequest as JRequest
from whisperlive_tpu.engine.scheduler import BatchScheduler as JScheduler
from whisperlive_tpu.models import whisper as jw
from whisperlive_tpu_torch.engine.engine import DecodeResult
from whisperlive_tpu_torch.engine.engine import TranscribeOptions as TOptions
from whisperlive_tpu_torch.engine.engine import WhisperEngine as TEngine
from whisperlive_tpu_torch.engine.scheduler import BatchRequest as TRequest
from whisperlive_tpu_torch.engine.scheduler import BatchScheduler as TScheduler
from whisperlive_tpu_torch.models import whisper as tw
from whisperlive_tpu_torch.models.bridge import from_jax_params

torch.set_num_threads(2)

DIMS = dict(
    n_mels=80, n_vocab=51865, n_audio_ctx=100, n_audio_state=64, n_audio_head=4,
    n_audio_layer=2, n_text_ctx=64, n_text_state=64, n_text_head=4, n_text_layer=2,
)
BUCKETS = dict(batch_buckets=(1, 2, 4), prompt_buckets=(8, 16))
OPTS = dict(language="en", temperatures=(0.0,), log_prob_threshold=None,
            no_speech_threshold=None, compression_ratio_threshold=None, max_new_tokens=10)


@functools.lru_cache(maxsize=None)
def make_engines(mode):
    """(JAX engine, port engine) on the same parameters, built once per mode."""
    quant = mode == "int8"
    kw = dict(decoder_int8=quant, cross_kv_bits=8 if quant else 16, **BUCKETS)
    jcfg, tcfg = jw.WhisperConfig(**DIMS), tw.WhisperConfig(**DIMS)
    jp = jw.init_params(jcfg, 0)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    je = JEngine(jcfg, jp, compute_dtype=jnp.float32, **kw)
    te = TEngine(tcfg, tp, device="cpu", **kw)
    assert te.prompt_buckets == je.prompt_buckets == (8, 16)
    return je, te


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_batch_padding_invariance(mode):
    """An item's decode does not depend on the batch bucket it is padded
    into, and equals the JAX engine's."""
    je, te = make_engines(mode)
    rng = np.random.default_rng(0)
    t = 2 * DIMS["n_audio_ctx"]
    item = rng.standard_normal((t, 80)).astype(np.float32) * 0.1
    other = rng.standard_normal((t, 80)).astype(np.float32) * 0.1
    got = {}
    for eng, options in ((je, JOptions), (te, TOptions)):
        opts = options(**OPTS)
        p, s = eng.build_prompt(opts)
        _, cross1 = eng.prepare_mel(np.stack([item]))
        (alone,) = eng.decode_batch(cross1, [p], [s], opts)
        _, cross2 = eng.prepare_mel(np.stack([item, other]))
        padded = eng.decode_batch(cross2, [p, p], [s, s], opts)[0]
        np.testing.assert_array_equal(alone.tokens, padded.tokens)
        assert alone.avg_logprob == pytest.approx(padded.avg_logprob, abs=1e-4)
        got[eng is te] = list(alone.tokens)
    assert got[True] == got[False]
    assert len(got[True]) > 0


def test_prompt_trimmed_to_the_largest_bucket_as_jax():
    """prompt_buckets=(8, 16): previous text past the 16-token bucket is
    trimmed from its start, the sot sequence kept, as the JAX engine does."""
    je, te = make_engines("float")
    prev = list(range(300, 340))
    want = je.build_prompt(JOptions(**OPTS), previous_tokens=prev)
    prompt, sot = te.build_prompt(TOptions(**OPTS), previous_tokens=prev)
    assert (prompt, sot) == (list(want[0]), want[1])
    assert len(prompt) == 16 and prompt[1:sot] == prev[-(sot - 1):]
    assert prompt[sot] == te.tokenizer.sot
    # the default buckets keep the JAX filter: none above n_text_ctx
    assert TEngine(tw.WhisperConfig(**DIMS), te.params, device="cpu",
                   decoder_int8=False).prompt_buckets == (16, 64)


class PortFakeEngine(FakeEngine):
    """The reference suite's engine double, giving the port's results."""

    def _result(self):
        return DecodeResult(tokens=np.array([50364, 100, 101, 50374], np.int32),
                            avg_logprob=-0.2, no_speech_prob=0.01, compression_ratio=1.0,
                            temperature=0.0)


def _under_load(scheduler_cls, request_cls, options_cls, engine):
    """25 threads submit one request each; every future must finish within
    20 s. Returns (uid, language, segment texts and times) per request."""
    sched = scheduler_cls(engine, max_batch_size=4, batch_window_ms=10)
    sched.start()
    try:
        reqs = [request_cls(audio=np.zeros(16000, np.float32),
                            options=options_cls(language="en"), uid=f"u{i}") for i in range(25)]
        threads = [threading.Thread(target=sched.submit, args=(r,)) for r in reqs]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        out = []
        for r in reqs:
            res = r.future.result(timeout=20)  # nobody starves
            out.append((r.uid, res.language,
                        [(s.text, s.start, s.end) for s in res.segments]))
        return out, engine.decode_calls
    finally:
        sched.stop()


def test_scheduler_fairness_under_load():
    """Every one of 25 concurrent requests completes, batches never exceed
    max_batch_size, and each result equals the JAX scheduler's."""
    got, calls = _under_load(TScheduler, TRequest, TOptions, PortFakeEngine())
    want, _ = _under_load(JScheduler, JRequest, JOptions, FakeEngine())
    assert got == want
    assert sum(calls) == 25 and max(calls) <= 4
