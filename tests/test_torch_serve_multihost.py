"""Multi-process serving of the port through its op log, against the JAX
package.

The leader (rank 0) runs a live ContinuousScheduler over a
MultihostContinuousEngine; the follower (rank 1) replays its op log on an
identically built engine; the two hold the heads of one tp = 2 engine
(tests/torch_parallel_worker.py, gloo on the CPU, PYTHONPATH set for each
child). The bar is tests/test_serve_multihost.py's, held against the JAX
package's single-process scheduler on the same init_params weights (model
and pool of tests/serve_multihost_worker.py: width 64, 4 heads, 2 + 2
layers, 1500 encoder positions, 4 slots): tokens exact, word boundaries
within one alignment frame (0.02 s), probabilities within 0.01 (the
sharded attention sums in another order, so the DTW input is equal only to
float rounding). The op channel's HMAC handshake is held to the
reference's two tests, and continuous-only coercion to the JAX backend's.
"""

import dataclasses
import json
import socket
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import serve_multihost_worker as smw
import torch_parallel_worker as tpw
from whisperlive_tpu.engine.continuous import ContinuousScheduler as JScheduler
from whisperlive_tpu.engine.engine import TranscribeOptions as JOptions
from whisperlive_tpu.engine.engine import WhisperEngine as JEngine
from whisperlive_tpu.engine.scheduler import BatchRequest as JRequest
from whisperlive_tpu.models.whisper import init_params as j_init_params
from whisperlive_tpu.serving import backends as jbackends
from whisperlive_tpu_torch.engine.engine import TranscribeOptions as TOptions
from whisperlive_tpu_torch.parallel import serve_multihost as smh
from whisperlive_tpu_torch.serving import backends as tbackends

DIMS = dict(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)
MAX_NEW = 20


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    """The two-process serving job, once; -> (leader's, follower's) output."""
    d = tmp_path_factory.mktemp("serve")
    cfg = smw.serving_config()
    assert dataclasses.asdict(cfg)["n_text_state"] == DIMS["n_text_state"]
    tpw.save_params(d / "params.npz", jax.tree.map(np.asarray, j_init_params(cfg, 0)))
    np.savez(d / "audio.npz", *smw.request_audio())
    spec = dict(tp=2, dp=1, dims=DIMS, max_new=MAX_NEW, pool=smw.POOL, words=True)
    tpw.run_ranks("serve", 2, str(d), spec)
    return [json.loads((d / f"out{r}.json").read_text()) for r in range(2)]


@pytest.fixture(scope="module")
def reference_decode():
    """The same windows through the JAX package's single-process scheduler
    (the reference test's own oracle)."""
    cfg = smw.serving_config()
    eng = JEngine(cfg, j_init_params(cfg, 0), compute_dtype=jnp.float32,
                  batch_buckets=(1, 2), tokenizer=smw.visible_tokenizer(cfg))
    sched = JScheduler(eng, **smw.POOL)
    sched.start()
    try:
        tokens = [list(map(int, sched.submit(JRequest(
            audio=a, options=smw.serving_options(), uid=f"r{i}")).result(timeout=300).raw_tokens))
            for i, a in enumerate(smw.request_audio())]
        res_w = sched.submit(JRequest(audio=smw.request_audio()[0],
                                      options=smw.serving_options(word_timestamps=True),
                                      uid="rw")).result(timeout=300)
        return tokens, smw.serialize_words(res_w), list(map(int, res_w.raw_tokens))
    finally:
        sched.stop()


def test_op_log_serving_token_parity(serve_run, reference_decode):
    """tp = 2 over two processes decodes exactly what one JAX process does."""
    assert serve_run[0]["tokens"] == reference_decode[0]
    assert any(serve_run[0]["tokens"])


def test_op_log_word_timestamps_parity(serve_run, reference_decode):
    _, ref_words, ref_tokens_w = reference_decode
    assert serve_run[0]["tokens_w"] == ref_tokens_w
    live = serve_run[0]["words"]
    assert ref_words, "reference produced no words: the test proves nothing"
    assert len(live) == len(ref_words)
    for (ls, le, lw, lp), (rs, re_, rw, rp) in zip(live, ref_words):
        assert lw == rw
        assert abs(ls - rs) <= 0.021 and abs(le - re_) <= 0.021
        assert abs(lp - rp) <= 0.01


def test_follower_replayed_full_stream(serve_run):
    """The follower consumed the whole stream the leader published: init,
    inserts, steps, releases, the alignment pass and the closing read."""
    lead, follower = serve_run
    assert follower["ops"] >= 8
    assert lead["op_log"]["ops"] == follower["ops"] + 1  # and the hello
    assert lead["op_log"]["bytes"] > 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_op_channel_auth_accepts_shared_secret():
    """Mutual HMAC handshake: an unauthenticated probe is rejected without
    taking the follower slot, the real follower (same secret)
    authenticates, and frames flow only after auth."""
    port = _free_port()
    leader_box = {}

    def lead():
        leader_box["leader"] = smh.OpLeader(port, n_followers=1, secret=b"podkey",
                                            accept_timeout_s=20.0)

    t = threading.Thread(target=lead)
    t.start()
    deadline = time.monotonic() + 10
    while True:
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=5)
            break
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.05)
    with s:
        s.sendall(b"\x00" * 32)
        assert s.recv(64) == b""  # the leader closes on a bad digest
    chan = smh.OpFollower(("127.0.0.1", port), secret=b"podkey")
    t.join(timeout=10)
    assert not t.is_alive()
    leader = leader_box["leader"]
    leader.publish("ping", {"x": 1})
    assert chan.next() == ("ping", {"x": 1})
    chan.close()
    leader.close()


def test_op_channel_rejects_wrong_secret():
    """A follower with the wrong key never completes the handshake (and
    never unpickles a byte): the leader times out with no follower, the
    follower errors out."""
    port = _free_port()
    errs = {}

    def lead():
        try:
            smh.OpLeader(port, n_followers=1, secret=b"right", accept_timeout_s=2.5)
        except Exception as e:
            errs["leader"] = e

    t = threading.Thread(target=lead)
    t.start()
    with pytest.raises((OSError, ConnectionError)):
        smh.OpFollower(("127.0.0.1", port), secret=b"wrong", connect_timeout_s=2.0)
    t.join(timeout=10)
    assert isinstance(errs.get("leader"), TimeoutError)


class _Pool:
    suppress_key = ((-1,), True)
    beam_width = 1
    max_window_s = 12.8


@pytest.mark.parametrize("kw", [
    dict(no_repeat_ngram_size=3),
    dict(suppress_tokens=(5, 6), suppress_blank=False),
    dict(max_initial_timestamp=2.0),
    dict(beam_size=5),
    dict(),
])
def test_continuous_only_coerces_like_the_reference(kw, caplog):
    """continuous_only serving replaces what the continuous step cannot
    honour and clamps over-cap windows, option for option as the JAX
    backend does, warning once a uid."""
    chunk = np.zeros(int(16000 * 15.0), np.float32)
    tb = tbackends.TorchBackend.__new__(tbackends.TorchBackend)
    jb = jbackends.TpuBackend.__new__(jbackends.TpuBackend)
    for b in (tb, jb):
        b.continuous_scheduler = _Pool()
        b._coerce_warned = set()
    t_opts, t_chunk = tb._coerce_to_continuous(TOptions(**kw), chunk, "u")
    j_opts, j_chunk = jb._coerce_to_continuous(JOptions(**kw), chunk, "u")
    assert dataclasses.asdict(t_opts) == dataclasses.asdict(j_opts)
    assert len(t_chunk) == len(j_chunk) == int(12.8 * 16000)
    tb._coerce_to_continuous(TOptions(**kw), chunk, "u")
    assert sum("coerced" in r.message for r in caplog.records) == 2  # one per backend


class _Chan:
    """A follower channel that hands out recorded frames."""

    def __init__(self, frames):
        self._frames = iter(frames)

    def next(self):
        return next(self._frames)


class _Target:
    def __init__(self, sig):
        self.sig, self.ops = sig, []

    def signature(self):
        return dict(self.sig)

    def replay(self, op, payload):
        self.ops.append((op, payload))


def _narrow_engine(seed_params):
    from whisperlive_tpu_torch.engine.engine import WhisperEngine
    from whisperlive_tpu_torch.models import whisper as tw
    from whisperlive_tpu_torch.parallel.mesh import EngineShardings

    cfg = tw.WhisperConfig(**DIMS)
    return WhisperEngine(cfg, seed_params(cfg), batch_buckets=(1, 2), device="cpu",
                         decoder_int8=False, cross_kv_bits=16,
                         shardings=EngineShardings(tp=1, dp=1))


def test_window_handles_are_named_replayed_and_freed():
    """A window op's device results stay on both sides under the op's id
    (the payload names them, the frame carries no tensor), later ops take
    them back, and free_handles empties the leader's and the follower's
    tables; the follower replays every op the leader published, and the
    engine's unpublished device calls are refused on the window engine."""
    from whisperlive_tpu_torch.models import whisper as tw

    params = tw.init_params(tw.WhisperConfig(**DIMS), 0, device="cpu")
    leader_eng = _narrow_engine(lambda cfg: params)
    follower_eng = _narrow_engine(lambda cfg: params)
    port = _free_port()
    box = {}
    t = threading.Thread(target=lambda: box.update(leader=smh.OpLeader(
        port, n_followers=1, secret=b"k", accept_timeout_s=20.0)))
    t.start()
    chan = smh.OpFollower(("127.0.0.1", port), secret=b"k")
    t.join(timeout=20)
    leader = box["leader"]
    follower = smh.MultihostWindowEngine(follower_eng)
    replay = {}
    rt = threading.Thread(target=lambda: replay.update(n=smh.run_follower(
        {"window": follower}, chan)))
    rt.start()
    window = smh.MultihostWindowEngine(leader_eng, leader=leader)
    opts = TOptions(language="en", temperatures=(0.0,), log_prob_threshold=None,
                    no_speech_threshold=None, compression_ratio_threshold=None,
                    max_new_tokens=4)
    audio = np.random.default_rng(3).standard_normal((2, 480000)).astype(np.float32) * 0.1
    enc, cross = window.prepare(audio)
    assert isinstance(enc, smh.Handle) and isinstance(cross, smh.Handle)
    sub = window.gather_cross(cross, [1, 1])
    p, s = window.build_prompt(opts)
    (res,) = window.decode_with_fallback(sub, [p], [s], opts)
    (ref,) = leader_eng.decode_with_fallback(leader_eng.prepare(audio[1:])[1], [p], [s], opts)
    assert list(res.tokens) == list(ref.tokens)
    assert window.live_handles == 3
    with pytest.raises(AttributeError, match="not on the op log"):
        window.decode_batch  # device work on this rank alone: refused
    window.free_handles()
    assert window.live_handles == 0
    leader.stop()
    rt.join(timeout=60)
    chan.close()
    assert replay["n"] == 4 and leader.stats["ops"] == 6  # and the hello and the stop
    assert follower.live_handles == 0


def test_follower_refuses_an_unknown_target_op_or_handle():
    """A frame for a target the follower lacks, or naming a handle it never
    made, is a protocol fault: run_follower raises instead of replaying a
    desynced stream (an op that fails inside the engine is survived)."""
    from types import SimpleNamespace

    main = _Target({"n_slots": 4})
    window = smh.MultihostWindowEngine(SimpleNamespace(
        shardings=object(), gather_cross=lambda cross, idx: cross,
        signature=None), name="window")
    window.signature = lambda: {"tp": 2}
    hello = ("hello", {"main": {"n_slots": 4}, "window": {"tp": 2}})
    with pytest.raises(smh.ReplayError, match="unknown target 'spec'"):
        smh.run_follower({"main": main, "window": window},
                         _Chan([hello, ("main.step", None), ("spec.step", None)]))
    assert main.ops == [("step", None)]
    with pytest.raises(smh.ReplayError, match="unknown handle"):
        smh.run_follower({"main": main, "window": window}, _Chan(
            [hello, ("window.gather_cross", (0, (smh.Handle((7, 0)), [0]), {}))]))
    with pytest.raises(smh.ReplayError, match="unknown window op"):
        smh.run_follower({"main": main, "window": window},
                         _Chan([hello, ("window.forward", (1, (), {}))]))


def test_hello_reports_a_second_pools_mismatch():
    """The handshake holds every target's signature: a speculative pool
    built otherwise than the leader's is named in the error."""
    targets = {"main": _Target({"n_slots": 4, "ring": 128}),
               "spec": _Target({"n_slots": 8, "spec_k": 4})}
    hello = ("hello", {"main": {"n_slots": 4, "ring": 128}, "spec": {"n_slots": 8, "spec_k": 3}})
    with pytest.raises(RuntimeError, match=r"'spec': \{'spec_k': \(3, 4\)\}"):
        smh.run_follower(targets, _Chan([hello]))
    with pytest.raises(RuntimeError, match="'spec': 'missing on the leader'"):
        smh.run_follower(targets, _Chan([("hello", {"main": {"n_slots": 4, "ring": 128}})]))
    assert smh.run_follower(targets, _Chan([("hello", {"main": {"n_slots": 4, "ring": 128},
                                                       "spec": {"n_slots": 8, "spec_k": 4}}),
                                            ("spec.step", None), ("stop", None)])) == 1
