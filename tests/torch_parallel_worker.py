"""One rank of a multi-process run of the PyTorch port, on the CPU over gloo.

    python tests/torch_parallel_worker.py <scenario> <rank> <world> <port> <dir>

The test that starts the ranks sets PYTHONPATH to the repo root in every
child's environment and writes <dir>/spec.json and <dir>/params.npz (a
JAX parameter tree carried across as numpy, "/"-joined keys); each rank
writes <dir>/out<rank>.npz or .json. Scenarios:

    tp_model     tp = 2: encode, one decode step, and window-engine decodes
                 at float and at int8 on this rank's slice
    continuous   a leader's ContinuousScheduler over the op log and its
                 followers (spec: tp, dp, pool, quantization, a draft)
    serve        tp = 2 through the op log with word timestamps
    window       tp = 2: the window route through the op log beside the
                 continuous pools (window batches at float and int8, a
                 fallback retry, no_repeat_ngram routing, word timestamps, a
                 REST file, hybrid beam beside a live session, window-path
                 speculation, the mixed pool)
    train        spec's tp x dp: train steps through init_multihost, then
                 the primary's checkpoint

This module imports nothing of the JAX package: it is the port's side.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def save_params(path: str, jax_params) -> None:
    """A JAX parameter tree (already numpy leaves) as "/"-keyed npz."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(jax_params, "")
    np.savez(path, **flat)


def run_ranks(scenario: str, world: int, d: str, spec: dict, timeout: float = 240.0) -> list:
    """Start `world` ranks of `scenario` on the CPU over gloo and wait for
    each (a timeout of its own per child); every child gets PYTHONPATH set
    to the repo root, so `whisperlive_tpu_torch` imports in a script run by
    path. -> the children's outputs."""
    spec = dict(spec, ops_port=free_port())
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH"))
                                          if p))
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(r), str(world), str(port), d],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {scenario} failed:\n{out[-6000:]}"
    return outs


def load_params(path: str) -> dict:
    from whisperlive_tpu_torch.models.bridge import from_jax_params

    flat = dict(np.load(path))
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return from_jax_params(tree)


def make_config(dims: dict):
    from whisperlive_tpu_torch.models.whisper import WhisperConfig

    return WhisperConfig(**dims)


def greedy_options(**kw):
    from whisperlive_tpu_torch.engine.engine import TranscribeOptions

    return TranscribeOptions(language="en", temperatures=(0.0,), log_prob_threshold=None,
                             no_speech_threshold=None, compression_ratio_threshold=None, **kw)


def visible_tokenizer(n_vocab: int):
    """Every text token decodes to a visible word (random weights' tokens
    otherwise decode to '' and no words are split)."""
    from whisperlive_tpu_torch.engine.tokenizer import TokenSpec, WhisperTokenizer

    class Visible:
        def encode(self, text):
            return []

        def decode(self, ids):
            return "".join(f" t{int(t)}" for t in ids)

        def id_to_piece(self, token_id):
            return f" t{int(token_id)}"

    return WhisperTokenizer(TokenSpec(n_vocab, multilingual=True), backend=Visible())


def serialize_words(result) -> list:
    return [[round(w.start, 3), round(w.end, 3), w.word, round(w.probability, 4)]
            for s in result.segments for w in (s.words or [])]


def tp_model(spec, sh, d, rank):
    import torch

    from whisperlive_tpu_torch.engine.engine import WhisperEngine
    from whisperlive_tpu_torch.models import whisper as w
    from whisperlive_tpu_torch.parallel.mesh import shard_params

    out = {}
    cfg = make_config(spec["dims"]).replace(tp=sh.tp)
    params = shard_params(load_params(os.path.join(d, "params.npz")), sh)
    inputs = np.load(os.path.join(d, "inputs.npz"))
    with torch.no_grad():
        mel = torch.from_numpy(inputs["mel"])
        enc = w.encode(params, cfg, mel)
        out["encode"] = enc.numpy()
        cross = w.compute_cross_kv(params, cfg, enc)
        kv = w.init_self_kv(cfg, 2)
        t = {k: torch.from_numpy(inputs[k]) for k in ("tok", "pos", "plen")}
        out["logits"] = w.decode_step(params, cfg, t["tok"], t["pos"], 4, t["plen"], 4, kv,
                                      cross).numpy()
    ecfg = make_config(spec["engine_dims"])
    eparams = load_params(os.path.join(d, "engine_params.npz"))
    opts = greedy_options(max_new_tokens=8)
    for mode, kw in (("float", {}), ("int8", dict(decoder_int8=True, cross_kv_bits=8))):
        kw.setdefault("decoder_int8", False)
        kw.setdefault("cross_kv_bits", 16)
        eng = WhisperEngine(ecfg, eparams, batch_buckets=(1,), device="cpu", shardings=sh,
                            compute_dtype=torch.float32, **kw)
        _, cross = eng.prepare_mel(inputs["engine_mel"])
        p, s = eng.build_prompt(opts)
        (res,) = eng.decode_batch(cross, [p], [s], opts, seed=3)
        out[f"{mode}_tokens"] = np.asarray(res.tokens, np.int64)
        out[f"{mode}_avg_logprob"] = np.float64(res.avg_logprob)
    np.savez(os.path.join(d, f"out{rank}.npz"), **out)


def continuous(spec, sh, d, rank):
    import torch

    from whisperlive_tpu_torch.engine.continuous import ContinuousScheduler
    from whisperlive_tpu_torch.engine.engine import WhisperEngine
    from whisperlive_tpu_torch.engine.scheduler import BatchRequest
    from whisperlive_tpu_torch.parallel import multihost
    from whisperlive_tpu_torch.parallel import serve_multihost as smh

    cfg = make_config(spec["dims"])
    quant = spec.get("quant", dict(decoder_int8=False, cross_kv_bits=16))
    eng = WhisperEngine(cfg, load_params(os.path.join(d, "params.npz")), device="cpu",
                        batch_buckets=(1, 2), shardings=sh, compute_dtype=torch.float32,
                        tokenizer=visible_tokenizer(cfg.n_vocab) if spec.get("words") else None,
                        **quant)
    pool = dict(spec["pool"])
    if spec.get("draft_dims"):
        # a speculative pool: the draft sliced over the same grid
        pool["draft_engine"] = WhisperEngine(
            make_config(spec["draft_dims"]), load_params(os.path.join(d, "draft_params.npz")),
            device="cpu", batch_buckets=(1,), shardings=sh, compute_dtype=torch.float32, **quant)
    if not multihost.is_primary():
        cb = smh.MultihostContinuousEngine(eng, **pool)
        chan = smh.OpFollower(("127.0.0.1", spec["ops_port"]))
        n_ops = smh.run_follower(cb, chan)
        chan.close()
        result = {"rank": rank, "ops": n_ops}
    else:
        leader = smh.OpLeader(spec["ops_port"], n_followers=sh.tp * sh.dp - 1)
        cb = smh.MultihostContinuousEngine(eng, leader=leader, **pool)
        sched = ContinuousScheduler(eng, cb=cb)
        sched.start()
        audios = [np.asarray(a, np.float32) for a in np.load(os.path.join(d, "audio.npz"))
                  .values()]
        try:
            futs = [sched.submit(BatchRequest(audio=a, options=greedy_options(
                max_new_tokens=spec["max_new"]), uid=f"r{i}")) for i, a in enumerate(audios)]
            tokens = [list(map(int, f.result(timeout=300).raw_tokens)) for f in futs]
            result = {"rank": rank, "tokens": tokens, "dp_sharded": cb.dp_sharded}
            if spec.get("words"):
                res_w = sched.submit(BatchRequest(audio=audios[0], options=greedy_options(
                    max_new_tokens=spec["max_new"], word_timestamps=True), uid="w0")
                ).result(timeout=300)
                result.update(words=serialize_words(res_w),
                              tokens_w=list(map(int, res_w.raw_tokens)))
            sched.stop()
            # one status read with the worker stopped: every data
            # replica's rows, all free
            status = cb.step()
            result.update(status_rows=int(status.shape[0]),
                          status_active=float(status[:, 0].sum()), op_log=dict(leader.stats))
        finally:
            sched.stop()
            cb.stop_followers()
    with open(os.path.join(d, f"out{rank}.json"), "w") as f:
        json.dump(result, f)


def window_audio(seconds: float, seed: int) -> np.ndarray:
    """Deterministic noise 'speech' of the window scenario (the test makes
    the same with this function)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)


def window_route(spec, sh, d, rank):
    """Every rank builds the same targets in the same order (a float and an
    int8 engine with a sliced draft, their window engines and two pools);
    rank 0 serves spec["cases"] through them and the others replay."""
    import asyncio
    import threading

    import torch

    from whisperlive_tpu_torch.engine.continuous import ContinuousScheduler
    from whisperlive_tpu_torch.engine.engine import WhisperEngine
    from whisperlive_tpu_torch.engine.scheduler import BatchRequest
    from whisperlive_tpu_torch.engine.speculative import SpeculativeDecoder
    from whisperlive_tpu_torch.parallel import multihost
    from whisperlive_tpu_torch.parallel import serve_multihost as smh
    from whisperlive_tpu_torch.serving import backends, rest
    from whisperlive_tpu_torch.serving.session import SessionOptions

    cfg = make_config(spec["dims"])
    params = load_params(os.path.join(d, "params.npz"))

    def engine(dims, tree, quant):
        kw = dict(decoder_int8=True, cross_kv_bits=8) if quant else dict(
            decoder_int8=False, cross_kv_bits=16)
        eng = WhisperEngine(make_config(dims), tree, device="cpu", batch_buckets=(1, 2),
                            shardings=sh, compute_dtype=torch.float32,
                            tokenizer=visible_tokenizer(cfg.n_vocab), **kw)
        eng.enable_beam_chunk(spec["beam_chunk"])
        return eng

    eng, eng8 = engine(spec["dims"], params, False), engine(spec["dims"], params, True)
    draft8 = engine(spec["draft_dims"], load_params(os.path.join(d, "draft_params.npz")), True)
    spec_dec = SpeculativeDecoder(eng8, draft8, k=spec["spec_k"])
    primary = multihost.is_primary()
    leader = smh.OpLeader(spec["ops_port"], n_followers=sh.tp * sh.dp - 1) if primary else None
    window = smh.MultihostWindowEngine(eng, leader=leader, name="window")
    window8 = smh.MultihostWindowEngine(eng8, leader=leader, name="window8",
                                        spec_decoder=spec_dec)

    def pool(e, name, **kw):
        import functools

        return ContinuousScheduler(e, pool_factory=functools.partial(
            smh.MultihostContinuousEngine, leader=leader, name=name), **kw)

    main = pool(eng, "main", **spec["pool"])
    spec8 = pool(eng8, "spec8", draft_engine=draft8, spec_k=spec["spec_k"],
                 **spec["spec_pool"])
    if not primary:
        chan = smh.OpFollower(("127.0.0.1", spec["ops_port"]))
        n_ops = smh.run_follower({"window": window, "window8": window8, "main": main.cb,
                                  "spec8": spec8.cb}, chan)
        chan.close()
        with open(os.path.join(d, f"out{rank}.json"), "w") as f:
            json.dump({"rank": rank, "ops": n_ops, "handles": [window.live_handles,
                                                               window8.live_handles]}, f)
        return

    backends._DISABLE_GATES = True
    backends.STREAMING_MAX_NEW_TOKENS = spec["max_new"]
    greedy = greedy_options(max_new_tokens=spec["max_new"])
    session = SessionOptions(language="en", use_vad=False)
    win = smh.MultihostBatchScheduler(window, max_batch_size=2, batch_window_ms=200)
    win8 = smh.MultihostBatchScheduler(window8, max_batch_size=2, batch_window_ms=200)
    win8s = smh.MultihostBatchScheduler(window8, max_batch_size=2,
                                        spec_decoder=window8.speculative)
    out = {"rank": rank}

    def record(res):
        return {"tokens": list(map(int, res.raw_tokens)),
                "avg_logprob": [s.avg_logprob for s in res.segments],
                "words": serialize_words(res)}

    def batch_of(sched, opts, audios, start=False):
        futs = [sched.submit(BatchRequest(audio=a, options=opts, uid=f"b{i}"))
                for i, a in enumerate(audios)]
        if start:  # queued before the worker starts, so they batch
            sched.start()
        return [record(f.result(timeout=300)) for f in futs]

    audios = [window_audio(s, 10 + i) for i, s in enumerate(spec["batch_s"])]
    try:
        # (1)-(3) window batches at float and int8, and a fallback retry
        out["batch"] = batch_of(win, greedy, audios, start=True)
        out["batch8"] = batch_of(win8, greedy, audios, start=True)
        out["fallback"] = batch_of(win, dataclasses.replace(
            greedy, temperatures=(0.0, 0.0), log_prob_threshold=-1.0), audios)
        out["words"] = batch_of(win, dataclasses.replace(greedy, word_timestamps=True),
                                audios[:1])
        for cs in (main, spec8):
            cs.start()

        class Ngram(backends.TorchBackend):
            def _adjust_options(self, topts, chunk):
                return dataclasses.replace(topts, no_repeat_ngram_size=3)

        # (4) no_repeat_ngram routes to the window scheduler
        ngram = Ngram(win, continuous_scheduler=main)
        res = asyncio.run(ngram.transcribe(audios[1], session, language="en", uid="ng"))
        out["ngram"] = dict(record(res), window=ngram._pick_scheduler(
            dataclasses.replace(greedy, no_repeat_ngram_size=3), 2.0) is win)
        # (5) a REST file: its 30 s window over the pool's cap on the window
        # scheduler, the rest on the pool
        plain = backends.TorchBackend(win, continuous_scheduler=main)
        segs, _ = asyncio.run(rest._transcribe_full(
            plain, window_audio(spec["rest_s"], 30), session, "en"))
        out["rest"] = [[s["start"], s["end"], s["tokens"]] for s in segs]
        # (6) a hybrid-beam full re-decode on the window scheduler while a
        # continuous session runs on the pool
        hybrid = backends.TorchBackend(win, continuous_scheduler=main,
                                       beam_size=spec["beam"], beam_mode="refresh")
        session_out, beam_out = [], []

        def live():
            for i, a in enumerate(audios):
                r = main.submit(BatchRequest(audio=a, options=greedy, uid=f"live{i}"))
                session_out.append(list(map(int, r.result(timeout=300).raw_tokens)))

        t = threading.Thread(target=live)
        t.start()
        beam_out.append(asyncio.run(hybrid.transcribe(audios[0], session, language="en",
                                                      uid="beam", window_anchor_s=0.0)))
        t.join(timeout=300)
        out["hybrid"] = dict(record(beam_out[0]), stats=dict(hybrid.hybrid_stats),
                             session=session_out, finished=not t.is_alive())
        # (7) a lone greedy request on the window-path SpeculativeDecoder
        win8s.start()
        out["spec"] = dict(batch_of(win8s, greedy, audios[:1])[0],
                           windows=spec_dec.stats["windows"])
        # (8) a full re-decode on the mixed mode's speculative pool
        mixed = backends.TorchBackend(win8, spec_scheduler=spec8)
        res = asyncio.run(mixed.transcribe(audios[1], session, language="en", uid="mx"))
        out["mixed"] = dict(record(res), routes=dict(mixed.spec_route_stats))
    finally:
        for sched in (win, win8, win8s, main, spec8):
            sched.stop()
        out["handles"] = [window.live_handles, window8.live_handles]
        out["op_log"] = dict(leader.stats)
        leader.stop()
    with open(os.path.join(d, f"out{rank}.json"), "w") as f:
        json.dump(out, f)


def batch(cfg, step_i: int, b: int, seed: int = 1000) -> dict:
    """The global batch of step i (the same numpy draws as the JAX job's)."""
    rng = np.random.default_rng(seed + step_i)
    t = 8
    return {
        "mel": (rng.standard_normal((b, 2 * cfg.n_audio_ctx, cfg.n_mels)) * 0.5).astype(
            np.float32),
        "tokens_in": rng.integers(0, cfg.n_vocab, (b, t)).astype(np.int32),
        "tokens_out": rng.integers(0, cfg.n_vocab, (b, t)).astype(np.int32),
        "loss_mask": np.ones((b, t), np.float32),
    }


def train(spec, sh, d, rank):
    import torch

    from whisperlive_tpu_torch import training
    from whisperlive_tpu_torch.parallel import multihost

    cfg = make_config(spec["dims"])
    opt = training.make_optimizer(learning_rate=1e-3, warmup_steps=1)
    state = training.init_train_state(cfg, opt, load_params(os.path.join(d, "params.npz")),
                                      device="cpu", shardings=sh)
    step = training.make_train_step(cfg, opt, shardings=sh)
    losses = []
    for i in range(spec["steps"]):
        # a fixed batch (spec["same_batch"]) or a new one each step
        g = batch(cfg, 0 if spec["same_batch"] else i, 8)
        local = {k: multihost.local_batch_to_global(torch.from_numpy(v), sh)
                 for k, v in g.items()}
        state, loss = step(state, local)
        losses.append(float(loss))
    multihost.save_checkpoint(os.path.join(d, "ckpt"), state, cfg, sh)
    # the last loss as every rank holds it
    fetched = multihost.fetch_replicated(torch.tensor([losses[-1]])).ravel().tolist()
    with open(os.path.join(d, f"out{rank}.json"), "w") as f:
        json.dump({"rank": rank, "losses": losses, "step": state.step, "fetched": fetched}, f)


def main() -> int:
    scenario, rank, world, port, d = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(1)
    from whisperlive_tpu_torch.parallel import multihost

    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    # one host running every rank of the world
    assert multihost.init_multihost(f"127.0.0.1:{port}", 1, 0, device="cpu",
                                    local_ranks=world, local_rank=rank)
    assert multihost.backend() == "gloo"
    sh = multihost.multihost_shardings(tp=spec["tp"], dp=spec.get("dp"))
    {"tp_model": tp_model, "continuous": continuous, "serve": continuous,
     "window": window_route, "train": train}[scenario](spec, sh, d, rank)
    multihost.barrier("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
