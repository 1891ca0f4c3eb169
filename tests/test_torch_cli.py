"""The port's server CLI passes the reference's serving flags on to the server.

`--api_key` (default: the WL_API_KEY environment variable), `--metrics_port`
and `--raw_pcm_input` are parsed as in whisperlive_tpu/cli/run_server.py and
reach TranscriptionServer: the key and the metrics port as arguments of
`run`, the PCM format as the server's `raw_pcm_default`. `--profile_dir`
(default: WL_PROFILE_DIR) starts the profiler and the shutdown path stops
it, and the parser holds every flag of the reference's. The backend and the
server's loop are replaced, so no model is built and no socket is opened.
The reference's WhisperLive parity flags are accepted with its defaults,
`--omp_num_threads` sets OMP_NUM_THREADS and torch's thread count (the
fixture restores it), `--compute_dtype` reaches the
engine, and `--beam_size` / `--beam_mode` size the continuous pool as the
reference does (the last two build a tiny CPU model). `--enable_rest`,
`--rest_port`, `--cors_origins`, `--rate_limit_rpm` and `--fake_transcriber`
parse with the reference's defaults and help, and reach the server as
`rest_port` and `rest_kwargs`, or as FakeBackend named "fake". `--tp`,
`--dp`, `--multihost_ops_port` and `--multihost_ops_host` parse with the
reference's defaults and help; a world across hosts refuses what the
reference's multi-host mode refuses, one host's world serves the same flags
and starts its ranks, and two such servers (tp = 2 on the CPU, a tiny
random model, the follower a spawned process) decode requests through the
op log on the continuous pool, the window scheduler and the window-path
SpeculativeDecoder.
"""

import os

import pytest
import torch

from whisperlive_tpu.cli import run_server as jrun_server

from whisperlive_tpu_torch.cli import run_server
from whisperlive_tpu_torch.serving.server import TranscriptionServer


@pytest.fixture
def served(monkeypatch):
    seen = {}

    def fake_run(self, backend, **kw):
        seen.update(kw, backend=backend, raw_pcm_default=self.raw_pcm_default)

    monkeypatch.setattr(TranscriptionServer, "run", fake_run)
    monkeypatch.setattr(run_server, "create_backend",
                        lambda args: seen.update(args=args) or "backend")
    monkeypatch.setenv("OMP_NUM_THREADS", "8")
    monkeypatch.setattr(run_server, "stop_backend", lambda backend: seen.update(stopped=backend))
    monkeypatch.setattr(run_server.profiling, "start_profiler",
                        lambda log_dir, device=None: seen.update(profile_dir=log_dir) or True)
    monkeypatch.setattr(run_server.profiling, "stop_profiler",
                        lambda: seen.update(profile_stopped=True))
    threads = torch.get_num_threads()
    yield seen
    torch.set_num_threads(threads)


def test_api_key_from_env_metrics_port_and_pcm_reach_the_server(monkeypatch, served):
    monkeypatch.setenv("WL_API_KEY", "s3cret")
    run_server.main(["--metrics_port", "9464", "--raw_pcm_input", "int16"])
    assert served["api_key"] == "s3cret"
    assert served["metrics_port"] == 9464
    assert served["raw_pcm_default"] == "int16"
    assert served["backend"] == "backend" and served["stopped"] == "backend"


def test_flags_default_as_the_reference(monkeypatch, served):
    monkeypatch.delenv("WL_API_KEY", raising=False)
    run_server.main([])
    assert served["api_key"] is None and served["metrics_port"] is None
    assert served["raw_pcm_default"] == "float32"


def test_api_key_flag_overrides_env(monkeypatch, served):
    monkeypatch.setenv("WL_API_KEY", "from-env")
    run_server.main(["--api_key", "from-flag"])
    assert served["api_key"] == "from-flag"


PARITY = ["--backend", "faster_whisper", "-fw", "/ckpt", "-trt", "/trt", "--trt_multilingual",
          "--trt_py_session", "--no_single_model", "--batch_inference", "-omp", "3",
          "--compute_dtype", "float32", "--compilation_cache", "/cache", "--profile_dir", "/prof"]


def test_reference_parity_flags_are_accepted(served):
    """A WhisperLive / reference command line starts the port's server."""
    run_server.main(PARITY)
    args = served["args"]
    assert args.backend == "faster_whisper" and args.faster_whisper_custom_model_path == "/ckpt"
    assert args.trt_model_path == "/trt" and args.trt_multilingual and args.trt_py_session
    assert args.no_single_model and args.batch_inference
    assert args.compute_dtype == "float32" and args.compilation_cache == "/cache"
    assert os.environ["OMP_NUM_THREADS"] == "3"
    assert served["stopped"] == "backend"
    # --profile_dir starts the profiler, and the shutdown path writes it
    assert args.profile_dir == "/prof" and served["profile_dir"] == "/prof"
    assert served["profile_stopped"]
    # the reference's parser takes the same command line to the same values
    ref = jrun_server.build_parser().parse_args(PARITY)
    for name in ("backend", "faster_whisper_custom_model_path", "trt_model_path",
                 "trt_multilingual", "trt_py_session", "omp_num_threads", "no_single_model",
                 "batch_inference", "compute_dtype", "compilation_cache", "profile_dir"):
        assert getattr(args, name) == getattr(ref, name), name


def test_profile_dir_defaults_to_the_environment_as_the_reference(monkeypatch, served):
    """F5: the port's parser holds every flag of the reference's, and
    --profile_dir defaults to WL_PROFILE_DIR (read when the parser is
    built, as the reference reads it)."""
    ours = {o for a in run_server.build_parser()._actions for o in a.option_strings}
    ref = {o for a in jrun_server.build_parser()._actions for o in a.option_strings}
    assert ref <= ours, sorted(ref - ours)
    monkeypatch.delenv("WL_PROFILE_DIR", raising=False)
    assert run_server.build_parser().parse_args([]).profile_dir is None
    run_server.main([])
    assert "profile_dir" not in served and served["profile_stopped"]
    monkeypatch.setenv("WL_PROFILE_DIR", "/from/env")
    for parser in (run_server.build_parser(), jrun_server.build_parser()):
        assert parser.parse_args([]).profile_dir == "/from/env"
        assert parser.parse_args(["--profile_dir", "/tmp/p"]).profile_dir == "/tmp/p"
    run_server.main([])
    assert served["profile_dir"] == "/from/env"


def test_omp_num_threads_sets_torch_threads(served):
    """torch is imported before main() parses the flag, so the variable
    alone would reach no thread pool of this process."""
    run_server.main(["--omp_num_threads", "3"])
    assert os.environ["OMP_NUM_THREADS"] == "3" and torch.get_num_threads() == 3
    run_server.main([])
    assert torch.get_num_threads() == 1


def test_parity_flags_default_as_the_reference(served):
    run_server.main([])
    args, ref = served["args"], jrun_server.build_parser().parse_args([])
    for name in ("backend", "faster_whisper_custom_model_path", "trt_model_path",
                 "trt_multilingual", "trt_py_session", "omp_num_threads", "no_single_model",
                 "batch_inference", "compute_dtype", "compilation_cache", "beam_size",
                 "beam_mode"):
        assert getattr(args, name) == getattr(ref, name), name
    assert os.environ["OMP_NUM_THREADS"] == "1"
    helps = {a.dest: a.help for a in run_server.build_parser()._actions}
    assert "does nothing" in helps["compilation_cache"]


@pytest.mark.parametrize("flag,dtype", [(None, torch.float32), ("float32", torch.float32),
                                        ("bfloat16", torch.bfloat16)])
def test_compute_dtype_reaches_the_engine(flag, dtype):
    argv = ["--model", "tiny", "--device", "cpu", "--no_warmup", "--no_continuous_batching"]
    if flag:
        argv += ["--compute_dtype", flag]
    backend = run_server.create_backend(run_server.build_parser().parse_args(argv))
    try:
        eng = backend.scheduler.engine
        assert eng.cfg.dtype == dtype
        assert eng.params["encoder"]["conv1"]["w"].dtype == dtype
    finally:
        run_server.stop_backend(backend)


@pytest.mark.parametrize("mode,slots,lanes,hybrid", [("full", 5, 3, False),
                                                     ("refresh", 16, 1, True)])
def test_beam_flags_size_the_continuous_pool(monkeypatch, mode, slots, lanes, hybrid):
    """--beam_size 3: 'full' gives max(2, 16 // 3) slots of 3 lanes, 'refresh'
    a greedy pool of all 16 slots and preemptible beamed window decodes."""
    monkeypatch.delenv("WL_BEAM_CHUNK", raising=False)
    args = run_server.build_parser().parse_args(
        ["--model", "tiny", "--device", "cpu", "--no_warmup", "--beam_size", "3",
         "--beam_mode", mode])
    assert run_server.continuous_pool_size(args) == (slots, lanes)
    backend = run_server.create_backend(args)
    try:
        cb = backend.continuous_scheduler.cb
        assert (cb.n_slots, cb.beam_width, cb.n_rows) == (slots, lanes, slots * lanes)
        assert backend.beam_size == 3 and backend.hybrid_beam == hybrid
        assert backend.scheduler.engine.beam_chunk == (24 if hybrid else 0)
    finally:
        run_server.stop_backend(backend)


REST_FLAGS = ("enable_rest", "rest_port", "cors_origins", "rate_limit_rpm", "fake_transcriber")


def test_rest_and_fake_flags_default_as_the_reference(served):
    run_server.main([])
    args, ref = served["args"], jrun_server.build_parser().parse_args([])
    for name in REST_FLAGS:
        assert getattr(args, name) == getattr(ref, name), name
    assert served["rest_port"] is None  # REST stays off without --enable_rest
    assert served["rest_kwargs"] == {"cors_origins": ["*"], "api_key": None,
                                      "rate_limit_rpm": 0}
    helps = {a.dest: a.help for a in run_server.build_parser()._actions}
    ref_helps = {a.dest: a.help for a in jrun_server.build_parser()._actions}
    for name in REST_FLAGS:
        assert helps[name] == ref_helps[name], name


def test_rest_flags_reach_the_server(served):
    argv = ["--enable_rest", "--rest_port", "9393", "--cors_origins", "http://a,http://b",
            "--rate_limit_rpm", "30", "--api_key", "k"]
    run_server.main(argv)
    ref = jrun_server.build_parser().parse_args(argv)
    for name in REST_FLAGS:
        assert getattr(served["args"], name) == getattr(ref, name), name
    assert served["rest_port"] == 9393
    assert served["rest_kwargs"] == {"cors_origins": ["http://a", "http://b"], "api_key": "k",
                                      "rate_limit_rpm": 30}


def test_fake_transcriber_serves_the_fake_backend(monkeypatch):
    from whisperlive_tpu_torch.serving.backends import FakeBackend

    seen = {}
    monkeypatch.setattr(TranscriptionServer, "run",
                        lambda self, backend, **kw: seen.update(kw, backend=backend))
    threads = torch.get_num_threads()
    try:
        run_server.main(["--fake_transcriber", "--model", "large-v3"])  # no model is built
    finally:
        torch.set_num_threads(threads)
    assert type(seen["backend"]) is FakeBackend and seen["backend_name"] == "fake"


PARALLEL_FLAGS = ("tp", "dp", "multihost_ops_port", "multihost_ops_host")


@pytest.mark.parametrize("argv", [[], ["--tp", "2", "--dp", "3", "--multihost_ops_port",
                                       "19191", "--multihost_ops_host", "10.0.0.7"]])
def test_parallel_flags_parse_as_the_reference(argv):
    args = run_server.build_parser().parse_args(argv)
    ref = jrun_server.build_parser().parse_args(argv)
    for name in PARALLEL_FLAGS:
        assert getattr(args, name) == getattr(ref, name), name
    helps = {a.dest: a.help for a in run_server.build_parser()._actions}
    ref_helps = {a.dest: a.help for a in jrun_server.build_parser()._actions}
    for name in PARALLEL_FLAGS:
        assert helps[name] == ref_helps[name], name


MULTI_HOST_REFUSED = [
    (["--tp", "2", "--fake_transcriber"], "no multi-host mode"),
    (["--tp", "2", "--no_continuous_batching"], "requires continuous batching"),
    (["--dp", "2", "--beam_size", "5", "--beam_mode", "refresh"], "--beam_mode full"),
    (["--tp", "2", "--draft_model", "distil-large-v3", "--continuous_spec",
      "--continuous_spec_mode", "mixed"], "use 'all'"),
]


def across_hosts(monkeypatch):
    """The environment of a world across two hosts (host 0 of 2)."""
    monkeypatch.setenv("WL_NUM_PROCS", "2")
    monkeypatch.setenv("WL_PROC_ID", "0")
    monkeypatch.setenv("WL_COORDINATOR", "127.0.0.1:29500")


@pytest.mark.parametrize("argv,refusal", MULTI_HOST_REFUSED)
def test_multi_rank_server_refuses_what_it_cannot_replay(monkeypatch, argv, refusal):
    """Across hosts (WL_NUM_PROCS > 1) the port refuses what the reference's
    multi-host mode refuses: only the continuous pool rides there."""
    across_hosts(monkeypatch)
    monkeypatch.setattr(run_server, "launch_ranks", lambda args: pytest.fail("launched"))
    threads = torch.get_num_threads()
    try:
        with pytest.raises(SystemExit, match=refusal):
            run_server.main(argv + ["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("argv", [argv for argv, _ in MULTI_HOST_REFUSED])
def test_one_host_multi_rank_server_serves_what_the_reference_serves(monkeypatch, argv):
    """On one host the same flags launch the ranks (the window route rides
    the op log there), and --fake_transcriber serves FakeBackend in this
    process, as the reference's one-host create_backend does."""
    from whisperlive_tpu_torch.serving.backends import FakeBackend

    monkeypatch.delenv("WL_NUM_PROCS", raising=False)
    seen = {}
    monkeypatch.setattr(run_server, "launch_ranks", lambda args: seen.update(args=args))
    monkeypatch.setattr(TranscriptionServer, "run",
                        lambda self, backend, **kw: seen.update(kw, backend=backend))
    threads = torch.get_num_threads()
    try:
        run_server.main(argv + ["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    if "--fake_transcriber" in argv:
        assert type(seen["backend"]) is FakeBackend and "args" not in seen
    else:
        args = seen["args"]
        assert args.tp * run_server.resolve_dp(args) == 2
        assert args.continuous_cross_ctx is None  # the pool's own cap, as on one rank


def test_multi_rank_server_launches_its_ranks(monkeypatch):
    """REST stays on and the content cap is the pool's own on one host;
    across hosts REST goes off and the cap is the whole context (resolved
    with the engine)."""
    seen = {}
    monkeypatch.setattr(run_server, "launch_ranks", lambda args: seen.update(args=args))
    monkeypatch.delenv("WL_NUM_PROCS", raising=False)
    threads = torch.get_num_threads()
    try:
        run_server.main(["--tp", "2", "--device", "cpu", "--enable_rest"])
        one_host = seen.pop("args")
        across_hosts(monkeypatch)
        run_server.main(["--tp", "2", "--device", "cpu", "--enable_rest"])
        across = seen.pop("args")
    finally:
        torch.set_num_threads(threads)
    assert one_host.tp == 2 and run_server.resolve_dp(one_host) == 1
    assert one_host.enable_rest and one_host.continuous_cross_ctx is None
    assert not across.enable_rest and across.continuous_cross_ctx == 0
    monkeypatch.delenv("WL_NUM_PROCS")
    assert run_server.resolve_dp(run_server.build_parser().parse_args([])) == 1


def _serve_tp2(monkeypatch, argv, serve) -> None:
    """run_server.main(--tp 2 --device cpu --model tiny ... argv) on one
    host, with `serve(args, backend)` in place of the server; the process
    group is torn down after."""
    import socket

    import torch.distributed as dist

    from whisperlive_tpu_torch.parallel import mesh, multihost

    monkeypatch.setattr(run_server, "run_server", serve)
    monkeypatch.delenv("WL_NUM_PROCS", raising=False)
    monkeypatch.setenv("WL_OPS_SECRET", "test-secret")
    monkeypatch.setenv("PYTHONPATH", os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    threads = torch.get_num_threads()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    try:
        run_server.main(["--tp", "2", "--device", "cpu", "--model", "tiny", "--no_warmup",
                         "--multihost_ops_port", str(port)] + argv)
    finally:
        torch.set_num_threads(threads)
        if dist.is_initialized():
            dist.destroy_process_group()
        mesh._MODEL_GROUP = None
        multihost._LOCAL_RANKS, multihost._BACKEND, multihost._DEVICE = 1, None, None


def _greedy(**kw):
    from whisperlive_tpu_torch.engine.engine import TranscribeOptions

    return TranscribeOptions(language="en", temperatures=(0.0,), log_prob_threshold=None,
                             no_speech_threshold=None, compression_ratio_threshold=None,
                             max_new_tokens=8, **kw)


def test_tp2_server_decodes_through_the_op_log(monkeypatch):
    """`--tp 2 --device cpu`: the command spawns rank 1 (a follower), serves
    as rank 0, and a request decodes through the op log on the continuous
    pool and one (no_repeat_ngram) on the window scheduler; the follower
    exits when the leader stops it."""
    import numpy as np

    from whisperlive_tpu_torch.engine.scheduler import BatchRequest

    seen = {}

    def serve(args, backend):
        cs = backend.continuous_scheduler
        req = BatchRequest(audio=np.zeros(32000, np.float32), options=_greedy(), uid="u")
        opts = _greedy(no_repeat_ngram_size=3)
        window = backend._pick_scheduler(opts, 2.0)
        wreq = BatchRequest(audio=np.zeros(32000, np.float32), options=opts, uid="w")
        seen.update(result=cs.submit(req).result(timeout=120), cb=cs.cb,
                    window_result=window.submit(wreq).result(timeout=120),
                    window=window is backend.scheduler, engine=backend.scheduler.engine,
                    continuous_only=backend.continuous_only)

    _serve_tp2(monkeypatch, ["--continuous_slots", "2"], serve)
    assert not seen["continuous_only"] and seen["cb"].multihost and seen["window"]
    assert seen["cb"].shardings.tp == 2 and seen["cb"].cross_ctx == 640
    assert seen["engine"].multihost and seen["engine"].live_handles == 0
    assert seen["result"].raw_tokens and seen["window_result"].raw_tokens


def test_tp2_window_server_speculates_through_the_op_log(monkeypatch):
    """`--tp 2 --no_continuous_batching --draft_model tiny`: the window
    scheduler alone, a lone greedy request decoded by the SpeculativeDecoder
    on both ranks (the draft sliced like the target), every handle freed."""
    import numpy as np

    from whisperlive_tpu_torch.engine.scheduler import BatchRequest

    seen = {}

    def serve(args, backend):
        req = BatchRequest(audio=np.zeros(32000, np.float32), options=_greedy(), uid="s")
        seen.update(result=backend.scheduler.submit(req).result(timeout=120),
                    continuous=backend.continuous_scheduler, engine=backend.scheduler.engine,
                    stats=dict(backend.scheduler.spec_decoder.stats))

    _serve_tp2(monkeypatch, ["--no_continuous_batching", "--draft_model", "tiny"], serve)
    assert seen["continuous"] is None and seen["stats"]["windows"] == 1
    assert seen["engine"].spec_decoder.draft.shardings.tp == 2
    assert seen["engine"].live_handles == 0 and seen["result"].raw_tokens
