"""WebSocket server on the port.

    python -m whisperlive_tpu_torch.cli.run_server --model large-v3 --port 9090

Loads the checkpoint dir given by -tpu, -fw or -trt (an HF or converted
dir; the first non-empty wins) or, without one, builds random weights from
--seed; then a WhisperEngine on --device (CUDA by default; a missing card
is an error), the window BatchScheduler and, by default, the continuous
slot scheduler, warms both up, and serves through the port's
TranscriptionServer with a TorchBackend. --enable_rest also serves the
OpenAI-compatible REST API on --rest_port (with --cors_origins and
--rate_limit_rpm); --fake_transcriber serves FakeBackend, no model.
Port of whisperlive_tpu/cli/run_server.py; --no_continuous_batching serves
the window path alone. The reference's WhisperLive parity flags (--backend,
--trt_multilingual, --trt_py_session, --no_single_model, --batch_inference),
--cache_path and --compilation_cache are accepted and change nothing here.
--profile_dir (default: the WL_PROFILE_DIR environment variable) traces the
session with torch.profiler and writes the trace there at shutdown.

Beam search (the reference transcriber decodes at beam 5):

    --beam_size 5                     every decode beamed: continuous slots of
                                      5 lanes (--continuous_slots // 5 slots)
    --beam_size 5 --beam_mode refresh greedy partials on the continuous pool,
                                      beamed full re-decodes on the window
                                      scheduler in preemptible segments

Speculative decoding, with a draft loaded from --draft_path or random from
--seed + 1:

    --draft_model distil-large-v3                  lone greedy window requests
    ... --continuous_spec                          every continuous chunk is
                                                   verify rounds
    ... --continuous_spec --continuous_spec_mode mixed
                                                   full re-decodes on a second,
                                                   speculative pool

Tensor and data parallelism (one process per rank, parallel/mesh.py): with
--tp or --dp above 1 the command starts its host's ranks itself
(torch.multiprocessing, spawn). Rank 0 serves; every other rank replays
its device ops from rank 0's op log (parallel/serve_multihost.py,
HMAC-authenticated with WL_OPS_SECRET). On one host that is everything a
one-rank server runs: the window scheduler and its warm-up, REST, beam and
hybrid beam, window-path speculation and both speculative pools. A world
across hosts (WL_NUM_PROCS > 1) serves the continuous path only, as the
reference's multi-host mode: it refuses --no_continuous_batching,
--beam_mode refresh, --continuous_spec_mode mixed and --fake_transcriber,
and turns REST off.

    --tp 2                            heads and MLP units over 2 ranks
    --tp 2 --dp 2                     2 replicas, the slot pool dp times
                                      --continuous_slots
    WL_COORDINATOR=host0:29500 WL_NUM_PROCS=2 WL_PROC_ID=<i>
                                      the same command on every host: host i
                                      runs ranks i * L .. i * L + L - 1 of the
                                      tp * dp world (L = tp * dp / hosts; tp
                                      must divide L)

Ranks sharing a card (as on a one-card machine) talk over gloo on the
card's tensors; ranks with a card each over NCCL.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from whisperlive_tpu_torch.models.whisper import WHISPER_CONFIGS
from whisperlive_tpu_torch.utils import profiling


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="whisperlive-tpu-torch server")
    parser.add_argument("--port", "-p", type=int, default=9090,
                        help="Websocket port to run the server on.")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--backend", "-b", type=str, default="tpu",
                        choices=["tpu", "faster_whisper", "tensorrt", "openvino"],
                        help="Backend name (accepted for parity: every value serves the "
                             "PyTorch engine).")
    parser.add_argument("--tpu_model_path", "-tpu", type=str, default=None,
                        help="Path to a converted checkpoint dir or HF checkpoint dir.")
    parser.add_argument("--faster_whisper_custom_model_path", "-fw", type=str, default=None,
                        help="(accepted for parity; treated as checkpoint dir)")
    parser.add_argument("--trt_model_path", "-trt", type=str, default=None,
                        help="(accepted for parity; treated as checkpoint dir)")
    parser.add_argument("--trt_multilingual", action="store_true",
                        help="(parity no-op; multilingual-ness comes from the model)")
    parser.add_argument("--trt_py_session", action="store_true", help="(parity no-op)")
    parser.add_argument("--omp_num_threads", "-omp", type=int, default=1,
                        help="Number of threads for host work: sets OMP_NUM_THREADS and "
                             "torch's intra-op thread count.")
    parser.add_argument("--no_single_model", action="store_true",
                        help="(parity no-op: the engine is always shared)")
    parser.add_argument("--batch_inference", action="store_true", default=True,
                        help="Cross-client batching (always on).")
    parser.add_argument("--compute_dtype", type=str, default=None,
                        choices=[None, "bfloat16", "float32"],
                        help="Override the engine compute dtype (default bfloat16 on CUDA, "
                             "float32 on the CPU; the CUDA kernels take bfloat16).")
    parser.add_argument("--compilation_cache", type=str,
                        default="~/.cache/whisper-live-tpu/xla-cache",
                        help="(accepted for parity; does nothing on this backend: there is "
                             "no XLA compilation to cache)")
    parser.add_argument("--model", "-m", type=str, default="small",
                        choices=sorted(WHISPER_CONFIGS),
                        help="Whisper model size (random weights from --seed) when no "
                             "checkpoint dir is given.")
    parser.add_argument("--seed", type=int, default=0,
                        help="Seed of the random weights.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device of the engine ('cuda' or 'cpu').")
    parser.add_argument("--batch_max_size", type=int, default=8)
    parser.add_argument("--batch_window_ms", type=int, default=50)
    parser.add_argument("--continuous_batching", action="store_true", default=True,
                        help="Decode-step-level continuous batching: windows join a "
                             "running decode at chunk boundaries (default on; greedy).")
    parser.add_argument("--no_continuous_batching", dest="continuous_batching",
                        action="store_false")
    parser.add_argument("--continuous_slots", type=int, default=16,
                        help="Device slots for the continuous decode loop.")
    parser.add_argument("--steps_per_chunk", type=int, default=8,
                        help="Decode steps per continuous-loop dispatch "
                             "(join/harvest granularity).")
    parser.add_argument("--continuous_cross_ctx", type=int, default=None,
                        help="Encoder positions of cross-KV kept per continuous slot "
                             "(default 640 = 12.8 s of audio for a 1500-position "
                             "encoder; longer windows fall back to the window "
                             "scheduler).")
    parser.add_argument("--max_clients", type=int, default=4,
                        help="Maximum concurrent client connections.")
    parser.add_argument("--max_connection_time", type=int, default=600,
                        help="Per-client connection time budget in seconds.")
    parser.add_argument("--cache_path", "-c", type=str, default="~/.cache/whisper-live-tpu/",
                        help="Converted-checkpoint cache directory (accepted for parity; "
                             "checkpoints are read from -tpu/-fw/-trt).")
    parser.add_argument("--enable_rest", action="store_true",
                        help="Enable the OpenAI-compatible REST API.")
    parser.add_argument("--rest_port", type=int, default=9091)
    parser.add_argument("--cors_origins", type=str, default="*",
                        help="Comma-separated allowed CORS origins for REST.")
    parser.add_argument("--beam_size", type=int, default=1,
                        help="Beam width for streaming decodes (1 = greedy; the reference's "
                             "transcriber defaults to 5; wider beams shrink the effective "
                             "device batch).")
    parser.add_argument("--beam_mode", choices=("full", "refresh"), default="full",
                        help="With --beam_size > 1: 'full' beams every decode on a "
                             "lane-multiplied continuous pool (slot budget / beam_size); "
                             "'refresh' keeps the continuous pool greedy at full slot count "
                             "and beams only the full re-decodes (periodic WL_PREFIX_REFRESH "
                             "windows and post-commit windows) on the window scheduler.")
    parser.add_argument("--draft_model", type=str, default=None, choices=sorted(WHISPER_CONFIGS),
                        help="Distil-family draft size for speculative decoding of lone "
                             "greedy window requests (e.g. distil-large-v3; it must share "
                             "the target's encoder geometry and vocabulary; random weights "
                             "from --seed + 1).")
    parser.add_argument("--draft_path", type=str, default=None,
                        help="Checkpoint dir (HF or converted) of the draft; its size is "
                             "--draft_model's, distil-large-v3 by default.")
    parser.add_argument("--spec_k", type=int, default=4,
                        help="Speculation depth (draft tokens per verify pass).")
    parser.add_argument("--continuous_spec", action="store_true",
                        help="Speculative continuous batching: every lockstep chunk is a "
                             "sequence of verify rounds (the draft proposes spec_k tokens "
                             "per slot, the target verifies them in one windowed pass). "
                             "Needs a draft (--draft_model or --draft_path); at low "
                             "acceptance each slot's ring "
                             "budget shrinks toward ring/(spec_k+2) tokens per window.")
    parser.add_argument("--continuous_spec_mode", choices=("all", "mixed"), default="all",
                        help="With --continuous_spec: 'all' attaches the draft to the main "
                             "pool; 'mixed' keeps the main pool plain for short incremental "
                             "tails and routes full re-decodes to a second speculative pool, "
                             "falling back to plain while the acceptance EMA is below the "
                             "breakeven (WL_SPEC_BREAKEVEN/WL_SPEC_REENABLE/"
                             "WL_SPEC_PROBE_S).")
    parser.add_argument("--spec_slots", type=int, default=8,
                        help="Device slots of the mixed mode's speculative pool (full "
                             "re-decodes only, so fewer than --continuous_slots).")
    parser.add_argument("--raw_pcm_input", type=str, default="float32",
                        choices=["float32", "int16", "uint8"],
                        help="Default PCM format when clients don't specify one.")
    parser.add_argument("--metrics_port", type=int, default=None,
                        help="Prometheus /metrics port.")
    parser.add_argument("--api_key", type=str, default=os.environ.get("WL_API_KEY"),
                        help="Require 'Authorization: Bearer <key>' / ?token=.")
    parser.add_argument("--rate_limit_rpm", type=int, default=0,
                        help="Per-IP REST rate limit (requests/minute, 0=off).")
    parser.add_argument("--fake_transcriber", action="store_true",
                        help="Serve a deterministic fake model (protocol testing).")
    parser.add_argument("--profile_dir", type=str, default=os.environ.get("WL_PROFILE_DIR"),
                        help="Write a torch.profiler trace (Chrome JSON; CPU, and CUDA "
                             "on a card) of the whole session to this dir at shutdown.")
    parser.add_argument("--no_warmup", action="store_true",
                        help="Skip the warm-up decodes (and kernel build) at startup.")
    parser.add_argument("--tp", type=int, default=1,
                        help="Tensor-parallel degree over the local device mesh.")
    parser.add_argument("--dp", type=int, default=None,
                        help="Data-parallel replicas for SERVING: the "
                             "continuous slot pool scales to dp x "
                             "--continuous_slots and its state shards over "
                             "the mesh's data axis (each replica decodes "
                             "its own slots). Default: n_devices // tp "
                             "when --tp or --dp is given, else 1.")
    parser.add_argument("--multihost_ops_port", type=int, default=19090,
                        help="TCP port of the multi-host serving op log "
                             "(parallel/serve_multihost.py). Active when "
                             "WL_COORDINATOR/WL_NUM_PROCS/WL_PROC_ID are "
                             "set: process 0 serves and broadcasts every "
                             "device op; the others replay them. All "
                             "hosts must launch with IDENTICAL flags. "
                             "The channel is HMAC-authenticated with "
                             "WL_OPS_SECRET (set it on every host).")
    parser.add_argument("--multihost_ops_host", type=str, default=None,
                        help="Interface the leader binds the op log on. "
                             "Default: the WL_COORDINATOR host (the pod-"
                             "internal interface the followers already "
                             "reach) — NOT 0.0.0.0; the op stream carries "
                             "every session's raw audio.")
    return parser


def resolve_dp(args) -> int:
    """--dp, or n_devices // tp (at least 1) over every host when --tp or
    --dp is given, else 1."""
    if args.dp is not None:
        return args.dp
    if args.tp == 1:
        return 1
    n_dev = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 0
    hosts = int(os.environ.get("WL_NUM_PROCS", "1"))
    return max(1, n_dev * hosts // args.tp)


def _continuous_pool_kwargs(args, shardings) -> dict:
    """Geometry of the continuous slot pool: one definition, so the
    multi-process leader and its followers build identical pools."""
    n_slots, lanes = continuous_pool_size(args)
    if shardings is not None and shardings.dp > 1:
        n_slots *= shardings.dp
    return dict(n_slots=n_slots, steps_per_chunk=args.steps_per_chunk,
                cross_ctx=args.continuous_cross_ctx, beam_width=lanes, spec_k=args.spec_k)


def continuous_pool_size(args) -> tuple[int, int]:
    """(slots, lanes) of the continuous pool: with --beam_size > 1 in full
    mode each slot owns beam_size lanes and the pool shrinks to bound the
    resident state; hybrid beam keeps a greedy pool at full size."""
    if args.beam_size > 1 and args.beam_mode == "full":
        return max(2, args.continuous_slots // args.beam_size), args.beam_size
    return args.continuous_slots, 1


def several_hosts() -> bool:
    """True when the world spans hosts (WL_NUM_PROCS > 1): the reference's
    multi-host mode, which serves the continuous path alone."""
    return int(os.environ.get("WL_NUM_PROCS", "1")) > 1


def create_backend(args, shardings=None, leader=None, follower: bool = False):
    """The backend of the CLI flags: FakeBackend with --fake_transcriber,
    else an engine with its started schedulers behind TorchBackend.

    Every rank of a multi-rank world runs this one function with its
    shardings, so the leader and its followers build identical engines,
    pools and decoders in the same order. Rank 0 passes its OpLeader: the
    window engine (with its SpeculativeDecoder) and every slot pool publish
    their device ops there. A follower passes follower=True and gets the
    replay targets ({name: target}, for run_follower) in place of a
    backend, with nothing started. The window warm-up runs on every rank
    itself, in the same order, before the first op is published. A world
    across hosts (several_hosts()) serves the continuous path alone, as
    the reference's multi-host mode does: no window warm-up, no window
    target, a continuous-only backend."""
    import functools

    import torch

    from whisperlive_tpu_torch.serving.backends import FakeBackend

    if args.fake_transcriber:
        return FakeBackend()

    from whisperlive_tpu_torch.device import resolve_device
    from whisperlive_tpu_torch.engine.continuous import ContinuousScheduler
    from whisperlive_tpu_torch.engine.scheduler import BatchScheduler
    from whisperlive_tpu_torch.loader import load_engine
    from whisperlive_tpu_torch.parallel import multihost
    from whisperlive_tpu_torch.parallel import serve_multihost as smh
    from whisperlive_tpu_torch.serving.backends import (
        TorchBackend,
        transcribe_options_from_session,
    )
    from whisperlive_tpu_torch.serving.session import SessionOptions

    multi = shardings is not None
    window_route = not (multi and several_hosts())
    device = multihost.device() if multi else resolve_device(args.device)
    dtype = ({"bfloat16": torch.bfloat16, "float32": torch.float32}[args.compute_dtype]
             if args.compute_dtype else None)
    ckpt = args.tpu_model_path or args.faster_whisper_custom_model_path or args.trt_model_path
    has_draft = bool(args.draft_model or args.draft_path)

    def build_draft():
        # under --tp/--dp the draft is sliced over the target's grid
        return load_engine(args.draft_model or "distil-large-v3", args.draft_path, device,
                           dtype, seed=args.seed + 1, shardings=shardings)

    hybrid_beam = args.beam_size > 1 and args.beam_mode == "refresh"
    engine = load_engine(args.model, ckpt, device, dtype, seed=args.seed, shardings=shardings)
    if args.continuous_cross_ctx == 0:  # the whole context (a world across hosts)
        args.continuous_cross_ctx = engine.cfg.n_audio_ctx
    if hybrid_beam:
        # beamed fulls run in preemptible segments (a program of its own:
        # set on every rank before the warm-up)
        engine.enable_beam_chunk()
    if not args.no_warmup and window_route:
        engine.warmup(
            batch_sizes={b for b in engine.batch_buckets if b <= args.batch_max_size},
            options=transcribe_options_from_session(SessionOptions(), beam_size=args.beam_size),
        )
    draft = spec_decoder = None
    if has_draft and not window_route:
        if args.continuous_spec:
            warn_draft_ctx(args, for_continuous=True)
            draft = build_draft()
        else:
            logging.warning("multi-host serving uses a draft only with --continuous_spec; "
                            "window-path speculation is disabled")
    elif has_draft and args.beam_size > 1 and not hybrid_beam:
        # every window request carries the beam, and the speculative route
        # serves greedy requests only
        logging.warning("--draft_model is ignored with --beam_size %d --beam_mode full: the "
                        "speculative route serves greedy requests only", args.beam_size)
    elif has_draft and hybrid_beam:
        # the greedy partials on the continuous pool can take the draft
        # (--continuous_spec); window requests carry the beam, so no
        # SpeculativeDecoder
        draft = build_draft()
        warn_draft_ctx(args, for_continuous=True)
    elif has_draft:
        from whisperlive_tpu_torch.engine.speculative import SpeculativeDecoder

        draft = build_draft()
        warn_draft_ctx(args, for_continuous=args.continuous_spec)
        spec_decoder = SpeculativeDecoder(engine, draft, k=args.spec_k)
        if not args.no_warmup:
            spec_decoder.warmup(options=transcribe_options_from_session(SessionOptions()))
        logging.info("speculative serving: draft=%s k=%d (lone greedy window requests)",
                     args.draft_path or args.draft_model or "distil-large-v3", args.spec_k)
    if args.continuous_spec and draft is None:
        logging.warning("--continuous_spec ignored: no draft (give --draft_model or "
                        "--draft_path with --beam_size 1 or --beam_mode refresh)")
    window, targets = engine, {}
    if multi and window_route:
        window = smh.MultihostWindowEngine(engine, leader=leader, spec_decoder=spec_decoder)
        spec_decoder, targets["window"] = window.speculative, window

    def pool(name, **kw):
        """A ContinuousScheduler whose pool, on a multi-rank world, is on
        the op log under `name`."""
        if not multi:
            return ContinuousScheduler(engine, **kw)
        if not window_route:
            # the reference's multi-host pool: ContinuousEngine's own
            # prompt region and ring
            return ContinuousScheduler(engine, cb=smh.MultihostContinuousEngine(
                engine, leader=leader, name=name, **kw))
        return ContinuousScheduler(engine, pool_factory=functools.partial(
            smh.MultihostContinuousEngine, leader=leader, name=name), **kw)

    continuous = spec_pool = None
    if args.continuous_batching:
        geometry = _continuous_pool_kwargs(args, shardings)
        if hybrid_beam:
            logging.info("hybrid beam serving: greedy continuous pool (%d slots), beam-%d full "
                         "re-decodes on the window scheduler", geometry["n_slots"],
                         args.beam_size)
        elif geometry["beam_width"] > 1:
            logging.info("continuous beam serving: %d slots x %d lanes", geometry["n_slots"],
                         geometry["beam_width"])
        spec_all = draft is not None and args.continuous_spec and (
            args.continuous_spec_mode == "all")
        continuous = pool("main", draft_engine=draft if spec_all else None, **geometry)
        targets["main"] = continuous.cb
        if draft is not None and args.continuous_spec and not spec_all:
            # the speculative pool serves full re-decodes only: fewer slots,
            # a larger ring (a round takes spec_k+2 ring columns and a
            # from-scratch window decodes ~100 tokens) and at most 4 rounds
            # a chunk
            logging.info("mixed speculative routing: full re-decodes on a %d-slot pool "
                         "(k=%d), incremental tails plain", args.spec_slots, args.spec_k)
            spec_pool = pool("spec", draft_engine=draft, n_slots=args.spec_slots,
                             steps_per_chunk=min(args.steps_per_chunk, 4),
                             cross_ctx=args.continuous_cross_ctx, ring=192, spec_k=args.spec_k)
            targets["spec"] = spec_pool.cb
    if follower:
        return targets
    # every pool is built (and on the op log) before the first op
    for cs in (continuous, spec_pool):
        if cs is not None:
            if not args.no_warmup:
                cs.warmup()
            cs.start()
    scheduler = (smh.MultihostBatchScheduler if "window" in targets else BatchScheduler)(
        window, max_batch_size=args.batch_max_size, batch_window_ms=args.batch_window_ms,
        spec_decoder=spec_decoder,
    )
    if window_route:
        # across hosts the window scheduler stays built (the backend reads
        # engine metadata from it) but never starts: its ops are not replayed
        scheduler.start()
    if args.beam_size > 1 and args.batch_max_size * args.beam_size > 16:
        logging.warning("batch_max_size*beam_size=%d may exceed device memory; consider "
                        "lowering --batch_max_size", args.batch_max_size * args.beam_size)
    return TorchBackend(scheduler, model_name=ckpt or args.model,
                        continuous_scheduler=continuous,
                        spec_scheduler=spec_pool, beam_size=args.beam_size,
                        beam_mode=args.beam_mode, continuous_only=not window_route)


def warn_draft_ctx(args, for_continuous: bool) -> None:
    """A draft only matches its target at the encoder context it was
    distilled at: continuous streaming encodes short tails at 512 positions,
    window serving at the full context. Warn when the deployment does not
    match the checkpoint's recorded distill_enc_ctx, and refuse a
    --continuous_spec pool at the default cross context, which would serve
    at ~0 acceptance."""
    from whisperlive_tpu_torch.loader import draft_distill_ctx

    d_ctx = draft_distill_ctx(args.draft_path)
    if not d_ctx:
        return
    if for_continuous and d_ctx != 512:
        msg = (f"draft distilled at enc_ctx={d_ctx} but --continuous_spec verifies at "
               "512-position tail encodes: acceptance will collapse; distill with "
               "--enc_ctx 512")
        if args.continuous_spec and args.continuous_cross_ctx is None:
            raise SystemExit(msg)
        logging.warning("%s", msg)
    if not for_continuous and d_ctx != 1500:
        logging.warning("draft distilled at enc_ctx=%d but window speculation verifies at "
                        "the full 1500-position encode: acceptance will collapse; distill "
                        "with --enc_ctx 0 (full)", d_ctx)


def check_multihost_flags(args) -> None:
    """Refuse what a world across hosts does not serve, as the reference's
    multi-host mode: only the continuous pool's ops are replayed on the
    other hosts' ranks, so nothing may need the window scheduler (on one
    host the window route rides the op log too). The content cap defaults
    to the whole encoder context, so no window is long enough to need the
    window path."""
    if args.fake_transcriber:
        raise SystemExit("--fake_transcriber has no multi-host mode")
    if not args.continuous_batching:
        raise SystemExit("multi-host serving requires continuous batching "
                         "(drop --no_continuous_batching)")
    if args.beam_size > 1 and args.beam_mode == "refresh":
        raise SystemExit("--beam_mode refresh routes full re-decodes through the window "
                         "scheduler, which multi-host serving cannot replay; use "
                         "--beam_mode full")
    if args.continuous_spec and args.continuous_spec_mode == "mixed" and (
            args.draft_model or args.draft_path):
        raise SystemExit("--continuous_spec_mode mixed needs a second continuous pool, "
                         "whose ops are not replayed on follower hosts; use 'all' with "
                         "multi-host serving")
    if args.enable_rest:
        # REST files ride the window scheduler's seek loop
        logging.warning("multi-host serving disables the REST API")
        args.enable_rest = False
    if args.continuous_cross_ctx is None:
        args.continuous_cross_ctx = 0  # the whole context, resolved with the engine


def run_multihost_follower(args, shardings, coordinator: str) -> int:
    """A follower rank: build what the leader builds (create_backend's
    replay targets), then replay its op log (on the coordinator's host,
    rank 0's) until it stops. -> the ops replayed."""
    from whisperlive_tpu_torch.parallel import serve_multihost as smh

    leader = (coordinator.rsplit(":", 1)[0], args.multihost_ops_port)
    logging.info("multi-rank follower rank %d: replaying ops from %s:%d", shardings.rank,
                 *leader)
    chan = smh.OpFollower(leader)
    try:
        n = smh.run_follower(create_backend(args, shardings, follower=True), chan)
    finally:
        chan.close()
    logging.info("multi-rank follower rank %d: leader stopped after %d ops", shardings.rank, n)
    return n


def serve_rank(index: int, args, coordinator: str, host: int, n_hosts: int,
               local_ranks: int) -> None:
    """One rank of a multi-process server: local rank index + 1 of this
    host (the spawned children; the command's own process passes -1 and
    is local rank 0). Rank 0 serves the full backend over the op log,
    which binds on --multihost_ops_host, else on the coordinator's host
    (the internal interface the followers already reach, never 0.0.0.0:
    the stream carries every session's audio); the others follow."""
    from whisperlive_tpu_torch.parallel import multihost
    from whisperlive_tpu_torch.parallel import serve_multihost as smh

    if index >= 0:  # a spawned child: its own logging and thread pool
        logging.basicConfig(level=logging.INFO)
        torch.set_num_threads(args.omp_num_threads)
    multihost.init_multihost(coordinator, n_hosts, host, device=args.device,
                             local_ranks=local_ranks, local_rank=index + 1)
    shardings = multihost.multihost_shardings(tp=args.tp, dp=resolve_dp(args))
    if not multihost.is_primary():
        run_multihost_follower(args, shardings, coordinator)
        return
    world = n_hosts * local_ranks
    leader = smh.OpLeader(args.multihost_ops_port, n_followers=world - 1,
                          host=args.multihost_ops_host or coordinator.rsplit(":", 1)[0])
    logging.info("multi-rank serving: leading %d follower ranks over the op log (port %d), "
                 "dp=%d x tp=%d%s", world - 1, args.multihost_ops_port, shardings.dp,
                 shardings.tp, " (continuous path only: across hosts)" if n_hosts > 1 else "")
    try:
        backend = create_backend(args, shardings, leader)
        try:
            run_server(args, backend)
        finally:
            stop_backend(backend)
    finally:
        leader.stop()


def launch_ranks(args) -> None:
    """Start this host's ranks of a tp x dp world (the other local ranks
    spawned, local rank 0 in this process) and wait for them. Without
    WL_COORDINATOR the world is this host's, meeting at a free local
    port."""
    import socket

    import torch.multiprocessing as mp

    world = args.tp * resolve_dp(args)
    n_hosts = int(os.environ.get("WL_NUM_PROCS", "1"))
    host = int(os.environ.get("WL_PROC_ID", "0"))
    coordinator = os.environ.get("WL_COORDINATOR")
    if coordinator is None:
        if n_hosts != 1:
            raise SystemExit("WL_NUM_PROCS > 1 needs WL_COORDINATOR (host:port of rank 0)")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
    if world % n_hosts:
        raise SystemExit(f"tp * dp = {world} ranks do not divide over {n_hosts} hosts")
    local_ranks = world // n_hosts
    logging.info("host %d/%d: ranks %d..%d of dp=%d x tp=%d via %s", host, n_hosts,
                 host * local_ranks, (host + 1) * local_ranks - 1, world // args.tp, args.tp,
                 coordinator)
    ctx = mp.start_processes(serve_rank, args=(args, coordinator, host, n_hosts, local_ranks),
                             nprocs=local_ranks - 1, join=False, start_method="spawn")
    try:
        serve_rank(-1, args, coordinator, host, n_hosts, local_ranks)
        while not ctx.join():
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()


def run_server(args, backend) -> None:
    from whisperlive_tpu_torch.serving.server import TranscriptionServer

    server = TranscriptionServer()
    server.raw_pcm_default = args.raw_pcm_input
    rest_kwargs = dict(
        cors_origins=args.cors_origins.split(","),
        api_key=args.api_key,
        rate_limit_rpm=args.rate_limit_rpm,
    )
    server.run(
        backend,
        host=args.host,
        port=args.port,
        backend_name="fake" if args.fake_transcriber else "torch",
        max_clients=args.max_clients,
        max_connection_time=args.max_connection_time,
        api_key=args.api_key,
        metrics_port=args.metrics_port,
        rest_port=args.rest_port if args.enable_rest else None,
        rest_kwargs=rest_kwargs,
    )


def stop_backend(backend) -> None:
    if not hasattr(backend, "scheduler"):  # FakeBackend
        return
    backend.scheduler.stop()
    for pool in (backend.continuous_scheduler, backend.spec_scheduler):
        if pool is not None:
            pool.stop()


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if args.backend != "tpu":
        logging.warning("backend %r is a legacy name; serving with the PyTorch engine",
                        args.backend)
    os.environ["OMP_NUM_THREADS"] = str(args.omp_num_threads)
    # torch read OMP_NUM_THREADS when this module imported it: set its pool
    # here too
    torch.set_num_threads(args.omp_num_threads)
    if args.profile_dir:
        profiling.start_profiler(args.profile_dir, device=args.device)
    try:
        if several_hosts():
            check_multihost_flags(args)
            launch_ranks(args)
            return
        if not args.fake_transcriber and args.tp * resolve_dp(args) > 1:
            # one host: the ranks serve all a one-rank server does
            launch_ranks(args)
            return
        backend = create_backend(args)
        try:
            run_server(args, backend)
        finally:
            stop_backend(backend)
    finally:
        # the trace of the served session is written on shutdown
        profiling.stop_profiler()


if __name__ == "__main__":
    main()
