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
Port of whisperlive_tpu/cli/run_server.py without multi-host serving;
--no_continuous_batching serves the window path alone. The reference's
WhisperLive parity flags (--backend, --trt_multilingual, --trt_py_session,
--no_single_model, --batch_inference), --cache_path and --compilation_cache
are accepted and change nothing here.

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
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from whisperlive_tpu_torch.models.whisper import WHISPER_CONFIGS


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
    parser.add_argument("--no_warmup", action="store_true",
                        help="Skip the warm-up decodes (and kernel build) at startup.")
    return parser


def continuous_pool_size(args) -> tuple[int, int]:
    """(slots, lanes) of the continuous pool: with --beam_size > 1 in full
    mode each slot owns beam_size lanes and the pool shrinks to bound the
    resident state; hybrid beam keeps a greedy pool at full size."""
    if args.beam_size > 1 and args.beam_mode == "full":
        return max(2, args.continuous_slots // args.beam_size), args.beam_size
    return args.continuous_slots, 1


def create_backend(args):
    """The backend of the CLI flags: FakeBackend with --fake_transcriber,
    else an engine with its started schedulers behind TorchBackend."""
    import torch

    from whisperlive_tpu_torch.serving.backends import FakeBackend

    if args.fake_transcriber:
        return FakeBackend()

    from whisperlive_tpu_torch.device import resolve_device
    from whisperlive_tpu_torch.engine.scheduler import BatchScheduler
    from whisperlive_tpu_torch.loader import load_engine
    from whisperlive_tpu_torch.serving.backends import (
        TorchBackend,
        transcribe_options_from_session,
    )
    from whisperlive_tpu_torch.serving.session import SessionOptions

    device = resolve_device(args.device)
    dtype = ({"bfloat16": torch.bfloat16, "float32": torch.float32}[args.compute_dtype]
             if args.compute_dtype else None)
    ckpt = args.tpu_model_path or args.faster_whisper_custom_model_path or args.trt_model_path
    has_draft = bool(args.draft_model or args.draft_path)

    def build_draft():
        return load_engine(args.draft_model or "distil-large-v3", args.draft_path, device,
                           dtype, seed=args.seed + 1)

    hybrid_beam = args.beam_size > 1 and args.beam_mode == "refresh"
    engine = load_engine(args.model, ckpt, device, dtype, seed=args.seed)
    if not args.no_warmup:
        if hybrid_beam:
            # beamed fulls run in preemptible segments; enable them first
            engine.enable_beam_chunk()
        engine.warmup(
            batch_sizes={b for b in engine.batch_buckets if b <= args.batch_max_size},
            options=transcribe_options_from_session(SessionOptions(), beam_size=args.beam_size),
        )
    draft = spec_decoder = None
    if has_draft and args.beam_size > 1 and not hybrid_beam:
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
    scheduler = BatchScheduler(
        engine, max_batch_size=args.batch_max_size, batch_window_ms=args.batch_window_ms,
        spec_decoder=spec_decoder,
    )
    scheduler.start()
    continuous = spec_pool = None
    if args.continuous_batching:
        from whisperlive_tpu_torch.engine.continuous import ContinuousScheduler

        n_slots, lanes = continuous_pool_size(args)
        if hybrid_beam:
            logging.info("hybrid beam serving: greedy continuous pool (%d slots), beam-%d full "
                         "re-decodes on the window scheduler", n_slots, args.beam_size)
        elif lanes > 1:
            logging.info("continuous beam serving: %d slots x %d lanes", n_slots, lanes)
        spec_all = draft is not None and args.continuous_spec and (
            args.continuous_spec_mode == "all")
        continuous = ContinuousScheduler(
            engine, n_slots=n_slots, steps_per_chunk=args.steps_per_chunk,
            cross_ctx=args.continuous_cross_ctx, beam_width=lanes,
            draft_engine=draft if spec_all else None, spec_k=args.spec_k,
        )
        if not args.no_warmup:
            continuous.warmup()
        continuous.start()
        if draft is not None and args.continuous_spec and not spec_all:
            # the speculative pool serves full re-decodes only: fewer slots,
            # a larger ring (a round takes spec_k+2 ring columns and a
            # from-scratch window decodes ~100 tokens) and at most 4 rounds
            # a chunk
            logging.info("mixed speculative routing: full re-decodes on a %d-slot pool "
                         "(k=%d), incremental tails plain", args.spec_slots, args.spec_k)
            spec_pool = ContinuousScheduler(
                engine, draft_engine=draft, n_slots=args.spec_slots,
                steps_per_chunk=min(args.steps_per_chunk, 4),
                cross_ctx=args.continuous_cross_ctx, ring=192, spec_k=args.spec_k,
            )
            if not args.no_warmup:
                spec_pool.warmup()
            spec_pool.start()
    if args.beam_size > 1 and args.batch_max_size * args.beam_size > 16:
        logging.warning("batch_max_size*beam_size=%d may exceed device memory; consider "
                        "lowering --batch_max_size", args.batch_max_size * args.beam_size)
    return TorchBackend(scheduler, model_name=ckpt or args.model,
                        continuous_scheduler=continuous,
                        spec_scheduler=spec_pool, beam_size=args.beam_size,
                        beam_mode=args.beam_mode)


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
    backend = create_backend(args)

    from whisperlive_tpu_torch.serving.server import TranscriptionServer

    server = TranscriptionServer()
    server.raw_pcm_default = args.raw_pcm_input
    rest_kwargs = dict(
        cors_origins=args.cors_origins.split(","),
        api_key=args.api_key,
        rate_limit_rpm=args.rate_limit_rpm,
    )
    try:
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
    finally:
        stop_backend(backend)


if __name__ == "__main__":
    main()
