"""WebSocket server on the port.

    python -m whisperlive_tpu_torch.cli.run_server --model large-v3 --port 9090

Builds random weights from --seed (the repository holds no checkpoint;
loading converted checkpoints is ROADMAP.md open item 11), a WhisperEngine
on --device (CUDA by default; a missing card is an error), the window
BatchScheduler and, by default, the continuous slot scheduler, warms both
up, and serves through the port's TranscriptionServer with a TorchBackend.
Port of whisperlive_tpu/cli/run_server.py without multi-host and beam
serving; --no_continuous_batching serves the window path alone.

Speculative decoding, with a random draft from --seed + 1:

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

from whisperlive_tpu_torch.models.whisper import WHISPER_CONFIGS


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="whisperlive-tpu-torch server")
    parser.add_argument("--port", "-p", type=int, default=9090,
                        help="Websocket port to run the server on.")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--model", "-m", type=str, default="small",
                        choices=sorted(WHISPER_CONFIGS),
                        help="Whisper model size (random weights from --seed).")
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
    parser.add_argument("--draft_model", type=str, default=None, choices=sorted(WHISPER_CONFIGS),
                        help="Distil-family draft size for speculative decoding of lone "
                             "greedy window requests (e.g. distil-large-v3; it must share "
                             "the target's encoder geometry and vocabulary; random weights "
                             "from --seed + 1).")
    parser.add_argument("--draft_path", type=str, default=None,
                        help="Converted checkpoint directory of the draft (not ported: "
                             "ROADMAP.md open item 11).")
    parser.add_argument("--spec_k", type=int, default=4,
                        help="Speculation depth (draft tokens per verify pass).")
    parser.add_argument("--continuous_spec", action="store_true",
                        help="Speculative continuous batching: every lockstep chunk is a "
                             "sequence of verify rounds (the draft proposes spec_k tokens "
                             "per slot, the target verifies them in one windowed pass). "
                             "Needs --draft_model; at low acceptance each slot's ring "
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
    parser.add_argument("--no_warmup", action="store_true",
                        help="Skip the warm-up decodes (and kernel build) at startup.")
    return parser


def create_backend(args):
    """Engine, started schedulers and backend from the CLI flags."""
    from whisperlive_tpu_torch.device import default_compute_dtype, resolve_device
    from whisperlive_tpu_torch.engine.engine import WhisperEngine
    from whisperlive_tpu_torch.engine.scheduler import BatchScheduler
    from whisperlive_tpu_torch.models.whisper import init_params
    from whisperlive_tpu_torch.serving.backends import TorchBackend

    if args.draft_path:
        raise NotImplementedError(
            "--draft_path (checkpoint loading) is not ported yet: ROADMAP.md open item 11"
        )
    device = resolve_device(args.device)

    def build_engine(name: str, seed: int) -> WhisperEngine:
        cfg = WHISPER_CONFIGS[name]
        return WhisperEngine(cfg, init_params(cfg, seed, default_compute_dtype(device), device),
                             device=device)

    engine = build_engine(args.model, args.seed)
    if not args.no_warmup:
        engine.warmup(
            batch_sizes={b for b in engine.batch_buckets if b <= args.batch_max_size}
        )
    draft = spec_decoder = None
    if args.draft_model:
        from whisperlive_tpu_torch.engine.speculative import SpeculativeDecoder

        draft = build_engine(args.draft_model, args.seed + 1)
        spec_decoder = SpeculativeDecoder(engine, draft, k=args.spec_k)
        if not args.no_warmup:
            from whisperlive_tpu_torch.serving.backends import transcribe_options_from_session
            from whisperlive_tpu_torch.serving.session import SessionOptions

            spec_decoder.warmup(options=transcribe_options_from_session(SessionOptions()))
        logging.info("speculative serving: draft=%s k=%d (lone greedy window requests)",
                     args.draft_model, args.spec_k)
    elif args.continuous_spec:
        logging.warning("--continuous_spec ignored: no draft (give --draft_model)")
    scheduler = BatchScheduler(
        engine, max_batch_size=args.batch_max_size, batch_window_ms=args.batch_window_ms,
        spec_decoder=spec_decoder,
    )
    scheduler.start()
    continuous = spec_pool = None
    if args.continuous_batching:
        from whisperlive_tpu_torch.engine.continuous import ContinuousScheduler

        spec_all = draft is not None and args.continuous_spec and (
            args.continuous_spec_mode == "all")
        continuous = ContinuousScheduler(
            engine, n_slots=args.continuous_slots, steps_per_chunk=args.steps_per_chunk,
            cross_ctx=args.continuous_cross_ctx, draft_engine=draft if spec_all else None,
            spec_k=args.spec_k,
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
    return TorchBackend(scheduler, model_name=args.model, continuous_scheduler=continuous,
                        spec_scheduler=spec_pool)


def stop_backend(backend) -> None:
    backend.scheduler.stop()
    for pool in (backend.continuous_scheduler, backend.spec_scheduler):
        if pool is not None:
            pool.stop()


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    backend = create_backend(args)

    from whisperlive_tpu_torch.serving.server import TranscriptionServer

    server = TranscriptionServer()
    server.raw_pcm_default = args.raw_pcm_input
    try:
        server.run(
            backend,
            host=args.host,
            port=args.port,
            backend_name="torch",
            max_clients=args.max_clients,
            max_connection_time=args.max_connection_time,
            api_key=args.api_key,
            metrics_port=args.metrics_port,
        )
    finally:
        stop_backend(backend)


if __name__ == "__main__":
    main()
