"""WebSocket server on the port.

    python -m whisperlive_tpu_torch.cli.run_server --model large-v3 --port 9090

Builds random weights from --seed (the repository holds no checkpoint;
loading converted checkpoints is ROADMAP.md open item 11), a WhisperEngine
on --device (CUDA by default; a missing card is an error), the window
BatchScheduler and, by default, the continuous slot scheduler, warms both
up, and serves through the port's TranscriptionServer with a TorchBackend.
Port of whisperlive_tpu/cli/run_server.py without multi-host, speculative
and beam serving; --no_continuous_batching serves the window path alone.
"""

from __future__ import annotations

import argparse
import logging

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

    device = resolve_device(args.device)
    cfg = WHISPER_CONFIGS[args.model]
    params = init_params(cfg, args.seed, default_compute_dtype(device), device)
    engine = WhisperEngine(cfg, params, device=device)
    del params
    if not args.no_warmup:
        engine.warmup(
            batch_sizes={b for b in engine.batch_buckets if b <= args.batch_max_size}
        )
    scheduler = BatchScheduler(
        engine, max_batch_size=args.batch_max_size, batch_window_ms=args.batch_window_ms
    )
    scheduler.start()
    continuous = None
    if args.continuous_batching:
        from whisperlive_tpu_torch.engine.continuous import ContinuousScheduler

        continuous = ContinuousScheduler(
            engine, n_slots=args.continuous_slots, steps_per_chunk=args.steps_per_chunk,
            cross_ctx=args.continuous_cross_ctx,
        )
        if not args.no_warmup:
            continuous.warmup()
        continuous.start()
    return TorchBackend(scheduler, model_name=args.model, continuous_scheduler=continuous)


def stop_backend(backend) -> None:
    backend.scheduler.stop()
    if backend.continuous_scheduler is not None:
        backend.continuous_scheduler.stop()


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    backend = create_backend(args)

    from whisperlive_tpu_torch.serving.server import TranscriptionServer

    try:
        TranscriptionServer().run(
            backend,
            host=args.host,
            port=args.port,
            backend_name="torch",
            max_clients=args.max_clients,
            max_connection_time=args.max_connection_time,
        )
    finally:
        stop_backend(backend)


if __name__ == "__main__":
    main()
