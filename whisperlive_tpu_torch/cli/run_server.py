"""WebSocket server on the port's window-scheduler path.

    python -m whisperlive_tpu_torch.cli.run_server --model large-v3 --port 9090

Builds random weights from --seed (the repository holds no checkpoint;
loading converted checkpoints is ROADMAP.md open item 11), a WhisperEngine
on --device (CUDA by default; a missing card is an error), warms the
serving path up, and serves through whisperlive_tpu.serving.server's
TranscriptionServer with a TorchBackend. Port of the --no_continuous_batching
configuration of whisperlive_tpu/cli/run_server.py.
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
    parser.add_argument("--max_clients", type=int, default=4,
                        help="Maximum concurrent client connections.")
    parser.add_argument("--max_connection_time", type=int, default=600,
                        help="Per-client connection time budget in seconds.")
    parser.add_argument("--no_warmup", action="store_true",
                        help="Skip the warm-up decodes (and kernel build) at startup.")
    return parser


def create_backend(args):
    """Engine, started scheduler and backend from the CLI flags."""
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
    return TorchBackend(scheduler, model_name=args.model)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    backend = create_backend(args)

    from whisperlive_tpu.serving.server import TranscriptionServer

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
        backend.scheduler.stop()


if __name__ == "__main__":
    main()
