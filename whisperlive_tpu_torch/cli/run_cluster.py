"""Cluster-router CLI: one stable WebSocket endpoint in front of N
TranscriptionServer replicas (serving/cluster.py).

    whisperlive-tpu-torch-server --port 9191 ...   # replica A (its own cards)
    whisperlive-tpu-torch-server --port 9192 ...   # replica B
    whisperlive-tpu-torch-cluster --port 9090 --backends localhost:9191,localhost:9192

Clients connect to :9090 unchanged. Port of whisperlive_tpu/cli/run_cluster.py.
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="whisperlive-tpu-torch cluster router")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", "-p", type=int, default=9090)
    parser.add_argument(
        "--backends", type=str, required=True,
        help="Comma-separated replica addresses, e.g. "
             "'host1:9090,host2:9090'. Sessions are sticky by uid "
             "(rendezvous hashing) with failover to healthy replicas.",
    )
    parser.add_argument(
        "--health_interval", type=float, default=5.0,
        help="Seconds between replica health probes.",
    )
    return parser


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    from whisperlive_tpu_torch.serving.cluster import ClusterRouter

    router = ClusterRouter(
        [a.strip() for a in args.backends.split(",") if a.strip()],
        health_interval_s=args.health_interval,
    )
    router.run(host=args.host, port=args.port)


if __name__ == "__main__":
    main()
