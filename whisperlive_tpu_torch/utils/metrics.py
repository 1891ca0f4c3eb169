"""Prometheus metrics (API-compatible with whisper_live/metrics.py).

Same collector set and call-site contract as the reference (§2.18):
connection counters, a transcription-latency histogram, audio-seconds and
segment counters, REST request/error counters — all silently no-op when
prometheus_client is unavailable (metrics.py:59-65), plus collectors the
reference has no equivalent for: the batch-occupancy histogram, the
active-streams gauge and the speculative decoder's acceptance gauge and
window counter. The span log and device clock of utils/profiling.py hold
where a request's and a batch's time goes.

The port's copy of whisperlive_tpu/utils/metrics.py. Its collectors live in
a registry of their own (REGISTRY, served by start_metrics_server), so the
port and the JAX package can both be imported in one process without
registering the same metric names twice.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

try:
    from prometheus_client import (
        CollectorRegistry, Counter, Gauge, Histogram, start_http_server,
    )

    _AVAILABLE = True
except ImportError:  # pragma: no cover
    _AVAILABLE = False

if _AVAILABLE:
    REGISTRY = CollectorRegistry()
    CONNECTIONS_TOTAL = Counter(
        "whisperlive_connections_total", "Total WebSocket connections accepted",
        registry=REGISTRY,
    )
    CONNECTIONS_ACTIVE = Gauge(
        "whisperlive_connections_active", "Currently active WebSocket connections",
        registry=REGISTRY,
    )
    CONNECTIONS_REJECTED = Counter(
        "whisperlive_connections_rejected_total", "Connections rejected (server full)",
        registry=REGISTRY,
    )
    TRANSCRIPTION_LATENCY = Histogram(
        "whisperlive_transcription_latency_seconds",
        "Latency of one transcription call",
        buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0),
        registry=REGISTRY,
    )
    AUDIO_SECONDS = Counter(
        "whisperlive_audio_seconds_total", "Seconds of audio processed",
        registry=REGISTRY,
    )
    SEGMENTS_EMITTED = Counter(
        "whisperlive_segments_emitted_total",
        "Transcript segments emitted",
        ["completed"],
        registry=REGISTRY,
    )
    REST_REQUESTS = Counter(
        "whisperlive_rest_requests_total", "REST API requests", ["endpoint", "status"],
        registry=REGISTRY,
    )
    ERRORS = Counter("whisperlive_errors_total", "Errors by type", ["type"], registry=REGISTRY)
    BATCH_OCCUPANCY = Histogram(
        "whisperlive_batch_occupancy",
        "Requests per device batch",
        buckets=(1, 2, 4, 8, 16, 32),
        registry=REGISTRY,
    )
    ACTIVE_STREAMS = Gauge(
        "whisperlive_active_streams", "Sessions currently streaming audio",
        registry=REGISTRY,
    )
    SPEC_ACCEPTANCE = Gauge(
        "whisperlive_speculative_acceptance",
        "Cumulative draft-token acceptance rate of the speculative decoder",
        registry=REGISTRY,
    )
    SPEC_WINDOWS = Counter(
        "whisperlive_speculative_windows_total",
        "Windows decoded through the speculative route",
        registry=REGISTRY,
    )


def metrics_available() -> bool:
    return _AVAILABLE


def start_metrics_server(port: int) -> bool:
    if not _AVAILABLE:
        logger.warning("prometheus_client not installed; metrics disabled")
        return False
    start_http_server(port, registry=REGISTRY)
    logger.info("metrics server on :%d/metrics", port)
    return True


def track_connection_accepted() -> None:
    if _AVAILABLE:
        CONNECTIONS_TOTAL.inc()
        CONNECTIONS_ACTIVE.inc()


def track_connection_closed() -> None:
    if _AVAILABLE:
        CONNECTIONS_ACTIVE.dec()


def track_connection_rejected() -> None:
    if _AVAILABLE:
        CONNECTIONS_REJECTED.inc()


def track_transcription_latency(seconds: float) -> None:
    if _AVAILABLE:
        TRANSCRIPTION_LATENCY.observe(seconds)


def track_audio_seconds(seconds: float) -> None:
    if _AVAILABLE:
        AUDIO_SECONDS.inc(max(seconds, 0.0))


def track_segments(n: int, completed: bool) -> None:
    if _AVAILABLE and n:
        SEGMENTS_EMITTED.labels(completed=str(completed).lower()).inc(n)


def track_rest_request(endpoint: str, status: int) -> None:
    if _AVAILABLE:
        REST_REQUESTS.labels(endpoint=endpoint, status=str(status)).inc()


def track_error(error_type: str) -> None:
    if _AVAILABLE:
        ERRORS.labels(type=error_type).inc()


def track_batch_occupancy(n: int) -> None:
    if _AVAILABLE:
        BATCH_OCCUPANCY.observe(n)


def set_active_streams(n: int) -> None:
    if _AVAILABLE:
        ACTIVE_STREAMS.set(n)


def track_speculative_window(acceptance_rate: float) -> None:
    if _AVAILABLE:
        SPEC_WINDOWS.inc()
        SPEC_ACCEPTANCE.set(acceptance_rate)
