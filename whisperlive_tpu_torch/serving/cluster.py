"""Multi-replica serving scale-out: a WebSocket front end routing sessions
across N TranscriptionServer replicas.

Port of whisperlive_tpu/serving/cluster.py (host code, kept as the port's
own copy). One server caps its clients and answers WAIT when full; a
deployment of N replicas (each a dp x tp world of ranks on its own cards,
possibly on other hosts) wants one stable endpoint in front of them. This
router provides it:

  * sessions are STICKY by uid via rendezvous (highest-random-weight)
    hashing: a reconnecting client lands on the replica that still holds
    its context, and a replica failure reshuffles only that replica's
    sessions;
  * the wire protocol is untouched: the router reads exactly one frame
    (the handshake, to learn the uid) and then relays opaquely in both
    directions, so every client works unmodified;
  * capacity WAITs fail over: if the chosen replica answers
    {"status": "WAIT"}, the router retries the next-ranked healthy
    replica and only surfaces a WAIT to the client when the whole fleet
    is full;
  * replica health is probed in the background; dial failures mark a
    replica down at once, and down replicas rank last until a probe
    succeeds again.

The router holds no model state and does almost no work per frame, so
one asyncio process fronts many engine replicas; run several routers
behind DNS or a virtual IP for router redundancy. `websockets` is
imported only inside the functions that open a connection (the card's
machine has none).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import time
from typing import Optional, Sequence

logger = logging.getLogger(__name__)

# frames buffered per session while replicas are being probed (the client
# streams ~4 frames/s of ~16 KB; 256 bounds worst-case memory per session)
MAX_STASHED_FRAMES = 256
ACCEPT_TIMEOUT_S = 15.0


class Replica:
    def __init__(self, addr: str):
        self.addr = addr  # "host:port"
        self.healthy = True
        self.sessions = 0
        self.last_error: Optional[str] = None
        self.last_probe_s = 0.0

    def uri(self, query: str = "") -> str:
        return f"ws://{self.addr}/{query}"


def _hrw_score(uid: str, addr: str) -> int:
    """Rendezvous weight: deterministic, uniform, no shared ring state."""
    return int.from_bytes(
        hashlib.md5(f"{uid}\x00{addr}".encode()).digest()[:8], "big"
    )


class ClusterRouter:
    def __init__(
        self,
        backends: Sequence[str],
        health_interval_s: float = 5.0,
        accept_timeout_s: float = ACCEPT_TIMEOUT_S,
    ):
        if not backends:
            raise ValueError("ClusterRouter needs at least one backend")
        self.replicas = [Replica(a) for a in backends]
        self.health_interval_s = health_interval_s
        self.accept_timeout_s = accept_timeout_s
        self._health_task: Optional[asyncio.Task] = None
        self._shutdown: Optional[asyncio.Event] = None

    def request_shutdown(self) -> None:
        """Ask a running serve() to exit cleanly (call on the serving loop;
        from another thread use loop.call_soon_threadsafe)."""
        if self._shutdown is not None:
            self._shutdown.set()

    # ------------------------------------------------------------------

    def rank(self, uid: str) -> list[Replica]:
        """All replicas, preferred-first: healthy before unhealthy, then
        by rendezvous weight (sticky per uid, stable under fleet changes)."""
        return sorted(
            self.replicas,
            key=lambda r: (not r.healthy, -_hrw_score(uid, r.addr)),
        )

    def status(self) -> dict:
        return {
            "backends": [
                {
                    "addr": r.addr,
                    "healthy": r.healthy,
                    "sessions": r.sessions,
                    "last_error": r.last_error,
                }
                for r in self.replicas
            ]
        }

    # ------------------------------------------------------------------

    async def _probe(self, replica: Replica) -> None:
        """Healthy replicas get a cheap TCP liveness check; UNHEALTHY ones
        are revived only by a full WebSocket handshake — a wedged process
        whose listener backlog still accepts TCP (the classic hang mode)
        must not be re-marked healthy every probe interval and put back at
        the front of every sticky session's rank order."""
        host, port = replica.addr.rsplit(":", 1)
        try:
            if replica.healthy:
                _, writer = await asyncio.wait_for(
                    asyncio.open_connection(host, int(port)), timeout=2.0
                )
                writer.close()
                try:
                    await writer.wait_closed()
                except Exception:
                    pass
            else:
                conn = await asyncio.wait_for(
                    connect(replica.uri(""), max_size=2**20), timeout=3.0
                )
                await conn.close()
                logger.info("backend %s back up", replica.addr)
            replica.healthy = True
            replica.last_error = None
        except Exception as e:
            if replica.healthy:
                logger.warning("backend %s down: %s", replica.addr, e)
            replica.healthy = False
            replica.last_error = str(e)
        replica.last_probe_s = time.monotonic()

    async def _health_loop(self) -> None:
        while True:
            await asyncio.gather(*(self._probe(r) for r in self.replicas))
            await asyncio.sleep(self.health_interval_s)

    # ------------------------------------------------------------------

    @staticmethod
    def _is_wait(msg) -> Optional[dict]:
        """Parse a backend frame; return the dict iff it is a capacity
        WAIT status (server.py WAIT semantics)."""
        if isinstance(msg, (bytes, bytearray)):
            return None
        try:
            d = json.loads(msg)
        except Exception:
            return None
        return d if isinstance(d, dict) and d.get("status") == "WAIT" else None

    async def _dial(self, replica: Replica, query: str, auth: Optional[str]):
        from websockets.asyncio.client import connect

        headers = {"Authorization": auth} if auth else None
        return await asyncio.wait_for(
            connect(
                replica.uri(query), additional_headers=headers, max_size=2**24
            ),
            timeout=5.0,
        )

    async def handle(self, websocket) -> None:
        """Per-connection entry point (handed to websockets.serve)."""
        try:
            handshake = await asyncio.wait_for(
                websocket.recv(), timeout=self.accept_timeout_s
            )
        except Exception:
            return
        try:
            uid = json.loads(handshake).get("uid", "")
        except Exception:
            uid = ""
        # forward the query string (?token=...) and Authorization header so
        # per-replica auth keeps working through the router
        req = getattr(websocket, "request", None)
        path = getattr(req, "path", "") or ""
        query = "?" + path.split("?", 1)[1] if "?" in path else ""
        auth = None
        try:
            auth = req.headers.get("Authorization") or None
        except Exception:
            pass

        stash: list = []  # client frames buffered while probing replicas
        accepted = None  # (replica, conn, first_backend_msg)
        waiting: list[tuple[Replica, dict]] = []
        for replica in self.rank(uid):
            try:
                conn = await self._dial(replica, query, auth)
            except Exception as e:
                replica.healthy = False
                replica.last_error = str(e)
                continue
            try:
                await conn.send(handshake)
                first = await self._await_accept(websocket, conn, stash)
            except Exception as e:
                # dialed fine but never served the handshake: demote it so
                # rank() stops putting a wedged replica first; only a full
                # WS-handshake probe (_probe, unhealthy path) revives it
                replica.healthy = False
                replica.last_error = f"accept failed: {e}"
                await self._close(conn)
                continue
            wait = self._is_wait(first)
            if wait is None:
                accepted = (replica, conn, first)
                break
            waiting.append((replica, wait))
            await self._close(conn)

        if accepted is None and waiting:
            # whole fleet is full: surface the smallest WAIT and park the
            # session on that replica (its queue admits the client first)
            replica = min(waiting, key=lambda rw: self._wait_minutes(rw[1]))[0]
            try:
                conn = await self._dial(replica, query, auth)
                await conn.send(handshake)
                accepted = (replica, conn, None)
            except Exception:
                accepted = None
        if accepted is None:
            try:
                await websocket.send(
                    json.dumps(
                        {"uid": uid, "status": "ERROR",
                         "message": "no backend available"}
                    )
                )
            except Exception:
                pass
            return

        replica, conn, first = accepted
        replica.sessions += 1
        try:
            if first is not None:
                await websocket.send(first)
            for frame in stash:
                await conn.send(frame)
            await self._relay(websocket, conn)
        finally:
            replica.sessions -= 1
            await self._close(conn)

    @staticmethod
    def _wait_minutes(wait_msg: dict) -> float:
        try:
            return float(wait_msg.get("message", 1e9))
        except (TypeError, ValueError):
            return 1e9

    async def _await_accept(self, client_ws, backend_ws, stash: list):
        """Wait for the backend's first post-handshake frame, buffering any
        client frames that arrive meanwhile (they are replayed only to the
        replica that accepts, so a WAIT-then-failover loses no audio)."""
        client_next = asyncio.ensure_future(client_ws.recv())
        try:
            while True:
                backend_next = asyncio.ensure_future(backend_ws.recv())
                done, _ = await asyncio.wait(
                    {client_next, backend_next},
                    timeout=self.accept_timeout_s,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if backend_next in done:
                    if client_next in done:
                        stash.append(client_next.result())
                        client_next = None
                    return backend_next.result()
                backend_next.cancel()
                if client_next in done:
                    if len(stash) >= MAX_STASHED_FRAMES:
                        raise ConnectionError("stash overflow while probing")
                    stash.append(client_next.result())
                    client_next = asyncio.ensure_future(client_ws.recv())
                else:
                    raise TimeoutError("backend never replied to handshake")
        finally:
            # Invariant this cleanup relies on: the websockets library's
            # recv() is cancellation-safe — a cancelled recv never consumes
            # a frame (messages stay queued until returned), so the one
            # pending read can always be dropped here without loss.
            if client_next is not None:
                if client_next.done():
                    try:
                        stash.append(client_next.result())
                    except Exception:
                        pass
                else:
                    client_next.cancel()

    @staticmethod
    async def _pump(src, dst) -> None:
        async for msg in src:
            await dst.send(msg)

    async def _relay(self, client_ws, backend_ws) -> None:
        a = asyncio.ensure_future(self._pump(client_ws, backend_ws))
        b = asyncio.ensure_future(self._pump(backend_ws, client_ws))
        try:
            done, pending = await asyncio.wait(
                {a, b}, return_when=asyncio.FIRST_COMPLETED
            )
            for t in pending:
                t.cancel()
            for t in done:
                exc = t.exception()
                if exc is not None and not isinstance(
                    exc, asyncio.CancelledError
                ):
                    logger.debug("relay ended: %s", exc)
        finally:
            for t in (a, b):
                if not t.done():
                    t.cancel()

    @staticmethod
    async def _close(conn) -> None:
        try:
            await conn.close()
        except Exception:
            pass

    # ------------------------------------------------------------------

    async def serve(self, host: str = "0.0.0.0", port: int = 9090) -> None:
        from websockets.asyncio.server import serve as ws_serve

        await asyncio.gather(*(self._probe(r) for r in self.replicas))
        self._health_task = asyncio.create_task(self._health_loop())
        self._shutdown = asyncio.Event()
        try:
            async with ws_serve(
                self.handle, host, port, max_size=2**24
            ) as server:
                logger.info(
                    "cluster router on %s:%d -> %s",
                    host, port, [r.addr for r in self.replicas],
                )
                # explicit shutdown event instead of serve_forever() —
                # see TranscriptionServer.serve for why (clean teardown
                # from test harnesses without loop-close unraisables).
                try:
                    await self._shutdown.wait()
                finally:
                    server.close()
        finally:
            self._health_task.cancel()

    def run(self, *args, **kwargs) -> None:
        asyncio.run(self.serve(*args, **kwargs))
