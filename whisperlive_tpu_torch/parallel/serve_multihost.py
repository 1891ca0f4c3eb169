"""Multi-process SERVING of one sliced continuous engine: op replay.

Port of whisperlive_tpu/parallel/serve_multihost.py. Every rank of the
[dp, tp] grid (parallel/mesh.py) is a process, and a tensor-parallel op
only completes when every rank of its model group enters the same
collectives in the same order. A server is not SPMD by nature: exactly one
process holds the WebSocket and REST connections, the sessions and the
scheduler's data-dependent decisions about which request lands in which
slot at which tick.

The op log squares that. The LEADER (rank 0) runs the real server and the
`ContinuousScheduler`; every device op the scheduler performs on the slot
pool (init_state / insert / step / release / harvest_all / harvest /
align) is published over a TCP byte stream to every FOLLOWER rank before
the leader runs it. Followers run `run_follower`, a loop that reads each
op and replays it on their own identically built engine, so every rank
runs the same ops with the same host arguments in the same order. The
reads the leader needs from other ranks (the status plane, a harvested
row, an alignment pass, a wave's language probabilities) are gathers or
broadcasts over the data group inside those ops (engine/continuous.py),
which every rank enters at the same point of the stream; a follower
discards its copy.

Word timestamps ride it too: the scheduler dispatches the alignment pass
from its worker thread at harvest (the "align" op, a fixed position in the
stream) and hands only the host DTW to the assemble thread.

Trust model: the op channel carries pickled numpy and scalar payloads
between the deployment's own ranks, and unpickling attacker bytes is code
execution, so the channel is authenticated BEFORE any pickle flows: each
side presents an HMAC-SHA256 digest keyed by the shared secret
(WL_OPS_SECRET, the same environment contract as WL_COORDINATOR). The
leader rejects unauthenticated followers (a squatter can neither take a
follower slot nor receive the op stream, which carries every session's
audio), and a follower refuses a leader that cannot prove the key. The
digests are fixed-length raw bytes, so nothing is unpickled before the
handshake. Bind the leader on the deployment's internal interface
(run_server defaults to the WL_COORDINATOR host), never a public one.

Usage (every rank, after multihost.init_multihost; see cli/run_server.py):

    sh = multihost.multihost_shardings(tp=2)
    eng = WhisperEngine(cfg, params, shardings=sh)
    if multihost.is_primary():
        leader = OpLeader(port, n_followers=world - 1)
        cb = MultihostContinuousEngine(eng, leader=leader, n_slots=16)
        sched = ContinuousScheduler(eng, cb=cb)
        sched.start(); ... serve ...; sched.stop()
        cb.stop_followers()
    else:
        cb = MultihostContinuousEngine(eng, n_slots=16)
        run_follower(cb, OpFollower(("leader-host", port)))
"""

from __future__ import annotations

import hashlib
import hmac
import logging
import os
import pickle
import socket
import struct
import time
from typing import Optional

import numpy as np

from whisperlive_tpu_torch.engine.continuous import ContinuousEngine
from whisperlive_tpu_torch.parallel.mesh import params_fingerprint  # noqa: F401

logger = logging.getLogger(__name__)

_HDR = struct.Struct("<I")  # frame = u32 length + pickle payload

# --- channel authentication (pre-pickle, fixed-length raw bytes) -------

_AUTH_LEN = hashlib.sha256().digest_size


def ops_secret() -> bytes:
    """Shared op-channel secret (WL_OPS_SECRET on every rank). An empty
    secret still runs the handshake (the digests must match) but gives no
    protection against an attacker who knows the protocol: warn."""
    secret = os.environ.get("WL_OPS_SECRET", "")
    if not secret:
        logger.warning(
            "WL_OPS_SECRET is not set: the multi-process op channel is "
            "unauthenticated; anyone reaching the leader port can join "
            "as a follower (receiving all session audio) or squat the "
            "port and feed followers pickles. Set the same secret on "
            "every host."
        )
    return secret.encode()


def _auth_digest(secret: bytes, role: str) -> bytes:
    return hmac.new(secret, f"wl-ops-{role}-v1".encode(), hashlib.sha256).digest()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("op-log peer closed during auth")
        buf.extend(chunk)
    return bytes(buf)


class OpLeader:
    """Leader side of the op log: accepts follower connections, then
    broadcasts each (op, payload) frame to all of them in call order.
    TCP keeps each connection's order, the only order the replay needs."""

    def __init__(
        self,
        port: int,
        n_followers: int,
        host: str = "127.0.0.1",
        accept_timeout_s: float = 120.0,
        secret: Optional[bytes] = None,
    ):
        if secret is None:
            secret = ops_secret()
        self._srv = socket.create_server((host, port), backlog=max(n_followers, 1))
        self._srv.settimeout(accept_timeout_s)
        self.conns: list[socket.socket] = []
        # frames and bytes published (the op log's per-tick cost)
        self.stats = {"ops": 0, "bytes": 0}
        deadline = time.monotonic() + accept_timeout_s
        want = _auth_digest(secret, "follower")
        reply = _auth_digest(secret, "leader")
        while len(self.conns) < n_followers:
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"only {len(self.conns)}/{n_followers} followers "
                    "authenticated before the accept deadline"
                )
            conn, addr = self._srv.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # auth BEFORE the connection takes a follower slot: the peer
            # must present the follower digest within a short window, or a
            # port scanner would both stall the real follower and receive
            # every session's audio
            try:
                conn.settimeout(10.0)
                got = _recv_exact(conn, _AUTH_LEN)
                if not hmac.compare_digest(got, want):
                    raise ConnectionError("bad follower auth digest")
                conn.sendall(reply)  # prove the leader knows the key too
                conn.settimeout(None)
            except (OSError, ConnectionError) as e:
                logger.warning("rejecting unauthenticated op-log connection from %s: %s",
                               addr, e)
                conn.close()
                continue
            self.conns.append(conn)
            logger.info("op-log follower authenticated from %s", addr)

    def publish(self, op: str, payload=None) -> None:
        frame = pickle.dumps((op, payload), protocol=pickle.HIGHEST_PROTOCOL)
        msg = _HDR.pack(len(frame)) + frame
        for conn in self.conns:
            conn.sendall(msg)
        self.stats["ops"] += 1
        self.stats["bytes"] += len(msg)

    def close(self) -> None:
        for conn in self.conns:
            try:
                conn.close()
            except OSError:
                pass
        self._srv.close()


class OpFollower:
    """Follower side: connects (with retry: the leader may bind late) and
    yields ops in publication order."""

    def __init__(
        self,
        addr: tuple[str, int],
        connect_timeout_s: float = 120.0,
        secret: Optional[bytes] = None,
    ):
        if secret is None:
            secret = ops_secret()
        deadline = time.monotonic() + connect_timeout_s
        while True:
            try:
                self._sock = socket.create_connection(addr, timeout=10.0)
                # mutual auth before ANY pickle is read: present the
                # follower digest, then require the leader digest back; a
                # rejection retries like a refused connect (the real
                # leader may not be up yet)
                self._sock.settimeout(10.0)
                self._sock.sendall(_auth_digest(secret, "follower"))
                got = _recv_exact(self._sock, _AUTH_LEN)
                if not hmac.compare_digest(got, _auth_digest(secret, "leader")):
                    raise ConnectionError("op-log leader failed auth")
                break
            except (OSError, ConnectionError):
                try:
                    self._sock.close()
                except Exception:
                    pass
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(None)  # ops arrive whenever the leader acts

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("op-log leader closed the channel")
            buf.extend(chunk)
        return bytes(buf)

    def next(self) -> tuple[str, object]:
        (length,) = _HDR.unpack(self._read_exact(_HDR.size))
        return pickle.loads(self._read_exact(length))

    def close(self) -> None:
        self._sock.close()


def engine_signature(cb: ContinuousEngine) -> dict:
    """Everything that must match for two ranks' engines to run the same
    ops from the same payloads: geometry, quantization, the grid, and a
    weight fingerprint (the same host bytes through the same ops still
    serve garbage if the weights differ)."""
    sh = cb.shardings
    return {
        "params_fp": getattr(cb, "_params_fp", None),
        "n_slots": cb.n_slots,
        "prompt_pad": cb.prompt_pad,
        "ring": cb.ring,
        "steps_per_chunk": cb.steps_per_chunk,
        "beam_width": cb.beam_width,
        "spec_k": cb.spec_k,
        "enc_buckets": tuple(cb.enc_buckets),
        "cross_ctx": cb.cross_ctx,
        "cache_len": cb.cache_len,
        "dp_sharded": cb.dp_sharded,
        "dp": sh.dp if sh is not None else 1,
        "tp": sh.tp if sh is not None else 1,
        "cross_kv_bits": cb.eng.cross_kv_bits,
        "decoder_int8": cb.eng.decoder_int8,
        "n_vocab": cb.eng.cfg.n_vocab,
        "n_audio_ctx": cb.eng.cfg.n_audio_ctx,
        "n_text_layer": cb.eng.cfg.n_text_layer,
    }


class MultihostContinuousEngine(ContinuousEngine):
    """ContinuousEngine whose device ops are published to follower ranks.

    Build it the same way on every rank (the same WhisperEngine weights,
    seeds and pool geometry: `engine_signature` is checked at the
    handshake). On the leader pass `leader=OpLeader(...)`; followers pass
    nothing and replay through `run_follower`."""

    multihost = True

    def __init__(self, *args, leader: Optional[OpLeader] = None, **kwargs):
        self._leader = None  # _pub inert while the base class constructs
        super().__init__(*args, **kwargs)
        if self.shardings is None:
            raise ValueError(
                "multi-process serving needs a sharded engine "
                "(WhisperEngine(..., shardings=multihost_shardings(...)))"
            )
        self._params_fp = self.eng.params_fp
        if self.draft is not None:
            self._params_fp = self._params_fp + self.draft.params_fp
        self._leader = leader
        if leader is not None:
            leader.publish("hello", engine_signature(self))

    # -- publication ---------------------------------------------------

    def _pub(self, op: str, payload=None) -> None:
        if self._leader is not None:
            self._leader.publish(op, payload)

    def stop_followers(self) -> None:
        """End every follower's replay loop and close the channel."""
        if self._leader is not None:
            self._leader.publish("stop")
            self._leader.close()
            self._leader = None

    # -- device ops (publish, then run the shared implementation) ------

    def init_state(self, seed: int = 0) -> None:
        self._pub("init_state", seed)
        super().init_state(seed)

    def insert(self, *args, **kwargs):
        self._pub("insert", (args, kwargs))
        return super().insert(*args, **kwargs)

    def step(self) -> np.ndarray:
        self._pub("step")
        return super().step()

    def release(self, slot_ids: list[int]) -> None:
        self._pub("release", list(slot_ids))
        super().release(slot_ids)

    def harvest_all(self) -> np.ndarray:
        self._pub("harvest_all")
        return super().harvest_all()

    def harvest(self, slot: int, join_step: int, gen_len: int, lane: int = 0) -> np.ndarray:
        self._pub("harvest", (slot, join_step, gen_len, lane))
        return super().harvest(slot, join_step, gen_len, lane)

    def align_fetch(self, slot, tokens_arr, cross_len, seq_len, num_frames):
        # dispatched from the scheduler's worker thread at harvest, a fixed
        # position in the stream on every rank
        self._pub("align", (slot, np.asarray(tokens_arr), int(cross_len), int(seq_len),
                            int(num_frames)))
        return super().align_fetch(slot, tokens_arr, cross_len, seq_len, num_frames)


_REPLAYED = ("init_state", "insert", "step", "release", "harvest_all", "harvest", "align")


def run_follower(engine: MultihostContinuousEngine, chan: OpFollower) -> int:
    """Replay the leader's op stream on this rank's engine. Blocks until the
    leader publishes "stop" (returns the op count) or the channel breaks
    (raises). The engine must be built exactly as the leader's: the first
    frame is a signature handshake."""
    op, sig = chan.next()
    if op != "hello":
        raise RuntimeError(f"op-log stream must start with hello, got {op!r}")
    mine = engine_signature(engine)
    if sig != mine:
        diff = {k: (sig.get(k), mine.get(k)) for k in set(sig) | set(mine)
                if sig.get(k) != mine.get(k)}
        raise RuntimeError(f"engine signature mismatch with leader: {diff}")
    n = 0
    while True:
        op, payload = chan.next()
        n += 1
        if op == "stop":
            logger.info("op-log follower replayed %d ops", n - 1)
            return n - 1
        if op not in _REPLAYED:
            # NOT recoverable: an unknown opcode means a protocol mismatch,
            # and going on would replay a desynced stream
            raise RuntimeError(f"unknown op-log opcode {op!r}")
        # Error parity with the leader: its scheduler catches op exceptions
        # and keeps serving (a failed insert fails its requests, the worker
        # loop's catch-all releases the slots; both publish their own ops,
        # which arrive next here). A deterministic op failure raises here
        # too and must be survived the same way, or this rank dies and the
        # leader's next collective hangs the world.
        try:
            if op == "init_state":
                engine.init_state(payload)
            elif op == "insert":
                args, kwargs = payload
                engine.insert(*args, **kwargs)
            elif op == "step":
                engine.step()
            elif op == "release":
                engine.release(payload)
            elif op == "harvest_all":
                engine.harvest_all()
            elif op == "harvest":
                engine.harvest(*payload)
            else:
                engine.align_fetch(*payload)
        except Exception:
            logger.exception("op-log replay of %r failed (continuing: the leader's "
                             "scheduler survives the same failure)", op)
