"""Multi-process SERVING of one sliced engine: op replay.

Port of whisperlive_tpu/parallel/serve_multihost.py. Every rank of the
[dp, tp] grid (parallel/mesh.py) is a process, and a tensor-parallel op
only completes when every rank of its model group enters the same
collectives in the same order. A server is not SPMD by nature: exactly one
process holds the WebSocket and REST connections, the sessions and the
schedulers' data-dependent decisions about which request lands in which
slot or window batch at which tick.

The op log squares that. The LEADER (rank 0) runs the real server and its
schedulers; every device op they perform is published over a TCP byte
stream to every FOLLOWER rank and run on the leader under one world-wide
dispatch lock (OpLeader.dispatch), so the stream's order is the order of
execution even though the continuous and the window scheduler dispatch
from two threads. Followers run `run_follower`, one loop on one thread
that reads each op and replays it on its identically built copy of the
op's target, so every rank runs the same ops with the same host arguments
in the same order. The targets of one stream, each op tagged with its
name:

  "main" / "spec"  a MultihostContinuousEngine: the serving slot pool and
                   the mixed mode's speculative pool (init_state / insert /
                   step / release / harvest_all / harvest / align)
  "window"         a MultihostWindowEngine: the window scheduler's engine
                   calls (prepare, language ID, transcribe_batch,
                   decode_with_fallback, gather_cross, the alignment pass)
                   and its SpeculativeDecoder's; device results stay on
                   every rank under the op's id (Handle) and a "free" op
                   drops them when the batch ends

The reads the leader needs from other ranks (the status plane, a
harvested row, an alignment pass's heads, a wave's language
probabilities) are gathers or broadcasts over the model or data group
inside those ops, which every rank enters at the same point of the
stream; a follower discards its copy. Under dp > 1 every replica runs a
window op whole (the window batch is not split over the data group).

Locks are taken in one order: the dispatch lock, then the engine's own.
A chunked beam decode (engine.py `_decode_beam`) releases the engine's
lock between segments but stays inside its op, so it holds the dispatch
order for the whole beamed decode: the continuous pool waits for it.

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

Usage (every rank, after multihost.init_multihost; see cli/run_server.py,
whose create_backend builds the same targets on every rank):

    sh = multihost.multihost_shardings(tp=2)
    eng = WhisperEngine(cfg, params, shardings=sh)
    if multihost.is_primary():
        leader = OpLeader(port, n_followers=world - 1)
        window = MultihostWindowEngine(eng, leader=leader)
        cb = MultihostContinuousEngine(eng, leader=leader, n_slots=16)
        sched, cs = MultihostBatchScheduler(window), ContinuousScheduler(eng, cb=cb)
        sched.start(); cs.start(); ... serve ...; sched.stop(); cs.stop()
        leader.stop()
    else:
        chan = OpFollower(("leader-host", port))
        run_follower({"window": MultihostWindowEngine(eng),
                      "main": MultihostContinuousEngine(eng, n_slots=16)}, chan)
"""

from __future__ import annotations

import contextlib
import hashlib
import hmac
import itertools
import logging
import os
import pickle
import socket
import struct
import threading
import time
from typing import Optional

import numpy as np
import torch

from whisperlive_tpu_torch.engine.continuous import ContinuousEngine
from whisperlive_tpu_torch.engine.scheduler import BatchScheduler
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
    TCP keeps each connection's order, the only order the replay needs.
    The targets that publish here register first; the first op sends the
    "hello" handshake with every target's signature."""

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
        # the world-wide dispatch lock: an op is published and run on this
        # rank under it, so the stream's order is the order of execution
        self.lock = threading.RLock()
        self.targets: dict = {}
        self._greeted = False
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

    def register(self, name: str, target) -> None:
        """Add a target (anything with `signature()`) to the handshake;
        every target registers before the first op."""
        if self._greeted:
            raise RuntimeError(f"target {name!r} registered after the op log's handshake")
        if name in self.targets:
            raise ValueError(f"op-log target {name!r} registered twice")
        self.targets[name] = target

    @contextlib.contextmanager
    def dispatch(self, target: str, op: str, payload=None):
        """Publish `target.op` and hold the dispatch lock while the caller
        runs it on this rank."""
        with self.lock:
            self._greet()
            self.publish(f"{target}.{op}", payload)
            yield

    def _greet(self) -> None:
        if not self._greeted:
            self.publish("hello", {n: t.signature() for n, t in self.targets.items()})
            self._greeted = True

    def stop(self) -> None:
        """End every follower's replay loop (after the op in flight) and
        close the channel."""
        with self.lock:
            if self._srv is None:
                return
            self._greet()
            self.publish("stop")
            self.close()

    def close(self) -> None:
        for conn in self.conns:
            try:
                conn.close()
            except OSError:
                pass
        if self._srv is not None:
            self._srv.close()
            self._srv = None


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


class ReplayError(RuntimeError):
    """A protocol fault of the op stream (an unknown target, op or handle):
    the follower stops, since going on would replay a desynced stream."""


def engine_signature(cb: ContinuousEngine) -> dict:
    """Everything that must match for two ranks' pools to run the same
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
    nothing and replay through `run_follower`. `name` tags its ops in the
    stream ("main" for the serving pool, "spec" for the mixed mode's
    speculative pool)."""

    multihost = True
    _OPS = ("init_state", "insert", "step", "release", "harvest_all", "harvest", "align")

    def __init__(self, *args, leader: Optional[OpLeader] = None, name: str = "main",
                 **kwargs):
        self._leader = None  # no op publishes while the base class constructs
        super().__init__(*args, **kwargs)
        if self.shardings is None:
            raise ValueError(
                "multi-process serving needs a sharded engine "
                "(WhisperEngine(..., shardings=multihost_shardings(...)))"
            )
        self._params_fp = self.eng.params_fp
        if self.draft is not None:
            self._params_fp = self._params_fp + self.draft.params_fp
        self.name = name
        self._leader = leader
        if leader is not None:
            leader.register(name, self)

    def signature(self) -> dict:
        return engine_signature(self)

    # -- publication ---------------------------------------------------

    def _op(self, op: str, payload=None):
        """Publish op and run it under the world's dispatch lock (a
        follower, which has no leader, runs it as it is)."""
        if self._leader is None:
            return contextlib.nullcontext()
        return self._leader.dispatch(self.name, op, payload)

    def stop_followers(self) -> None:
        """End every follower's replay loop and close the channel."""
        if self._leader is not None:
            self._leader.stop()
            self._leader = None

    # -- device ops (publish, then run the shared implementation) ------

    def init_state(self, seed: int = 0) -> None:
        with self._op("init_state", seed):
            super().init_state(seed)

    def insert(self, *args, **kwargs):
        with self._op("insert", (args, kwargs)):
            return super().insert(*args, **kwargs)

    def step(self) -> np.ndarray:
        with self._op("step"):
            return super().step()

    def release(self, slot_ids: list[int]) -> None:
        with self._op("release", list(slot_ids)):
            super().release(slot_ids)

    def harvest_all(self) -> np.ndarray:
        with self._op("harvest_all"):
            return super().harvest_all()

    def harvest(self, slot: int, join_step: int, gen_len: int, lane: int = 0) -> np.ndarray:
        with self._op("harvest", (slot, join_step, gen_len, lane)):
            return super().harvest(slot, join_step, gen_len, lane)

    def align_fetch(self, slot, tokens_arr, cross_len, seq_len, num_frames):
        # dispatched from the scheduler's worker thread at harvest, a fixed
        # position in the stream on every rank
        with self._op("align", (slot, np.asarray(tokens_arr), int(cross_len), int(seq_len),
                                int(num_frames))):
            return super().align_fetch(slot, tokens_arr, cross_len, seq_len, num_frames)

    def replay(self, op: str, payload) -> None:
        """A follower's run of one published op."""
        if op not in self._OPS:
            raise ReplayError(f"unknown op {op!r} for pool {self.name!r}")
        if op == "init_state":
            self.init_state(payload)
        elif op == "insert":
            args, kwargs = payload
            self.insert(*args, **kwargs)
        elif op in ("step", "harvest_all"):
            getattr(self, op)()
        elif op == "release":
            self.release(payload)
        elif op == "harvest":
            self.harvest(*payload)
        else:
            self.align_fetch(*payload)


# -- the window route --------------------------------------------------


class Handle:
    """A device result of a published window op (an encoder output, a
    cross-KV or a gathered sub-batch of one), named in later payloads by
    its id, never pickled with its value: each rank keeps its own value in
    its handle table under the same id."""

    __slots__ = ("hid",)

    def __init__(self, hid):
        self.hid = hid

    def __reduce__(self):
        return Handle, (self.hid,)

    def __repr__(self) -> str:
        return f"Handle{self.hid}"


def _is_device_value(v) -> bool:
    """A tensor, or a cross-KV dict (tensors, and None for an absent
    scale)."""
    return isinstance(v, torch.Tensor) or (
        isinstance(v, dict) and any(isinstance(x, torch.Tensor) for x in v.values()))


class MultihostWindowEngine:
    """The window route's WhisperEngine calls on the op log.

    The window scheduler (engine/scheduler.py) takes this in place of the
    engine: each call in CALLS (and, through `speculative`, each of the
    SpeculativeDecoder's) is published and run under the world's dispatch
    lock, so a follower replays it at the same point of the stream as the
    continuous pools' ops. A device value in a call's result (or in a
    member of a returned tuple) stays in the handle table of every rank
    under the op's id and is returned as a Handle, which later calls take
    back; `free_handles` drops them all on every rank (the batch
    scheduler calls it when a batch ends). Everything else (the
    tokenizer, the buckets, build_prompt) is the engine's own. Build it the
    same way on every rank; on the leader pass `leader=OpLeader(...)`."""

    multihost = True
    CALLS = ("prepare", "prepare_mel", "detect_language_from_cross", "decode_with_fallback",
             "transcribe_batch", "gather_cross", "align_maps", "align_words")
    SPEC_CALLS = ("cross_from_enc", "decode_with_fallback")

    def __init__(self, engine, leader: Optional[OpLeader] = None, name: str = "window",
                 spec_decoder=None):
        if engine.shardings is None:
            raise ValueError("the window route on the op log needs a sharded engine")
        self.engine = engine
        self.name = name
        self.spec_decoder = spec_decoder
        self.speculative = (None if spec_decoder is None
                            else MultihostSpeculativeDecoder(self))
        self._leader = leader
        self._handles: dict = {}
        self._seq = itertools.count()
        if leader is not None:
            leader.register(name, self)

    # device work that would run on this rank alone and leave the others
    # out of its collectives
    UNPUBLISHED = ("decode_batch", "detect_language_probs_from_cross", "transcribe_batch_async",
                   "warmup")

    def __getattr__(self, attr):
        if attr in self.UNPUBLISHED:
            raise AttributeError(f"{attr} is not on the op log: call it on every rank's engine "
                                 "in the same order, or use a published call")
        # host metadata and host helpers: the engine's own
        return getattr(self.engine, attr)

    def signature(self) -> dict:
        eng, sh = self.engine, self.engine.shardings
        sig = {
            "params_fp": eng.params_fp, "batch_buckets": tuple(eng.batch_buckets),
            "prompt_buckets": tuple(eng.prompt_buckets), "gen_buckets": tuple(eng.gen_buckets),
            "beam_chunk": eng.beam_chunk, "cross_kv_bits": eng.cross_kv_bits,
            "decoder_int8": eng.decoder_int8, "dp": sh.dp, "tp": sh.tp,
            "n_vocab": eng.cfg.n_vocab, "n_audio_ctx": eng.cfg.n_audio_ctx,
            "n_text_layer": eng.cfg.n_text_layer,
        }
        if self.spec_decoder is not None:
            sig.update(draft_fp=self.spec_decoder.draft.params_fp, spec_k=self.spec_decoder.k)
        return sig

    # -- the published calls -------------------------------------------

    def call(self, op: str, *args, **kwargs):
        """Publish `op` (a name of CALLS, or "spec." and one of SPEC_CALLS)
        with its host arguments and Handles, and run it on this rank."""
        if self._leader is None:
            raise RuntimeError(f"{self.name}: a follower runs window ops only by replay")
        seq = next(self._seq)
        with self._leader.dispatch(self.name, op, (seq, args, kwargs)):
            return self._run(seq, op, args, kwargs)

    def prepare(self, audio):
        return self.call("prepare", audio)

    def prepare_mel(self, melspec):
        return self.call("prepare_mel", melspec)

    def detect_language_from_cross(self, cross_kv):
        return self.call("detect_language_from_cross", cross_kv)

    def decode_with_fallback(self, *args, **kwargs):
        return self.call("decode_with_fallback", *args, **kwargs)

    def transcribe_batch(self, *args, **kwargs):
        return self.call("transcribe_batch", *args, **kwargs)

    def gather_cross(self, cross_kv, idx):
        return self.call("gather_cross", cross_kv, list(idx))

    def align_maps(self, *args, **kwargs):
        return self.call("align_maps", *args, **kwargs)

    def align_words(self, *args, **kwargs):
        return self.call("align_words", *args, **kwargs)

    def free_handles(self) -> None:
        """Drop every live handle, on this rank and on every follower."""
        if not self._handles:
            return
        with self._leader.dispatch(self.name, "free", list(self._handles)):
            self._handles.clear()

    # -- both sides ----------------------------------------------------

    def _target(self, op: str):
        if op.startswith("spec."):
            if self.spec_decoder is None or op[5:] not in self.SPEC_CALLS:
                raise ReplayError(f"{self.name}: no speculative op {op!r}")
            return getattr(self.spec_decoder, op[5:])
        if op not in self.CALLS:
            raise ReplayError(f"{self.name}: unknown window op {op!r}")
        return getattr(self.engine, op)

    def _resolve(self, v):
        if not isinstance(v, Handle):
            return v
        try:
            return self._handles[v.hid]
        except KeyError:
            raise ReplayError(f"{self.name}: unknown handle {v.hid}") from None

    def _keep(self, hid, v):
        if not _is_device_value(v):
            return v
        self._handles[hid] = v
        return Handle(hid)

    def _run(self, seq: int, op: str, args, kwargs):
        fn = self._target(op)
        args = [self._resolve(a) for a in args]
        kwargs = {k: self._resolve(v) for k, v in kwargs.items()}
        out = fn(*args, **kwargs)
        if isinstance(out, tuple):
            return tuple(self._keep((seq, i), v) for i, v in enumerate(out))
        return self._keep((seq, 0), out)

    def replay(self, op: str, payload) -> None:
        """A follower's run of one published op."""
        if op == "free":
            for hid in payload:
                if self._handles.pop(hid, None) is None:
                    raise ReplayError(f"{self.name}: free of unknown handle {hid}")
            return
        seq, args, kwargs = payload
        self._run(seq, op, args, kwargs)

    @property
    def live_handles(self) -> int:
        return len(self._handles)


class MultihostSpeculativeDecoder:
    """The SpeculativeDecoder of a MultihostWindowEngine: its calls ride
    the window engine's op stream and handle table (the draft's cross-KV
    is projected from a prepared encoder output). Everything else (k,
    stats, acceptance_rate) is the decoder's own."""

    def __init__(self, window: MultihostWindowEngine):
        self._window = window

    def __getattr__(self, attr):
        return getattr(self._window.spec_decoder, attr)

    def cross_from_enc(self, enc):
        return self._window.call("spec.cross_from_enc", enc)

    def decode_with_fallback(self, *args, **kwargs):
        return self._window.call("spec.decode_with_fallback", *args, **kwargs)


class MultihostBatchScheduler(BatchScheduler):
    """The window scheduler over a MultihostWindowEngine: a batch's handles
    are freed on every rank when the batch ends, whether it succeeded or
    not."""

    def _process_batch(self, batch) -> None:
        try:
            super()._process_batch(batch)
        finally:
            self.engine.free_handles()


def run_follower(targets, chan: OpFollower) -> int:
    """Replay the leader's op stream on this rank. `targets` maps each
    target name of the stream to this rank's copy (a lone
    MultihostContinuousEngine stands for {its name: it}), built exactly as
    the leader's: the first frame is a handshake of every target's
    signature. Blocks until the leader publishes "stop" (returns the op
    count) or the channel breaks (raises); an op for an unknown target,
    op or handle raises ReplayError."""
    if not isinstance(targets, dict):
        targets = {targets.name: targets}
    op, sigs = chan.next()
    if op != "hello":
        raise RuntimeError(f"op-log stream must start with hello, got {op!r}")
    mine = {name: t.signature() for name, t in targets.items()}
    if sigs != mine:
        diff = {}
        for name in sorted(set(sigs) | set(mine)):
            theirs, ours = sigs.get(name), mine.get(name)
            if theirs is None or ours is None:
                diff[name] = ("missing on the leader" if theirs is None
                              else "missing on this rank")
            elif theirs != ours:
                diff[name] = {k: (theirs.get(k), ours.get(k)) for k in set(theirs) | set(ours)
                              if theirs.get(k) != ours.get(k)}
        raise RuntimeError(f"engine signature mismatch with leader: {diff}")
    n = 0
    while True:
        op, payload = chan.next()
        if op == "stop":
            logger.info("op-log follower replayed %d ops", n)
            return n
        name, _, call = op.partition(".")
        target = targets.get(name)
        if target is None:
            raise ReplayError(f"op {op!r} for unknown target {name!r}")
        n += 1
        # Error parity with the leader: its schedulers catch op exceptions
        # and keep serving (a failed insert fails its requests, the worker
        # loop's catch-all releases the slots; both publish their own ops,
        # which arrive next here). A deterministic op failure raises here
        # too and must be survived the same way, or this rank dies and the
        # leader's next collective hangs the world. A protocol fault is not
        # such a failure.
        try:
            target.replay(call, payload)
        except ReplayError:
            raise
        except Exception:
            logger.exception("op-log replay of %r failed (continuing: the leader's "
                             "scheduler survives the same failure)", op)
