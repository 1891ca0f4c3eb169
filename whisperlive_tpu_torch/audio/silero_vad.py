"""Silero-shaped streaming VAD: the reference's exact streaming contract.

The reference wraps silero v5 ONNX (whisper_live/vad.py:9-109) with this
framing, reproduced here EXACTLY so the two gates are drop-in equivalent:

  * 512-sample windows at 16 kHz;
  * a 64-sample context carry — each window is scored on the 576-sample
    concatenation [last 64 samples of the previous window | 512 new];
  * recurrent state of shape 2 x 128 — an LSTM cell's (h, c);
  * one P(speech) per window.

The compute graph mirrors silero's published structure (STFT magnitude
frontend -> small conv encoder -> LSTMCell(128) -> linear head), with
weights trained in-repo on the synthetic corpus (scripts/train_vad.py
--arch silero: speech-like positives incl. reverberant voices vs noise /
tones / chirps / clicks / music / babble negatives) — zero-egress
deployments cannot download silero's weights the way the reference does
at runtime.

`load_silero_onnx(path)` ingests a real silero ONNX file if one is ever
present: it parses the protobuf wire format directly (no onnx dependency;
same approach as the SMALL100 sentencepiece reader) and maps initializer
tensors onto this module's parameters by shape signature, erroring with a
full tensor inventory when the graph differs from the expected family.

Inference is pure numpy (the host gate must not touch the device). The
port's copy of whisperlive_tpu/audio/silero_vad.py keeps inference only:
training (scripts/train_vad.py) stays with the JAX package.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Optional

import numpy as np

WINDOW = 512
CONTEXT = 64
N_FFT = 256
HOP = 128
N_FREQS = N_FFT // 2 + 1  # 129
N_FRAMES = (WINDOW + CONTEXT - N_FFT) // HOP + 1  # 3
ENC_CHANNELS = (128, 64, 64, 128)
HIDDEN = 128  # LSTM cell size -> the reference's 2x128 state

WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "silero_vad_weights.npz")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_silero_params(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def glorot(shape):
        fan = shape[0] + shape[-1]
        lim = np.sqrt(6.0 / fan)
        return rng.uniform(-lim, lim, shape).astype(np.float32)

    params: dict = {}
    c_in = N_FREQS
    for i, c_out in enumerate(ENC_CHANNELS):
        # conv over the (3-frame) time axis: [k, c_in, c_out]
        params[f"enc{i}_w"] = glorot((3, c_in, c_out))
        params[f"enc{i}_b"] = np.zeros((c_out,), np.float32)
        c_in = c_out
    params["lstm_wx"] = glorot((ENC_CHANNELS[-1], 4 * HIDDEN))
    params["lstm_wh"] = glorot((HIDDEN, 4 * HIDDEN))
    params["lstm_b"] = np.zeros((4 * HIDDEN,), np.float32)
    params["out_w"] = glorot((HIDDEN, 1))
    params["out_b"] = np.zeros((1,), np.float32)
    return params


# ---------------------------------------------------------------------------
# Frontend
# ---------------------------------------------------------------------------

_WIN = np.hanning(N_FFT).astype(np.float32)


def stft_frames(sig: np.ndarray) -> np.ndarray:
    """[576] samples -> [N_FRAMES, N_FREQS] log magnitude."""
    frames = np.stack(
        [sig[i * HOP : i * HOP + N_FFT] * _WIN for i in range(N_FRAMES)]
    )
    mag = np.abs(np.fft.rfft(frames, axis=1)).astype(np.float32)
    return np.log1p(mag)


def features_for_windows(audio: np.ndarray, context: np.ndarray) -> tuple:
    """Chunk [T*512] + carry [64] -> ([T, N_FRAMES, N_FREQS], new carry).

    The returned carry is a COPY, never a view into `audio`: the stateful
    model stores it across calls (and reset() zeroes it), and a live view
    would alias — and let reset() corrupt — caller-owned audio buffers
    that may still be queued for decoding."""
    n = len(audio) // WINDOW
    feats = np.zeros((n, N_FRAMES, N_FREQS), np.float32)
    ctx = context
    for t in range(n):
        w = audio[t * WINDOW : (t + 1) * WINDOW]
        feats[t] = stft_frames(np.concatenate([ctx, w]))
        ctx = w[-CONTEXT:]
    return feats, (ctx.copy() if n else ctx)


# ---------------------------------------------------------------------------
# numpy inference
# ---------------------------------------------------------------------------


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(np.clip(-x, -60.0, 60.0)))


def _conv_time(x: np.ndarray, w: np.ndarray, b: np.ndarray) -> np.ndarray:
    """x [T, C_in], w [3, C_in, C_out] -> relu(conv1d same-pad) [T, C_out]."""
    xp = np.pad(x, [(1, 1), (0, 0)])
    out = (
        xp[:-2] @ w[0] + xp[1:-1] @ w[1] + xp[2:] @ w[2] + b[None, :]
    )
    return np.maximum(out, 0.0)


def encode_window(params: dict, feats: np.ndarray) -> np.ndarray:
    """[N_FRAMES, N_FREQS] -> [HIDDEN-input] pooled encoder features."""
    x = feats
    for i in range(len(ENC_CHANNELS)):
        x = _conv_time(x, params[f"enc{i}_w"], params[f"enc{i}_b"])
    return x.mean(axis=0)  # [ENC_CHANNELS[-1]]


def lstm_step(params: dict, h: np.ndarray, c: np.ndarray, x: np.ndarray):
    gates = x @ params["lstm_wx"] + h @ params["lstm_wh"] + params["lstm_b"]
    i = _sigmoid(gates[:HIDDEN])
    f = _sigmoid(gates[HIDDEN : 2 * HIDDEN])
    g = np.tanh(gates[2 * HIDDEN : 3 * HIDDEN])
    o = _sigmoid(gates[3 * HIDDEN :])
    c = f * c + i * g
    h = o * np.tanh(c)
    return h, c


class SileroShapedVAD:
    """Streaming speech-probability model with silero's exact contract:
    512-sample windows, 64-sample context carry, (2, 128) recurrent
    state. API-compatible with vad.py's model protocol (update/reset)."""

    def __init__(self, params: Optional[dict] = None):
        if params is None:
            data = np.load(WEIGHTS_PATH)
            params = {k: data[k] for k in data.files}
        self.params = params
        self.h = np.zeros(HIDDEN, np.float32)
        self.c = np.zeros(HIDDEN, np.float32)
        self._context = np.zeros(CONTEXT, np.float32)
        # trailing partial-window samples carried to the next update() —
        # 30 ms (480-sample) streaming frames would otherwise NEVER fill
        # a 512-sample window and the gate would stay closed forever
        self._pending = np.zeros(0, np.float32)

    @property
    def state(self) -> np.ndarray:
        """The reference's [2, 128] state tensor view (h, c)."""
        return np.stack([self.h, self.c])

    def reset(self) -> None:
        self.h = np.zeros(HIDDEN, np.float32)
        self.c = np.zeros(HIDDEN, np.float32)
        # rebind, never write in place: _context may (defensively) be a
        # shared array and must not be mutated under the caller
        self._context = np.zeros(CONTEXT, np.float32)
        self._pending = np.zeros(0, np.float32)

    def update(self, audio: np.ndarray) -> np.ndarray:
        """Chunk of PCM -> per-window speech probabilities (stateful).
        Trailing partial-window samples are buffered for the next call."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        if len(self._pending):
            audio = np.concatenate([self._pending, audio])
        rem = len(audio) % WINDOW
        self._pending = audio[len(audio) - rem :].copy() if rem else np.zeros(
            0, np.float32
        )
        feats, self._context = features_for_windows(audio, self._context)
        probs = np.empty(len(feats), np.float32)
        h, c = self.h, self.c
        for t in range(len(feats)):
            x = encode_window(self.params, feats[t])
            h, c = lstm_step(self.params, h, c, x)
            probs[t] = _sigmoid(
                float((h @ self.params["out_w"])[0] + self.params["out_b"][0])
            )
        self.h, self.c = h, c
        return probs


def weights_available() -> bool:
    return os.path.exists(WEIGHTS_PATH)


# ---------------------------------------------------------------------------
# ONNX weight ingestion (real silero weights, if a file is ever present)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _wire_fields(buf: bytes):
    """Iterate (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = buf[pos : pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == 5:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


_ONNX_DTYPES = {1: np.float32, 6: np.int32, 7: np.int64, 11: np.float64}


def _parse_tensor(buf: bytes):
    """ONNX TensorProto -> (name, np.ndarray)."""
    name = ""
    dims: list[int] = []
    dtype = 1
    raw = b""
    floats: list[float] = []
    for field, wt, val in _wire_fields(buf):
        if field == 1 and wt == 0:  # dims (repeated varint)
            dims.append(val)
        elif field == 1 and wt == 2:  # packed dims
            p = 0
            while p < len(val):
                d, p = _read_varint(val, p)
                dims.append(d)
        elif field == 2:
            dtype = val
        elif field == 8:
            name = val.decode("utf-8", "replace")
        elif field == 9:
            raw = val
        elif field == 4 and wt == 2:  # packed float_data
            floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
    np_dtype = _ONNX_DTYPES.get(dtype, np.float32)
    if raw:
        arr = np.frombuffer(raw, np_dtype)
    else:
        arr = np.asarray(floats, np_dtype)
    return name, arr.reshape(dims) if dims else arr


def _collect_graph_tensors(graph: bytes, tensors: dict) -> None:
    """GraphProto -> initializers + Constant-node values + nested-subgraph
    tensors. Real silero exports branch on sample rate via If nodes whose
    weights live inside branch subgraphs (GraphProto nested in
    AttributeProto.g) or as Constant nodes, not top-level initializers."""
    for gfield, gwt, gval in _wire_fields(graph):
        if gfield == 5 and gwt == 2:  # initializer
            name, arr = _parse_tensor(gval)
            tensors.setdefault(name, arr)
        elif gfield == 1 and gwt == 2:  # node (NodeProto)
            op_type = ""
            out_name = ""
            attrs: list[bytes] = []
            for nf, nwt, nval in _wire_fields(gval):
                if nf == 2 and nwt == 2 and not out_name:  # first output
                    out_name = nval.decode("utf-8", "replace")
                elif nf == 4 and nwt == 2:
                    op_type = nval.decode("utf-8", "replace")
                elif nf == 5 and nwt == 2:  # attribute
                    attrs.append(nval)
            for attr in attrs:
                for af, awt, aval in _wire_fields(attr):
                    if af in (5, 10) and awt == 2:  # AttributeProto.t/.tensors
                        if op_type == "Constant" and out_name:
                            _, arr = _parse_tensor(aval)
                            tensors.setdefault(out_name, arr)
                    elif af in (6, 11) and awt == 2:  # .g / .graphs subgraph
                        _collect_graph_tensors(aval, tensors)


def read_onnx_initializers(path: str) -> dict[str, np.ndarray]:
    """All weight tensors of an ONNX file, by name (no onnx dependency:
    ModelProto.graph = field 7), including Constant-node tensors and
    weights nested in If/Loop branch subgraphs."""
    with open(path, "rb") as f:
        model = f.read()
    tensors: dict[str, np.ndarray] = {}
    for field, wt, val in _wire_fields(model):
        if field == 7 and wt == 2:  # graph
            _collect_graph_tensors(val, tensors)
    return tensors


def load_silero_onnx(path: str) -> dict:
    """Map a silero ONNX file's initializers onto this module's params.

    Tensors are consumed in GRAPH ORDER with name hints breaking shape
    ties (ONNX LSTM emits W before R, and input==hidden==128 makes their
    shapes collide): encoder convs match by (C_out, C_in, 3) channel
    signature with per-layer bias pairing, the LSTM by 4H-sized weight /
    bias tensors, the head by a multi-dim HIDDEN-sized tensor. Raises
    with a full tensor inventory when the file is not from the expected
    model family — adjust ENC_CHANNELS to the real graph in that case.
    """
    tensors = read_onnx_initializers(path)
    inv = {name: t.shape for name, t in tensors.items()}
    items = list(tensors.items())  # insertion = graph order
    # the real silero v5 file packages a parallel 8 kHz branch
    # (`_model_8k.*`) whose LSTM/inner-conv tensors collide in shape with
    # the 16 kHz ones — push the 8k branch behind the 16 kHz tensors so
    # graph-order matching picks the 16 kHz weights (stable sort keeps
    # relative order within each branch)
    items.sort(key=lambda kv: "8k" in kv[0].lower())
    used: set[str] = set()
    params = init_silero_params()

    def take(pred, what):
        for n, t in items:
            if n not in used and pred(n, t):
                used.add(n)
                return t
        raise ValueError(f"no ONNX tensor matches {what}; inventory: {inv}")

    h4 = 4 * HIDDEN
    # encoder convs first (graph order), so their 128-sized biases cannot
    # be mistaken for LSTM/head tensors
    c_in = N_FREQS
    for i, c_out in enumerate(ENC_CHANNELS):
        w = take(
            lambda n, t, c_out=c_out, c_in=c_in: t.ndim == 3
            and t.shape[0] == c_out and t.shape[1] == c_in,
            f"conv weight [{c_out},{c_in},k] for enc{i}",
        )
        # onnx conv layout [C_out, C_in, k] -> ours [k, C_in, C_out]
        params[f"enc{i}_w"] = np.transpose(w, (2, 1, 0)).astype(np.float32)
        try:
            b = take(
                lambda n, t, c_out=c_out: t.shape == (c_out,),
                f"conv bias [{c_out}] for enc{i}",
            )
            params[f"enc{i}_b"] = b.astype(np.float32)
        except ValueError:
            pass  # bias-free conv
        c_in = c_out

    def name_hints(n, *subs):
        low = n.lower()
        return any(s in low for s in subs)

    def is_recurrent_name(n):
        # token-wise, so `rnn.weight_ih` (real silero v5 names) is NOT
        # mistaken for a recurrent hint by a substring ".r" match
        segs = re.split(r"[^a-z0-9]+", n.lower())
        return "recurrent" in n.lower() or "hh" in segs or "r" in segs

    def is_wx(n, t):
        if t.size != h4 * ENC_CHANNELS[-1] or t.ndim not in (2, 3):
            return False
        return not is_recurrent_name(n)

    wx = take(is_wx, f"LSTM input weights (4H x {ENC_CHANNELS[-1]})")
    wh = take(
        lambda n, t: t.size == h4 * HIDDEN and t.ndim in (2, 3),
        f"LSTM recurrent weights (4H x {HIDDEN})",
    )
    b = take(
        lambda n, t: t.size in (h4, 2 * h4), "LSTM bias (4H or 8H)"
    )
    bb = b.reshape(-1).astype(np.float32)
    # Gate order: the ONNX LSTM op concatenates gate blocks as [i, o, f, c]
    # while this module (torch convention) uses [i, f, g(cell), o]. An 8H
    # concatenated Wb|Rb bias marks an ONNX-LSTM-op export -> permute; a
    # 4H bias marks torch-convention weights -> already ifgo.
    onnx_lstm = bb.size == 2 * h4
    if not onnx_lstm:
        # torch LSTMCell exports (the real silero v5 layout:
        # `_model.decoder.rnn.bias_ih` + `bias_hh`) carry TWO separate 4H
        # biases that the cell sums — missing the second silently halves
        # the bias, so consume it when present
        try:
            b2 = take(
                lambda n, t: t.size == h4 and name_hints(n, "bias"),
                "second LSTM bias (bias_hh)",
            )
            bb = bb + b2.reshape(-1).astype(np.float32)
        except ValueError:
            pass  # single merged bias (this repo's own exports)

    def gates(arr_4h_first: np.ndarray) -> np.ndarray:
        if not onnx_lstm:
            return arr_4h_first
        blocks = arr_4h_first.reshape(4, HIDDEN, *arr_4h_first.shape[1:])
        i, o, f, c = blocks
        return np.concatenate([i, f, c, o], axis=0)

    params["lstm_wx"] = gates(wx.reshape(h4, -1)).T.astype(np.float32)
    params["lstm_wh"] = gates(wh.reshape(h4, HIDDEN)).T.astype(np.float32)
    merged = bb[:h4] + bb[h4:] if onnx_lstm else bb
    params["lstm_b"] = gates(merged).astype(np.float32)
    head = take(
        lambda n, t: t.size == HIDDEN and t.ndim >= 2,
        f"output head ({HIDDEN} weights, ndim >= 2)",
    )
    params["out_w"] = head.reshape(HIDDEN, 1).astype(np.float32)
    try:
        ob = take(lambda n, t: t.size == 1, "output bias [1]")
        params["out_b"] = ob.reshape(1).astype(np.float32)
    except ValueError:
        params["out_b"] = np.zeros((1,), np.float32)
    return params
