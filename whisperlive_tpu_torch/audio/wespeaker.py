"""WeSpeaker-ResNet-shaped speaker embedder.

The reference embeds segments with pyannote's wrapper around
`wespeaker-voxceleb-resnet34-LM` (whisper_live/diarization.py:52-62,
79-124) — a checkpoint downloaded at runtime, unavailable offline. This
module reproduces that model FAMILY's exact compute graph (the public
WeSpeaker ResNet recipe) so that real exported weights can drop in, while
shipping in-repo weights trained on the synthetic-voice corpus
(scripts/train_speaker.py --arch resnet):

  * 80-dim log mel-filterbank features, 25 ms / 10 ms, per-utterance mean
    normalization;
  * ResNet stem (3x3 conv + BN + relu) and four BasicBlock stages —
    channels (32, 64, 128, 256) x blocks (3, 4, 6, 3) for ResNet34 —
    downsampling time AND frequency by 2 in stages 2-4;
  * temporal statistics pooling (TSTP: mean+std over time of the
    flattened channel x frequency map);
  * a linear projection to the embedding (256-dim for r34-LM).

`R34` is the real checkpoint's shape; the shipped weights use `LITE`
(same graph, reduced widths/depths) because a 6.6M-param model is not
trainable to a useful point on synthetic voices alone — the graph is what
matters for drop-in: `load_wespeaker_onnx(path)` ingests a real wespeaker
ONNX export if one is ever present (own protobuf reader, no onnx
dependency) and returns `R34`-shaped params for `WeSpeakerEmbedder`.

Inference is pure numpy (host-side, called per committed segment). The
port's copy of whisperlive_tpu/audio/wespeaker.py; its training forward,
`embed_torch` (batch-statistics BN with EMA running stats), serves
cli/train_speaker.py --arch resnet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from whisperlive_tpu_torch.audio.silero_vad import read_onnx_initializers

SAMPLE_RATE = 16_000
FRAME = 400  # 25 ms
HOP = 160  # 10 ms
N_MELS = 80
BN_EPS = 1e-5

WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "wespeaker_weights.npz")


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    channels: tuple[int, ...] = (32, 64, 128, 256)
    blocks: tuple[int, ...] = (3, 4, 6, 3)
    emb_dim: int = 256
    feat_dim: int = N_MELS

    @property
    def pool_dim(self) -> int:
        # frequency axis shrinks 2x per strided stage; TSTP doubles (mean+std)
        f = self.feat_dim
        for _ in self.channels[1:]:
            f = (f + 1) // 2
        return 2 * self.channels[-1] * f


R34 = ResNetConfig()  # wespeaker-voxceleb-resnet34-LM shape
LITE = ResNetConfig(channels=(16, 32, 64, 128), blocks=(1, 1, 1, 1), emb_dim=128)


# ---------------------------------------------------------------------------
# Features: 80-dim log mel filterbank, mean-normalized (wespeaker applies
# kaldi fbank + CMN; dither and the exact window differ — irrelevant for
# in-repo weights, and a <0.1 dB perturbation for ingested ones)
# ---------------------------------------------------------------------------

_MEL_FB = None


def _mel_matrix() -> np.ndarray:
    global _MEL_FB
    if _MEL_FB is not None:
        return _MEL_FB
    n_freqs = FRAME // 2 + 1
    freqs = np.linspace(0, SAMPLE_RATE / 2, n_freqs)
    mel = 2595 * np.log10(1 + freqs / 700)
    lo, hi = 2595 * np.log10(1 + 20 / 700), 2595 * np.log10(1 + 7600 / 700)
    edges = np.linspace(lo, hi, N_MELS + 2)
    fb = np.zeros((n_freqs, N_MELS), np.float32)
    for b in range(N_MELS):
        left, mid, right = edges[b], edges[b + 1], edges[b + 2]
        up = (mel - left) / max(mid - left, 1e-6)
        down = (right - mel) / max(right - mid, 1e-6)
        fb[:, b] = np.clip(np.minimum(up, down), 0, 1)
    _MEL_FB = fb
    return fb


_WIN = np.hanning(FRAME).astype(np.float32)


def fbank(audio: np.ndarray) -> np.ndarray:
    """[n] f32 -> [T, 80] mean-normalized log filterbank."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    audio = np.concatenate([audio[:1], audio[1:] - 0.97 * audio[:-1]])
    n = (len(audio) - FRAME) // HOP + 1
    if n < 2:
        return np.zeros((0, N_MELS), np.float32)
    idx = np.arange(FRAME)[None, :] + HOP * np.arange(n)[:, None]
    frames = audio[idx] * _WIN[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    feats = np.log(spec @ _mel_matrix() + 1e-10).astype(np.float32)
    return feats - feats.mean(axis=0, keepdims=True)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _block_specs(cfg: ResNetConfig):
    """Yield (name, c_in, c_out, stride, has_downsample) per BasicBlock."""
    c_in = cfg.channels[0]
    for s, (c_out, n_blocks) in enumerate(zip(cfg.channels, cfg.blocks)):
        for b in range(n_blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            ds = stride != 1 or c_in != c_out
            yield f"s{s}b{b}", c_in, c_out, stride, ds
            c_in = c_out


def init_wespeaker_params(cfg: ResNetConfig = LITE, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def he(shape):
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(
            np.float32
        )

    def bn(prefix, c, params):
        params[f"{prefix}_g"] = np.ones(c, np.float32)
        params[f"{prefix}_b"] = np.zeros(c, np.float32)
        params[f"{prefix}_m"] = np.zeros(c, np.float32)
        params[f"{prefix}_v"] = np.ones(c, np.float32)

    p: dict = {"stem_w": he((3, 3, 1, cfg.channels[0]))}
    bn("stem_bn", cfg.channels[0], p)
    for name, c_in, c_out, _stride, ds in _block_specs(cfg):
        p[f"{name}_c1_w"] = he((3, 3, c_in, c_out))
        bn(f"{name}_bn1", c_out, p)
        p[f"{name}_c2_w"] = he((3, 3, c_out, c_out))
        bn(f"{name}_bn2", c_out, p)
        if ds:
            p[f"{name}_ds_w"] = he((1, 1, c_in, c_out))
            bn(f"{name}_dsbn", c_out, p)
    p["emb_w"] = he((cfg.pool_dim, cfg.emb_dim))
    p["emb_b"] = np.zeros(cfg.emb_dim, np.float32)
    return p


def config_of(params: dict) -> ResNetConfig:
    """Recover the ResNetConfig a parameter dict was built for."""
    channels = []
    blocks = []
    s = 0
    while f"s{s}b0_c1_w" in params:
        b = 0
        while f"s{s}b{b}_c1_w" in params:
            b += 1
        channels.append(params[f"s{s}b0_c1_w"].shape[-1])
        blocks.append(b)
        s += 1
    return ResNetConfig(
        channels=tuple(channels),
        blocks=tuple(blocks),
        emb_dim=params["emb_w"].shape[1],
        feat_dim=N_MELS,
    )


# ---------------------------------------------------------------------------
# numpy inference (eval-mode BN with running stats)
# ---------------------------------------------------------------------------


def _conv2d_np(x: np.ndarray, w: np.ndarray, stride: int) -> np.ndarray:
    """x [H, W, C_in], w [kh, kw, C_in, C_out], same-padding for 3x3."""
    kh, kw = w.shape[:2]
    if kh == 3:
        x = np.pad(x, [(1, 1), (1, 1), (0, 0)])
    windows = np.lib.stride_tricks.sliding_window_view(x, (kh, kw), (0, 1))
    # windows: [H', W', C_in, kh, kw] -> strided
    windows = windows[::stride, ::stride]
    return np.tensordot(windows, w, axes=[(2, 3, 4), (2, 0, 1)])


def _bn_np(params: dict, prefix: str, x: np.ndarray) -> np.ndarray:
    g, b = params[f"{prefix}_g"], params[f"{prefix}_b"]
    m, v = params[f"{prefix}_m"], params[f"{prefix}_v"]
    return (x - m) * (g / np.sqrt(v + BN_EPS)) + b


def embed_np(params: dict, feats: np.ndarray) -> np.ndarray:
    """[T, 80] fbank -> [emb_dim] L2-normalized embedding."""
    cfg = config_of(params)
    if feats.shape[0] < 2:
        return np.zeros(cfg.emb_dim, np.float32)
    x = feats[:, :, None]  # [T, F, 1]
    x = np.maximum(_bn_np(params, "stem_bn", _conv2d_np(x, params["stem_w"], 1)), 0)
    for name, _c_in, _c_out, stride, ds in _block_specs(cfg):
        y = np.maximum(
            _bn_np(params, f"{name}_bn1", _conv2d_np(x, params[f"{name}_c1_w"], stride)),
            0,
        )
        y = _bn_np(params, f"{name}_bn2", _conv2d_np(y, params[f"{name}_c2_w"], 1))
        sc = (
            _bn_np(params, f"{name}_dsbn", _conv2d_np(x, params[f"{name}_ds_w"], stride))
            if ds
            else x
        )
        x = np.maximum(y + sc, 0)
    flat = x.reshape(x.shape[0], -1)  # [T', F'*C]
    pooled = np.concatenate([flat.mean(axis=0), flat.std(axis=0)])
    emb = pooled @ params["emb_w"] + params["emb_b"]
    norm = np.linalg.norm(emb)
    return (emb / norm if norm > 0 else emb).astype(np.float32)


# ---------------------------------------------------------------------------
# torch forward (training: batch-stat BN, returns EMA-updated running stats)
# ---------------------------------------------------------------------------


def embed_torch(params: dict, feats, train: bool = False, ema: float = 0.95):
    """feats [B, T, 80] -> ([B, emb] normalized, updated-running-stats dict).

    train=True normalizes with batch statistics and returns EMA-updated
    _m/_v entries (detached) to merge back into params; train=False
    reproduces embed_np. The statistics are computed here, not by
    nn.BatchNorm2d, which tracks the unbiased variance under the opposite
    momentum convention: the batch variance is the biased one."""
    import torch
    import torch.nn.functional as F

    cfg = config_of(params)
    new_stats: dict = {}

    def bn(prefix, x):
        if train:
            m = x.mean(dim=(0, 1, 2))
            v = x.var(dim=(0, 1, 2), unbiased=False)
            new_stats[f"{prefix}_m"] = (ema * params[f"{prefix}_m"] + (1 - ema) * m).detach()
            new_stats[f"{prefix}_v"] = (ema * params[f"{prefix}_v"] + (1 - ema) * v).detach()
        else:
            m, v = params[f"{prefix}_m"], params[f"{prefix}_v"]
        g, b = params[f"{prefix}_g"], params[f"{prefix}_b"]
        return (x - m) * (g / torch.sqrt(v + BN_EPS)) + b

    def conv(x, w, stride):
        # x NHWC, w HWIO; explicit (1, 1) padding for 3x3 (window centers at
        # 0, 2, 4, ... under stride 2, as embed_np)
        pad = 1 if w.shape[0] == 3 else 0
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride, padding=pad)
        return y.permute(0, 2, 3, 1)

    x = feats[..., None]  # [B, T, F, 1]
    x = torch.relu(bn("stem_bn", conv(x, params["stem_w"], 1)))
    for name, _c_in, _c_out, stride, ds in _block_specs(cfg):
        y = torch.relu(bn(f"{name}_bn1", conv(x, params[f"{name}_c1_w"], stride)))
        y = bn(f"{name}_bn2", conv(y, params[f"{name}_c2_w"], 1))
        sc = bn(f"{name}_dsbn", conv(x, params[f"{name}_ds_w"], stride)) if ds else x
        x = torch.relu(y + sc)
    flat = x.reshape(x.shape[0], x.shape[1], -1)  # [B, T', F'*C]
    std = torch.sqrt(flat.var(dim=1, unbiased=False) + 1e-10)  # finite grad at zero variance
    pooled = torch.cat([flat.mean(dim=1), std], dim=-1)
    emb = pooled @ params["emb_w"] + params["emb_b"]
    emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-8)
    return emb, new_stats


def weights_available() -> bool:
    return os.path.exists(WEIGHTS_PATH)


class WeSpeakerEmbedder:
    """Drop-in embedder for SpeakerDiarizer(embedder=...) over the
    WeSpeaker ResNet graph (shipped LITE weights by default; pass params
    from load_wespeaker_onnx for a real checkpoint)."""

    def __init__(self, params: Optional[dict] = None):
        if params is None:
            data = np.load(WEIGHTS_PATH)
            params = {k: data[k].astype(np.float32) for k in data.files}
        self.params = params

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        return embed_np(self.params, fbank(audio))


# ---------------------------------------------------------------------------
# ONNX ingestion (real wespeaker export, if a file is ever present)
# ---------------------------------------------------------------------------


def pool_permutation(cfg: ResNetConfig) -> np.ndarray:
    """Index map from this module's pooled layout (freq-major f*C'+c per
    mean/std half) to wespeaker's TSTP layout (channel-major c*F'+f):
    ours[i] corresponds to wespeaker row perm[i]."""
    f_last = cfg.feat_dim
    for _ in cfg.channels[1:]:
        f_last = (f_last + 1) // 2
    c_last = cfg.channels[-1]
    half = c_last * f_last
    i = np.arange(half)
    onnx_row = (i % c_last) * f_last + (i // c_last)
    return np.concatenate([onnx_row, half + onnx_row])


def load_wespeaker_onnx(path: str, cfg: ResNetConfig = R34) -> dict:
    """Map a wespeaker ResNet ONNX export's initializers onto this module's
    parameter layout.

    Tensors are consumed in GRAPH ORDER (torch exports emit execution
    order: stem conv, stem BN, then per-block conv1/bn1/conv2/bn2 with the
    downsample conv+BN trailing the block, then the embedding linear) and
    matched by shape signature: convs by [C_out, C_in, kh, kw], each BN as
    the next four [C]-sized tensors with name hints resolving
    (gamma, beta, mean, var) order, the head by a [emb, pool] (or
    transposed) matrix. Raises with the full tensor inventory when the
    file is not from the expected model family.
    """
    tensors = read_onnx_initializers(path)
    inv = {name: t.shape for name, t in tensors.items()}
    items = list(tensors.items())
    used: set[str] = set()

    def take(pred, what):
        for n, t in items:
            if n not in used and pred(n, t):
                used.add(n)
                return n, t
        raise ValueError(f"no ONNX tensor matches {what}; inventory: {inv}")

    def take_conv(c_out, c_in, k, what):
        _, t = take(
            lambda n, t: t.shape == (c_out, c_in, k, k),
            f"{what} conv [{c_out},{c_in},{k},{k}]",
        )
        # wespeaker runs on [B, C, F(height), T(width)], so the ONNX kernel
        # is [C_out, C_in, kh=FREQ, kw=TIME]; this module runs on
        # [T(height), F(width), C], so our kh must take the ONNX kw (time)
        # and our kw the ONNX kh (freq): (3, 2, 1, 0), not (2, 3, 1, 0).
        return np.transpose(t, (3, 2, 1, 0)).astype(np.float32)

    def take_bn(prefix, c, out):
        """Next four [c]-sized tensors; name hints fix the roles."""
        group = [take(lambda n, t: t.shape == (c,), f"{prefix} BN [{c}]")
                 for _ in range(4)]
        roles: dict[str, np.ndarray] = {}
        rest = []
        for n, t in group:
            low = n.lower()
            if ("mean" in low or "running_mean" in low) and "m" not in roles:
                roles["m"] = t
            elif "var" in low and "v" not in roles:
                roles["v"] = t
            elif ("bias" in low or "beta" in low) and "b" not in roles:
                roles["b"] = t
            elif ("weight" in low or "gamma" in low or "scale" in low) and (
                "g" not in roles
            ):
                roles["g"] = t
            else:
                rest.append(t)
        # unnamed leftovers fill the ONNX BatchNormalization input order
        for key in ("g", "b", "m", "v"):
            if key not in roles:
                roles[key] = rest.pop(0)
        for key, t in roles.items():
            out[f"{prefix}_{key}"] = t.astype(np.float32)

    params: dict = {}
    params["stem_w"] = take_conv(cfg.channels[0], 1, 3, "stem")
    take_bn("stem_bn", cfg.channels[0], params)
    for name, c_in, c_out, _stride, ds in _block_specs(cfg):
        params[f"{name}_c1_w"] = take_conv(c_out, c_in, 3, f"{name} conv1")
        take_bn(f"{name}_bn1", c_out, params)
        params[f"{name}_c2_w"] = take_conv(c_out, c_out, 3, f"{name} conv2")
        take_bn(f"{name}_bn2", c_out, params)
        if ds:
            params[f"{name}_ds_w"] = take_conv(c_out, c_in, 1, f"{name} downsample")
            take_bn(f"{name}_dsbn", c_out, params)
    _, head = take(
        lambda n, t: t.ndim == 2 and (
            t.shape == (cfg.emb_dim, cfg.pool_dim)
            or t.shape == (cfg.pool_dim, cfg.emb_dim)
        ),
        f"embedding linear [{cfg.emb_dim},{cfg.pool_dim}]",
    )
    head_rows = (head.T if head.shape[0] == cfg.emb_dim else head).astype(
        np.float32
    )  # [pool_dim, emb]
    # Pooled-vector layout differs: wespeaker's TSTP flattens CHANNEL-major
    # (index c*F'+f per mean/std half), this module flattens FREQ-major
    # (f*C'+c, embed_np). Permute the head's input rows so each of our
    # pooled components multiplies the weight row trained for it.
    params["emb_w"] = head_rows[pool_permutation(cfg)]
    try:
        _, hb = take(lambda n, t: t.shape == (cfg.emb_dim,), "embedding bias")
        params["emb_b"] = hb.astype(np.float32)
    except ValueError:
        params["emb_b"] = np.zeros(cfg.emb_dim, np.float32)
    return params
