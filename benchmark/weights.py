"""Seeded random Whisper weights, made on the device in a few large calls.

The tree is the one the port's WhisperEngine takes (models/whisper.py):
per-layer parameters stacked on a leading layer axis, linear weights
[d_in, d_out] applied as x @ w, conv kernels [out, in, k]. Every normal
leaf is a slice of one randn draw in the served dtype, scaled in place by
its standard deviation (d_in^-0.5 for linears, 0.05 for convs, 0.02 for the
token embedding, 0.01 for the decoder positions); biases are zero, layer
norms one and zero, the encoder positions the sinusoid table. The same seed
on the same device gives the same bytes, so the reference makes its own
copy again from the seed.
"""

from __future__ import annotations

import numpy as np
import torch


def dims(config: dict) -> dict:
    """The sizes a Whisper configuration file (HF config.json keys) fixes."""
    c = config
    if c["encoder_ffn_dim"] != 4 * c["d_model"] or c["decoder_ffn_dim"] != 4 * c["d_model"]:
        raise ValueError("the port's Whisper blocks have an MLP of 4 x d_model")
    return {
        "n_mels": c["num_mel_bins"], "n_vocab": c["vocab_size"],
        "n_audio_ctx": c["max_source_positions"], "n_text_ctx": c["max_target_positions"],
        "d": c["d_model"], "n_audio_head": c["encoder_attention_heads"],
        "n_text_head": c["decoder_attention_heads"], "n_audio_layer": c["encoder_layers"],
        "n_text_layer": c["decoder_layers"],
    }


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's encoder position table (float32)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def _normal_leaves(dm: dict) -> list[tuple[tuple, tuple, float]]:
    """(tree path, shape, std) of every normally drawn leaf, in draw order."""
    d, le, ld = dm["d"], dm["n_audio_layer"], dm["n_text_layer"]
    out = [(("encoder", "conv1", "w"), (d, dm["n_mels"], 3), 0.05),
           (("encoder", "conv2", "w"), (d, d, 3), 0.05)]

    def block(side, n, cross):
        names = ["attn"] + (["cross_attn"] if cross else [])
        for a in names:
            for p in ("q", "k", "v", "o"):
                out.append(((side, "layers", a, p, "w"), (n, d, d), d ** -0.5))
        out.append(((side, "layers", "mlp", "fc1", "w"), (n, d, 4 * d), d ** -0.5))
        out.append(((side, "layers", "mlp", "fc2", "w"), (n, 4 * d, d), (4 * d) ** -0.5))

    block("encoder", le, False)
    block("decoder", ld, True)
    out.append((("decoder", "embed"), (dm["n_vocab"], d), 0.02))
    out.append((("decoder", "pos"), (dm["n_text_ctx"], d), 0.01))
    return out


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def make_params(config: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The parameter tree of `config` drawn from `seed` on `device` in
    `dtype` (layer norms float32)."""
    dm = dims(config)
    dev = torch.device(device)
    leaves = _normal_leaves(dm)
    total = sum(int(np.prod(shape)) for _, shape, _ in leaves)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=dev, dtype=dtype)
    tree: dict = {}
    off = 0
    for path, shape, std in leaves:
        n = int(np.prod(shape))
        _put(tree, path, flat[off: off + n].view(shape).mul_(std))
        off += n
    d, le, ld = dm["d"], dm["n_audio_layer"], dm["n_text_layer"]

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ln(n):
        shape = (n, d) if n else (d,)
        return {"scale": torch.ones(shape, device=dev), "bias": torch.zeros(shape, device=dev)}

    for side, n, cross in (("encoder", le, False), ("decoder", ld, True)):
        lay = tree[side]["layers"]
        for a in ["attn"] + (["cross_attn"] if cross else []):
            for p in ("q", "v", "o"):
                lay[a][p]["b"] = zeros(n, d)
            lay[a + "_ln"] = ln(n)
        lay["mlp"]["fc1"]["b"] = zeros(n, 4 * d)
        lay["mlp"]["fc2"]["b"] = zeros(n, d)
        lay["mlp_ln"] = ln(n)
    enc = tree["encoder"]
    enc["conv1"]["b"] = zeros(d)
    enc["conv2"]["b"] = zeros(d)
    enc["pos"] = torch.from_numpy(sinusoids(dm["n_audio_ctx"], d)).to(dev)
    enc["ln_post"] = ln(0)
    tree["decoder"]["ln"] = ln(0)
    return tree
