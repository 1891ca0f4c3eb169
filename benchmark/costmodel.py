"""The benchmark's frozen cost model: the operations and bytes of the work a
mix defines, and the chip's published peaks.

Counts come from the traffic's own quantities (audio seconds at 50 encoder
positions a second, prompt tokens, tokens generated, the context each token
attends over), never from the program's buckets or padding, so a program
that pads less does not lower its own count. A decoder layer holds 14 d^2
of linear weights (self q, k, v, o; cross q, o; fc1 and fc2 at 4d), 28 d^2
operations a token; an encoder layer 12 d^2. A kernel's bytes count each
input byte once and each output byte once a call.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core operations and HBM3
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
POSITIONS_PER_S = 50


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, k: float) -> "Cost":
        return Cost(self.flops * k, self.bytes * k)

    def least_s(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES)

    def bound(self) -> str:
        return "compute" if self.flops / PEAK_FLOPS >= self.bytes / PEAK_BYTES else "memory"


def positions(audio_s: float) -> int:
    """Encoder positions of `audio_s` seconds of real audio."""
    return max(1, round(audio_s * POSITIONS_PER_S))


# -- model operations (mfu) ---------------------------------------------------


def encoder_flops(dm: dict, audio_s: float) -> float:
    """The conv stem and the encoder blocks over the real positions."""
    p, d = positions(audio_s), dm["d"]
    stem = 2 * (2 * p) * 3 * dm["n_mels"] * d + 2 * p * 3 * d * d
    blocks = dm["n_audio_layer"] * (2 * p * 12 * d * d + 4 * p * p * d)
    return float(stem + blocks)


def cross_kv_flops(dm: dict, audio_s: float) -> float:
    """The K and V projections of every decoder layer over the positions."""
    return float(dm["n_text_layer"] * 2 * positions(audio_s) * 2 * dm["d"] ** 2)


def decoder_token_flops(dm: dict, ctx: int, audio_s: float, logits: bool) -> float:
    """One decoder token attending over `ctx` earlier tokens (itself
    included) and the window's positions, plus its logits when taken."""
    d, L = dm["d"], dm["n_text_layer"]
    per = 2 * 14 * d * d + 4 * ctx * d + 4 * positions(audio_s) * d
    return float(L * per + (2 * d * dm["n_vocab"] if logits else 0))


def window_flops(dm: dict, audio_s: float, prompt: int, generated: int,
                 detect: bool = False) -> float:
    """A window: encode, cross-KV, (language detection,) the prompt's
    prefill with its last logits, and `generated` tokens each with logits."""
    f = encoder_flops(dm, audio_s) + cross_kv_flops(dm, audio_s)
    if detect:
        f += decoder_token_flops(dm, 1, audio_s, True)
    f += sum(decoder_token_flops(dm, i + 1, audio_s, i == prompt - 1) for i in range(prompt))
    f += sum(decoder_token_flops(dm, prompt + i + 1, audio_s, True) for i in range(generated))
    return f


# -- kernels (rooflines) ------------------------------------------------------


def k1_cost(dm: dict, audio_s: float) -> Cost:
    """K1 (fused encoder attention) over one window's real positions, every
    encoder layer: QK^T and PV, q, k, v read and out written in bf16."""
    p, d = positions(audio_s), dm["d"]
    return Cost(4.0 * p * p * d, 4.0 * p * d * 2) * dm["n_audio_layer"]


def k2_cost(dm: dict, steps: int, tokens: int) -> Cost:
    """K2 (int8 weight-only linears) over `steps` decoder steps that
    produced `tokens` tokens: each step reads the 8 L int8 weight matrices
    and their bf16 scales once, and each token's x is read and its out
    written in bf16."""
    d, L = dm["d"], dm["n_text_layer"]
    # (d_in, d_out) of self q, k, v, o; cross q, o; fc1; fc2
    shapes = [(d, d)] * 6 + [(d, 4 * d), (4 * d, d)]
    weights = sum(di * do + 2 * do for di, do in shapes)
    per_token_bytes = sum(2 * (di + do) for di, do in shapes)
    per_token_flops = sum(2 * di * do for di, do in shapes)
    return Cost(float(tokens * per_token_flops),
                float(steps * weights + tokens * per_token_bytes)) * L


def k5_cost(dm: dict, tokens: int, pos_tokens: int) -> Cost:
    """K5 (int8 cross-attention, one query a row) for `tokens` decoding rows
    over `pos_tokens` window positions in all (each row's real positions,
    summed), every decoder layer: the int8 K|V rows and q (the K scales
    folded in) read in bf16, out written in f32, each row's length and
    active flag read (the V scales apply after the kernel)."""
    d, h = dm["d"], dm["n_text_head"]
    hd = d // h
    bytes_ = h * 2 * hd * pos_tokens + tokens * (h * (2 * hd + 4 * hd) + 5)
    return Cost(4.0 * d * pos_tokens, float(bytes_)) * dm["n_text_layer"]
