"""Whisper fine-tuning in PyTorch: training forwards, loss, AdamW, the
train step and its checkpoints.

Port of whisperlive_tpu/training.py. Parameters are float32 master tensors
and `cfg.dtype` is the compute dtype, as in the JAX package. Every layer
block runs under torch.utils.checkpoint (the counterpart of
jax.checkpoint), indexing the stacked [L, ...] tensors inside the
checkpointed function, so a large model's activations are rebuilt in the
backward pass instead of kept.

The training encoder is the JAX package's `encode` at its default
`fused_encoder_attention=False`: plain attention, whose gradient autograd
takes. The port's serving `encode` runs the K1 kernel, which has no
backward pass (its wrapper raises under grad). Frozen-teacher encodes
(distill.py) run the serving `encode` under torch.no_grad().

The optimizer is AdamW with optax's semantics exactly (the JAX package's
`optax.chain(clip_by_global_norm, adamw)` over a warmup-cosine schedule):
the schedule is read at the update count before the increment, so the
first update runs at learning rate 0; the clip leaves the gradient alone
below the bound and scales it by max_norm / norm otherwise (no epsilon,
unlike torch.nn.utils.clip_grad_norm_); weight decay applies to every
leaf; eps is added to sqrt(v_hat). Updates are made in place on the
state's tensors, as torch optimizers make them.

Checkpoints are the port's own format (the JAX package writes orbax
trees, which the card's machine cannot read): `params.safetensors`,
`opt_state.safetensors` (the moments under "mu/" and "nu/") and
`train_meta.json` (the config fields, the step and the update count).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from whisperlive_tpu_torch.device import resolve_device
from whisperlive_tpu_torch.models import safetensors_io
from whisperlive_tpu_torch.models import whisper as wmod
from whisperlive_tpu_torch.parallel import mesh as pmesh

PARAMS_FILE = "params.safetensors"
OPT_FILE = "opt_state.safetensors"
META_FILE = "train_meta.json"

# optax.adamw's defaults, which the JAX package keeps
B1, B2, EPS = 0.9, 0.999, 1e-8


def _remat(fn, *args):
    """fn(*args) with its activations rebuilt in the backward pass (the
    blocks draw no random numbers, so no RNG state is kept)."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def leaves(tree: wmod.Params) -> list[torch.Tensor]:
    """The tensors of a nested dict, in key order."""
    return list(safetensors_io.flatten_tree(tree).values())


# ---------------------------------------------------------------------------
# Training forwards and the loss
# ---------------------------------------------------------------------------


def _encoder_layer(x, layers, i: int, hd: int, tp: int):
    return wmod._encoder_block(x, wmod.layer(layers, i), hd, wmod._attention, tp)


def encode_train(params: wmod.Params, cfg: wmod.WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T_mel, n_mels] -> encoder states [B, T_mel/2, d] through the
    plain attention, each block checkpointed."""
    p = params["encoder"]
    x = wmod._encoder_stem(p, cfg, mel)
    for i in range(cfg.n_audio_layer):
        x = _remat(_encoder_layer, x, p["layers"], i, cfg.audio_head_dim, cfg.tp)
    return wmod._layer_norm(x, p["ln_post"])


def _decoder_layer(x, layers, i: int, enc, causal, hd: int, tp: int):
    """One decoder layer; under tensor parallelism `enc` already passed f
    (decoder_forward_train), so its gradient sums every layer's heads."""
    lp = wmod.layer(layers, i)
    attend = functools.partial(wmod._attention, mask=causal)
    x = x + wmod._self_attention(wmod._layer_norm(x, lp["attn_ln"]), lp["attn"], hd, attend, tp)
    h = wmod._to_model(wmod._layer_norm(x, lp["cross_attn_ln"]), tp)
    ca = lp["cross_attn"]
    q = wmod._split_head_dim(wmod._linear(h, ca["q"]), hd)
    # K and V are computed in enc's dtype (the distiller keeps its feature
    # pool in bf16) and promoted to q's, as the JAX einsums promote them
    k = wmod._split_head_dim(wmod._linear(enc, ca["k"]), hd).to(q.dtype)
    v = wmod._split_head_dim(wmod._linear(enc, ca["v"]), hd).to(q.dtype)
    x = x + wmod._row_linear(wmod._merge_heads(wmod._attention(q, k, v)), ca["o"], tp)
    return x + wmod._mlp(wmod._layer_norm(x, lp["mlp_ln"]), lp["mlp"], tp)


def decoder_forward_train(params: wmod.Params, cfg: wmod.WhisperConfig, tokens: torch.Tensor,
                          enc: torch.Tensor) -> torch.Tensor:
    """Cache-free causal decoder over teacher-forced tokens [B, T] and
    encoder states [B, T_enc, d] -> float32 logits [B, T, V]. The causal
    mask fills with the float32 minimum, not -inf; the cross-attention K
    and V are projected from `enc` in every layer."""
    p = params["decoder"]
    t = tokens.shape[1]
    x = p["embed"].to(cfg.dtype)[tokens.long()] + p["pos"].to(cfg.dtype)[:t]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=tokens.device))[None, None]
    enc = wmod._to_model(enc, cfg.tp)
    for i in range(cfg.n_text_layer):
        x = _remat(_decoder_layer, x, p["layers"], i, enc, causal, cfg.head_dim, cfg.tp)
    return wmod._project_logits(params, wmod._layer_norm(x, p["ln"]))


def whisper_loss(params: wmod.Params, cfg: wmod.WhisperConfig, mel: torch.Tensor,
                 tokens_in: torch.Tensor, tokens_out: torch.Tensor,
                 loss_mask: torch.Tensor, n_masked: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Masked mean next-token cross-entropy: mel [B, T_mel, n_mels],
    tokens_in and tokens_out (the shifted targets) [B, T], loss_mask [B, T]
    float32 (0 on padding and prompt). n_masked: the mean's denominator
    when the batch is one data-parallel shard of a larger one (the global
    sum of loss_mask); the shards' losses then add up to the global mean."""
    logits = decoder_forward_train(params, cfg, tokens_in, encode_train(params, cfg, mel))
    logprobs = torch.log_softmax(logits, dim=-1)
    nll = -logprobs.gather(-1, tokens_out.long()[..., None])[..., 0]
    if n_masked is None:
        n_masked = torch.sum(loss_mask)
    return torch.sum(nll * loss_mask) / torch.clamp(n_masked, min=1.0)


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdamWState:
    mu: wmod.Params
    nu: wmod.Params
    count: int  # updates made


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Global-norm clip, then AdamW over a warmup-cosine schedule; see the
    module docstring for the semantics it shares with optax."""

    learning_rate: float
    weight_decay: float
    warmup_steps: int
    decay_steps: int
    max_grad_norm: float

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, learning_rate, warmup_steps,
        decay_steps): linear from 0 to the peak over warmup_steps, then a
        cosine to 0 at decay_steps."""
        peak, warmup = self.learning_rate, self.warmup_steps
        if count < warmup:
            return peak * (max(count, 0) / warmup)
        span = self.decay_steps - warmup
        return peak * 0.5 * (1.0 + math.cos(math.pi * min(count - warmup, span) / span))

    def init(self, params: wmod.Params) -> AdamWState:
        zeros = functools.partial(wmod.tree_map, torch.zeros_like)
        return AdamWState(zeros(params), zeros(params), 0)

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: AdamWState, params: wmod.Params,
               shardings=None) -> None:
        """One update of `params` and `state` in place; `grads` in the
        order of leaves(params). Under tensor parallelism (`shardings`
        with tp > 1) params, grads and moments are this rank's slices: the
        clip's global norm adds the model group's squares of the sliced
        leaves to those of the whole ones, and the elementwise update then
        runs on each slice."""
        ps, mus, nus = leaves(params), leaves(state.mu), leaves(state.nu)
        if not len(grads) == len(ps) == len(mus) == len(nus):
            raise ValueError("grads, params and moments must have the same leaves")
        norm = torch.sqrt(_global_sq_norm(grads, params, shardings))
        keep = norm < self.max_grad_norm
        lr = self.schedule(state.count)
        state.count += 1
        # optax computes the bias corrections in float32
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(state.count))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(state.count))
        for p, g, m, v in zip(ps, grads, mus, nus):
            g = torch.where(keep, g, g / norm * self.max_grad_norm)
            m.mul_(B1).add_(g, alpha=1 - B1)
            v.mul_(B2).addcmul_(g, g, value=1 - B2)
            step = (m / bc1) / (torch.sqrt(v / bc2) + EPS) + self.weight_decay * p
            p.add_(step, alpha=-lr)


def _global_sq_norm(grads: list[torch.Tensor], params: wmod.Params, shardings) -> torch.Tensor:
    """The squared global norm of the gradient: at tp > 1 the sliced
    leaves' squares are summed over the model group, the whole leaves'
    (the same on every rank of the group) counted once."""
    squares = [torch.sum(g * g) for g in grads]
    if shardings is None or shardings.tp == 1:
        return torch.stack(squares).sum()
    sliced = [a is not None for a in safetensors_io.flatten_tree(
        shardings.param_specs(params)).values()]
    part = torch.stack([q for q, s in zip(squares, sliced) if s]).sum()
    dist.all_reduce(part, group=shardings.model_group)
    whole = [q for q, s in zip(squares, sliced) if not s]
    return part + (torch.stack(whole).sum() if whole else 0.0)


def make_optimizer(learning_rate: float = 1e-5, weight_decay: float = 0.01,
                   warmup_steps: int = 100, total_steps: int = 10_000,
                   max_grad_norm: float = 1.0) -> AdamW:
    return AdamW(learning_rate, weight_decay, warmup_steps,
                 max(total_steps, warmup_steps + 1), max_grad_norm)


# ---------------------------------------------------------------------------
# The train step and its state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    params: wmod.Params  # float32 master tensors
    opt_state: AdamWState
    step: int


def value_and_grad(loss_fn, params: wmod.Params) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """(loss_fn(), d loss / d leaves(params)) with grad taken only for the
    call: the tensors of `params` never keep requires_grad."""
    ps = leaves(params)
    with torch.enable_grad():
        for p in ps:
            p.requires_grad_(True)
        try:
            loss = loss_fn()
            grads = torch.autograd.grad(loss, ps)
        finally:
            for p in ps:
                p.requires_grad_(False)
    return loss.detach(), list(grads)


def make_train_step(cfg: wmod.WhisperConfig, optimizer: AdamW, shardings=None):
    """-> train_step(state, batch) -> (state, loss): one AdamW update of
    state in place on whisper_loss over batch {"mel", "tokens_in",
    "tokens_out", "loss_mask"}.

    Under a [dp, tp] grid (`shardings`, parallel/mesh.py) every rank
    passes its slice of the parameters (shard_params; init_train_state
    with shardings) and its shard of the global batch
    (multihost.local_batch_to_global): the model's f and g carry the
    tensor-parallel collectives, each shard's loss is taken over the
    global token count and the data group sums the shards' gradients, so
    the step is the single-device step on the global batch, and every rank
    returns the same global loss."""
    if shardings is not None:
        shardings.validate(cfg)
        cfg = cfg.replace(tp=shardings.tp)
    data_parallel = shardings is not None and shardings.dp > 1

    def train_step(state: TrainState, batch: dict):
        n_masked = None
        if data_parallel:
            n_masked = torch.sum(batch["loss_mask"]).float()
            dist.all_reduce(n_masked, group=shardings.data_group)
        loss, grads = value_and_grad(lambda: whisper_loss(
            state.params, cfg, batch["mel"], batch["tokens_in"], batch["tokens_out"],
            batch["loss_mask"], n_masked), state.params)
        if data_parallel:
            for g in grads:
                dist.all_reduce(g, group=shardings.data_group)
            dist.all_reduce(loss, group=shardings.data_group)
        optimizer.update(grads, state.opt_state, state.params, shardings)
        state.step += 1
        return state, loss

    return train_step


def init_train_state(cfg: wmod.WhisperConfig, optimizer: AdamW,
                     params: wmod.Params | None = None, seed: int = 0,
                     device: torch.device | str = "cuda", shardings=None) -> TrainState:
    """A state on `device` over float32 copies of `params` (random from
    `seed` when None): the caller's tensors are never updated. With
    `shardings`, `params` is the full tree and the state holds this rank's
    slice of it (every rank draws or loads the whole tree and keeps its
    slice)."""
    dev = resolve_device(device)
    if params is None:
        params = wmod.init_params(cfg, seed, device=dev)
    if shardings is not None:
        params = pmesh.shard_params(params, shardings)
    master = wmod.tree_map(lambda t: t.detach().to(dev, torch.float32, copy=True), params)
    return TrainState(master, optimizer.init(master), 0)


def gather_state(state: TrainState, shardings) -> TrainState:
    """The whole state from the model group's slices (a collective every
    rank of the group enters): parameters and both moments."""
    if shardings is None or shardings.tp == 1:
        return state
    specs = shardings.param_specs(state.params)
    whole = functools.partial(pmesh.gather_params, specs=specs, shardings=shardings)
    opt = AdamWState(whole(state.opt_state.mu), whole(state.opt_state.nu),
                     state.opt_state.count)
    return TrainState(whole(state.params), opt, state.step)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, state: TrainState, cfg: wmod.WhisperConfig) -> None:
    os.makedirs(path, exist_ok=True)
    safetensors_io.save_tree(state.params, os.path.join(path, PARAMS_FILE))
    safetensors_io.save_tree({"mu": state.opt_state.mu, "nu": state.opt_state.nu},
                             os.path.join(path, OPT_FILE))
    meta = {k: v for k, v in dataclasses.asdict(cfg).items() if k not in ("dtype", "tp")}
    meta.update(step=int(state.step), opt_count=int(state.opt_state.count))
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, device: torch.device | str = "cuda"
                    ) -> tuple[TrainState, wmod.WhisperConfig]:
    """Restore a checkpoint of save_checkpoint onto `device`. The JAX
    package's orbax checkpoints are refused."""
    dev = resolve_device(device)
    if not os.path.exists(os.path.join(path, PARAMS_FILE)):
        if os.path.isdir(os.path.join(path, "params")):
            raise ValueError(
                f"{path} is an orbax training checkpoint of the JAX package, which the "
                "PyTorch port cannot read: resume it with the JAX package, or start the "
                "port's training from the HF checkpoint it was trained from")
        raise ValueError(f"{path} holds no training checkpoint ({PARAMS_FILE})")
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    step, count = meta.pop("step"), meta.pop("opt_count")
    cfg = wmod.WhisperConfig(**meta)

    def load(name):
        return wmod.tree_map(lambda t: t.to(dev),
                             safetensors_io.load_tree(os.path.join(path, name)))

    moments = load(OPT_FILE)
    return TrainState(load(PARAMS_FILE), AdamWState(moments["mu"], moments["nu"], count),
                      step), cfg
