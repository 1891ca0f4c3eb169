"""Rank grids, process groups and parameter slices for tensor and data
parallelism over torch.distributed.

Port of whisperlive_tpu/parallel/mesh.py. The JAX package drives every
local device from one process over a ("data", "model") Mesh and lets XLA
insert the collectives; here each rank of the grid is a process of its
own. The ranks form a [dp, tp] grid with rank = dp_index * tp + tp_index,
as np.asarray(devices).reshape(dp, tp) lays out the JAX mesh, so a tensor
parallel group ("model") is a run of consecutive ranks and a data group
("data") strides by tp.

Sharding rules (Megatron-style, over the stacked-layer parameter tree;
`param_spec` follows the JAX `_param_spec` rule for rule):

    q / k / v projections  [.., d, d]   column-parallel: w and b sliced on
    mlp fc1                [.., d, 4d]  the output axis
    output projection o    [.., d, d]   row-parallel: w sliced on the input
    mlp fc2                [.., 4d, d]  axis, b whole
    embeddings / layer norms / convs / positions   whole on every rank

Each rank holds n_head / tp heads and 4d / tp MLP units. The model
(models/whisper.py) all-reduces the partial sums of a row-parallel linear
over the model group and adds its bias once after the reduce; two
autograd functions carry the training collectives: `copy_to_model` (f:
identity forward, all-reduce backward) at the input of a column-parallel
block and `reduce_from_model` (g: all-reduce forward, identity backward)
at the output of a row-parallel one. Serving runs g's forward only.
"""

from __future__ import annotations

import datetime
import logging
from typing import Any, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# the model group of this process's rank, set by make_mesh: the
# row-parallel reduce of models/whisper.py runs over it
_MODEL_GROUP = None


def pick_backend(device: torch.device, local_ranks: int) -> str:
    """NCCL when every local rank has a CUDA device of its own; gloo on the
    same CUDA tensors when ranks share a device (NCCL refuses two ranks on
    one GPU); gloo on CPU tensors for a CPU run."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def rank_device(device: str | torch.device, local_rank: int) -> torch.device:
    """Rank local_rank's device: cuda:(local_rank % device_count) for a
    CUDA run (raising without a card), the CPU for a CPU run."""
    from whisperlive_tpu_torch.device import resolve_device

    dev = resolve_device(torch.device(device).type)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def init_process_group(rank: int, world_size: int, address: str,
                       device: str | torch.device = "cuda", local_ranks: int = 1,
                       local_rank: int = 0, timeout_s: Optional[float] = None
                       ) -> tuple[str, torch.device]:
    """Join the world at `address` ("host:port" of rank 0's rendezvous) as
    `rank` of `world_size`. -> (backend, this rank's device). The backend
    is logged: gloo with ranks sharing a card is not a CPU fallback, the
    tensors and kernels stay on the card. timeout_s bounds how long a
    collective waits for a rank that never comes (torch's default else)."""
    dev = rank_device(device, local_rank)
    backend = pick_backend(dev, local_ranks)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world_size, rank=rank, **kw)
    logger.info("rank %d/%d on %s over %s (%d local ranks, %d devices)", rank, world_size,
                dev, backend, local_ranks,
                torch.cuda.device_count() if dev.type == "cuda" else 0)
    return backend, dev


class EngineShardings:
    """This rank's place in the [dp, tp] grid, its process groups and the
    rows of a slot pool it owns. Without groups (tests of the slicing
    rules) it describes a rank and runs no collective."""

    def __init__(self, tp: int = 1, dp: int = 1, rank: int = 0, model_group=None,
                 data_group=None, backend: Optional[str] = None):
        self.tp, self.dp, self.rank = int(tp), int(dp), int(rank)
        if self.rank >= self.tp * self.dp:
            raise ValueError(f"rank {rank} outside the dp({dp}) x tp({tp}) grid")
        self.model_group = model_group
        self.data_group = data_group
        self.backend = backend

    @classmethod
    def create(cls, tp: int = 1, dp: Optional[int] = None) -> "EngineShardings":
        return make_mesh(tp=tp, dp=dp)

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    def data_rank(self, dp_index: int) -> int:
        """Global rank of the member of this rank's data group at dp_index."""
        return dp_index * self.tp + self.tp_index

    def owned_rows(self, n_rows: int) -> range:
        """The rows [dp_index * n / dp, (dp_index + 1) * n / dp) of an
        n-row pool this rank's data replica owns."""
        per = n_rows // self.dp
        return range(self.dp_index * per, (self.dp_index + 1) * per)

    def validate(self, cfg) -> None:
        tp = self.tp
        if cfg.n_audio_head % tp or cfg.n_text_head % tp:
            raise ValueError(
                f"tp={tp} must divide attention heads "
                f"({cfg.n_audio_head} enc / {cfg.n_text_head} dec)"
            )

    def param_specs(self, params) -> Any:
        """The tree of param_spec axes of `params`."""
        return _map_with_path(lambda path, leaf: param_spec(path, leaf), params)


def make_mesh(tp: int = 1, dp: Optional[int] = None) -> EngineShardings:
    """The [dp, tp] grid over the initialized world: one model group per
    run of tp consecutive ranks and one data group per tp index (every
    rank creates every group, in the same order, as torch.distributed
    requires). A one-rank world needs no process group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dp is None:
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"dp({dp}) * tp({tp}) != world size ({world})")
    global _MODEL_GROUP
    if world == 1:
        _MODEL_GROUP = None
        return EngineShardings(tp, dp, rank)
    mine_m = mine_d = None
    for d in range(dp):
        g = dist.new_group(list(range(d * tp, (d + 1) * tp)))
        if rank // tp == d:
            mine_m = g
    for t in range(tp):
        g = dist.new_group(list(range(t, world, tp)))
        if rank % tp == t:
            mine_d = g
    _MODEL_GROUP = mine_m if tp > 1 else None
    return EngineShardings(tp, dp, rank, mine_m, mine_d, dist.get_backend())


# ---------------------------------------------------------------------------
# Slicing rules
# ---------------------------------------------------------------------------


def _map_with_path(fn, tree, path: tuple = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_spec(path: tuple, leaf) -> Optional[int]:
    """The axis of one parameter leaf that is sliced over the model group
    (None: whole on every rank), by its path in the tree. The int8 leaves
    of a quantized decoder follow their float weight: w8 as w, a column
    linear's per-output-channel scale s as its output axis, a row linear's
    s whole (each output channel's scale spans the full input axis)."""
    names = list(path)
    ndim = leaf.ndim
    if "layers" not in names or len(names) < 2:
        return None
    leaf_name, parent = names[-1], names[-2]
    if parent in ("q", "k", "v", "o") and len(names) >= 3 and names[-3] in (
            "attn", "cross_attn"):
        row = parent == "o"
    elif parent in ("fc1", "fc2"):
        row = parent == "fc2"
    else:
        return None
    if leaf_name in ("w", "w8"):
        return ndim - 2 if row else ndim - 1
    if leaf_name in ("b", "s"):
        return None if row else ndim - 1
    return None


def shard_params(params, shardings: EngineShardings):
    """This rank's slice of a full parameter tree (float or quantized):
    contiguous copies of the model-group slices of param_spec, every other
    leaf as is. Quantize before slicing: a row-parallel shard quantized
    alone gets other scales than the reference's global ones."""
    tp, i = shardings.tp, shardings.tp_index
    if tp == 1:
        return params

    def cut(path, leaf):
        axis = param_spec(path, leaf)
        if axis is None:
            return leaf
        n = leaf.shape[axis]
        if n % tp:
            raise ValueError(f"{'/'.join(path)}: axis {axis} of {tuple(leaf.shape)} "
                             f"does not divide tp={tp}")
        return leaf.narrow(axis, i * (n // tp), n // tp).contiguous()

    return _map_with_path(cut, params)


def gather_params(tree, specs, shardings: EngineShardings):
    """Inverse of shard_params over the model group: every leaf whole on
    every rank of the group (a collective all of them enter)."""
    if shardings.tp == 1:
        return tree

    def join(path, leaf):
        axis = _get(specs, path)
        if axis is None:
            return leaf
        parts = [torch.empty_like(leaf) for _ in range(shardings.tp)]
        dist.all_gather(parts, leaf.contiguous(), group=shardings.model_group)
        return torch.cat(parts, dim=axis)

    return _map_with_path(join, tree)


def params_fingerprint(params) -> tuple:
    """Cheap weight fingerprint: float32 sums of three leaves (the first,
    middle and last path in sorted order) of a WHOLE parameter tree. Every
    rank loads or draws the whole tree before keeping its slice, so the
    engine takes this before slicing and it agrees across ranks iff the
    weights do: it catches the silent-wrong-tokens failure of a follower
    launched with another checkpoint or seed."""
    from whisperlive_tpu_torch.models.safetensors_io import flatten_tree

    flat = flatten_tree(params)
    keys = sorted(flat)
    picks = [keys[0], keys[len(keys) // 2], keys[-1]]
    with torch.no_grad():
        return tuple((k, float(flat[k].float().sum())) for k in picks)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# The collectives of a tensor-parallel block
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    """f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """f at the input of a column-parallel block (identity when no gradient
    flows: serving)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, _require_group())


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """g at the output of a row-parallel block: the partial sums of the
    model group added up (in place on a fresh tensor when no gradient
    flows)."""
    group = _require_group()
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, group)
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def _require_group():
    if _MODEL_GROUP is None:
        raise RuntimeError("a tensor-parallel model runs without a model group: "
                           "build the rank grid with parallel.mesh.make_mesh first")
    return _MODEL_GROUP

