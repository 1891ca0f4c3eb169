"""Carry a JAX Whisper parameter tree over to the port's tensors.

`from_jax_params` takes the nested dict of numpy arrays that
`jax.tree.map(np.asarray, params)` gives for a whisperlive_tpu parameter
pytree (float or quantized: `w8`/`s`, `embed8`/`embed_s`) and returns the
same tree of torch tensors. The stacked [L, ...] layer axis and the
[d_in, d_out] linear layout are kept, so the int8 kernels read the same
bytes as the TPU kernels; conv kernels go from JAX's [k, in, out] to
torch's [out, in, k]. bfloat16 arrays (ml_dtypes) are reinterpreted bit
for bit. This module imports no JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _to_tensor(arr: Any) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def from_jax_params(tree: dict, device: torch.device | str = "cpu") -> dict:
    def walk(node: Any, path: tuple[str, ...]) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        t = _to_tensor(node)
        if len(path) >= 2 and path[-2] in ("conv1", "conv2") and path[-1] == "w":
            t = t.permute(2, 1, 0).contiguous()  # [k, in, out] -> [out, in, k]
        return t.to(device)

    return walk(tree, ())
