"""Read and write the safetensors format without the `safetensors` package.

The card's machine has no `safetensors`, and HF Whisper checkpoints ship in
this format. A file is an 8-byte little-endian header length N, N bytes of
JSON header ({name: {"dtype", "shape", "data_offsets": [begin, end]}}, plus
an optional "__metadata__" of strings), then the raw little-endian tensor
buffers, the offsets counted from the end of the header. A sharded
checkpoint adds `model.safetensors.index.json`, whose "weight_map" names the
file of each tensor.

Reading maps the file (np.memmap, copy-on-write) and returns tensors that
view the mapping, so a 3 GB checkpoint is not copied on the host before the
converter stacks its layers.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

# safetensors dtype code -> (torch dtype, numpy dtype of the raw buffer);
# bfloat16 buffers are read as uint16 and reinterpreted
DTYPES = {
    "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16),
    "BF16": (torch.bfloat16, np.uint16),
    "I64": (torch.int64, np.int64),
    "I8": (torch.int8, np.int8),
}
_CODES = {t: code for code, (t, _) in DTYPES.items()}
INDEX_FILE = "model.safetensors.index.json"


def read_header(path: str) -> tuple[dict, int]:
    """-> (header without "__metadata__", offset of the first data byte)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: too short for a safetensors header")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file, as CPU tensors over a
    copy-on-write mapping of the file."""
    header, start = read_header(path)
    size = os.path.getsize(path)
    mapped = np.memmap(path, dtype=np.uint8, mode="c") if size > start else None
    out = {}
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        t_dtype, np_dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        n_bytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(np_dtype).itemsize
        if end - begin != n_bytes or start + end > size:
            raise ValueError(f"{path}: tensor {name!r} has offsets {begin}..{end} for "
                             f"{n_bytes} bytes in a {size}-byte file")
        if n_bytes == 0:
            out[name] = torch.empty(shape, dtype=t_dtype)
            continue
        arr = mapped[start + begin : start + end].view(np_dtype).reshape(shape)
        if arr.ctypes.data % arr.itemsize:  # a misaligned buffer is copied
            arr = np.array(arr)
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if t_dtype == torch.bfloat16 else t
    return out


def load_dir(model_dir: str) -> dict[str, torch.Tensor]:
    """The state dict of a checkpoint directory: `model.safetensors`, or the
    shards that `model.safetensors.index.json` names."""
    index_path = os.path.join(model_dir, INDEX_FILE)
    if not os.path.exists(index_path):
        return load_file(os.path.join(model_dir, "model.safetensors"))
    with open(index_path) as f:
        weight_map = json.load(f)["weight_map"]
    sd: dict[str, torch.Tensor] = {}
    for shard in sorted(set(weight_map.values())):
        sd.update(load_file(os.path.join(model_dir, shard)))
    missing = sorted(set(weight_map) - set(sd))
    if missing:
        raise ValueError(f"{model_dir}: the index names tensors no shard holds: {missing[:5]}")
    return sd


def save_file(tensors: dict[str, torch.Tensor], path: str,
              metadata: dict[str, str] | None = None) -> None:
    """Write tensors (any device; contiguous copies are made on the host) in
    the safetensors format, the header padded with spaces to 8 bytes and the
    buffers ordered by element size, then name, so that each is aligned to
    its element size (as the reference writer does)."""
    names = sorted(tensors, key=lambda n: (-tensors[n].element_size(), n))
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _CODES:
            raise ValueError(f"tensor {name!r} has unsupported dtype {t.dtype}")
        n_bytes = t.numel() * t.element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n_bytes]}
        offset += n_bytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().contiguous().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(t.numpy().data)


def flatten_tree(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """{path: tensor} of a nested dict of tensors, in key order, each path
    its keys joined with "/" (the names save_tree writes)."""
    out = {}
    for k, v in tree.items():
        out.update(flatten_tree(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def save_tree(tree: dict, path: str) -> None:
    """Write a nested dict of tensors as one file, its keys joined with "/"."""
    save_file(flatten_tree(tree), path)


def load_tree(path: str) -> dict:
    """The nested dict of tensors save_tree wrote (CPU tensors over a
    copy-on-write mapping of the file, as load_file returns them)."""
    tree: dict = {}
    for key, v in load_file(path).items():
        *parents, leaf = key.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree
