"""Model resolution shared by the port's CLIs: a size name or a checkpoint
dir -> (cfg, params, tokenizer) or a built WhisperEngine.

Port of whisperlive_tpu/loader.py: one copy of the checkpoint-format
detection (HF safetensors vs the port's converted dir), the tokenizer.json
pickup and the random-init fallback, for the server CLI and the offline
transcription CLI.
"""

from __future__ import annotations

import json
import logging
import os

import torch

logger = logging.getLogger(__name__)


def resolve_model(size: str, ckpt: str | None, dtype: torch.dtype | None = None,
                  device: str | torch.device = "cuda", seed: int = 0):
    """-> (cfg, params, tokenizer | None). `ckpt` (an HF or converted dir)
    wins over `size`, and its tree is returned on the host in the
    checkpoint's dtype; without one, params are RANDOM at `size`'s shape,
    drawn from `seed` on `device` in `dtype` (bfloat16 on CUDA, float32 on
    the CPU by default)."""
    from whisperlive_tpu_torch.device import default_compute_dtype, resolve_device
    from whisperlive_tpu_torch.models import convert as convert_mod
    from whisperlive_tpu_torch.models.safetensors_io import INDEX_FILE
    from whisperlive_tpu_torch.models.whisper import WHISPER_CONFIGS, init_params

    dev = resolve_device(device)
    if ckpt:
        ckpt = os.path.expanduser(ckpt)
        if not os.path.isdir(ckpt):
            raise FileNotFoundError(f"checkpoint dir {ckpt!r} does not exist")
        if any(os.path.exists(os.path.join(ckpt, f)) for f in ("model.safetensors", INDEX_FILE)):
            cfg, params = convert_mod.load_hf_checkpoint(ckpt)
        else:
            cfg, params = convert_mod.load_converted(ckpt)
        tokenizer = None
        tok_file = os.path.join(ckpt, "tokenizer.json")
        if os.path.exists(tok_file):
            # the card's machine has no `tokenizers`: reach it only here
            from whisperlive_tpu_torch.engine.tokenizer import WhisperTokenizer

            tokenizer = WhisperTokenizer.from_files(
                cfg.n_vocab, tok_file, multilingual=cfg.n_vocab >= 51865
            )
        return cfg, params, tokenizer

    if size not in WHISPER_CONFIGS:
        raise SystemExit(f"unknown model size {size!r}")
    cfg = WHISPER_CONFIGS[size]
    logger.warning(
        "no checkpoint for %s: initializing RANDOM weights from seed %d (pass a "
        "converted or HF checkpoint dir for real output)", size, seed,
    )
    return cfg, init_params(cfg, seed, dtype or default_compute_dtype(dev), dev), None


def load_engine(size: str, ckpt: str | None, device: str | torch.device = "cuda",
                compute_dtype: torch.dtype | None = None, seed: int = 0, shardings=None):
    """resolve_model + a WhisperEngine on `device` with the engine's
    defaults (compute dtype, decoder and cross-KV widths, buckets). With
    `shardings` (parallel/mesh.py) every rank loads or draws the whole tree
    and the engine keeps this rank's slice."""
    from whisperlive_tpu_torch.engine.engine import WhisperEngine

    cfg, params, tokenizer = resolve_model(size, ckpt, compute_dtype, device, seed)
    return WhisperEngine(cfg, params, tokenizer=tokenizer, device=device,
                         compute_dtype=compute_dtype, shardings=shardings)


def draft_distill_ctx(ckpt: str | None) -> int | None:
    """The `distill_enc_ctx` a draft checkpoint was trained at (None when
    unknown). A draft only agrees with its target at the encoder context it
    was distilled at, so serving layers warn when deploying a draft at
    another context."""
    if not ckpt:
        return None
    path = os.path.join(os.path.expanduser(ckpt), "config.json")
    try:
        with open(path) as f:
            return json.load(f).get("distill_enc_ctx")
    except (OSError, ValueError):
        return None
