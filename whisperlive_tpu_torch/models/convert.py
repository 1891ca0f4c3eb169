"""HF Whisper checkpoint -> the port's parameter tree, and the converted cache.

Port of whisperlive_tpu/models/convert.py: a `transformers` Whisper
checkpoint (safetensors, single-file or sharded, or an in-memory
state_dict) becomes the port's stacked-layer tree directly. HF linear
weights [out, in] become [d_in, d_out]; HF conv weights are already torch's
[out, in, k] and stay so; the encoder's `embed_positions` may be absent
(sinusoids then); `proj_out` is tied to the token embedding and is not
read. Leaves keep the checkpoint's dtype: the engine casts them.

The JAX package caches converted trees as orbax checkpoints, which cannot be
read without JAX's stack. The port's converted directory is its own:
`params.safetensors` (the tree, keys joined with "/"), `config.json` (the
WhisperConfig fields plus any extra metadata) and `tokenizer.json` when the
source has one. `load_converted` refuses an orbax directory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Mapping

import numpy as np
import torch

from whisperlive_tpu_torch.models import safetensors_io
from whisperlive_tpu_torch.models.whisper import Params, WhisperConfig, sinusoids

PARAMS_FILE = "params.safetensors"


def config_from_hf(hf_config: Mapping[str, Any]) -> WhisperConfig:
    """Map transformers WhisperConfig fields to the architecture config."""
    return WhisperConfig(
        n_mels=hf_config["num_mel_bins"],
        n_vocab=hf_config["vocab_size"],
        n_audio_ctx=hf_config.get("max_source_positions", 1500),
        n_audio_state=hf_config["d_model"],
        n_audio_head=hf_config["encoder_attention_heads"],
        n_audio_layer=hf_config["encoder_layers"],
        n_text_ctx=hf_config.get("max_target_positions", 448),
        n_text_state=hf_config["d_model"],
        n_text_head=hf_config["decoder_attention_heads"],
        n_text_layer=hf_config["decoder_layers"],
    )


def _t(x) -> torch.Tensor:
    """torch tensor or numpy array -> a CPU tensor of the same dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.asarray(x))


def _linear(sd: Mapping[str, Any], prefix: str, bias: bool = True) -> Params:
    p = {"w": _t(sd[f"{prefix}.weight"]).T}
    if bias:
        p["b"] = _t(sd[f"{prefix}.bias"])
    return p


def _ln(sd: Mapping[str, Any], prefix: str) -> Params:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _attn(sd: Mapping[str, Any], prefix: str, k_bias: bool = False) -> Params:
    """One HF attention block. k_bias=False is Whisper's convention (no
    key-projection bias); M2M100 (models/m2m100.py) sets True."""
    return {
        "q": _linear(sd, f"{prefix}.q_proj"),
        "k": _linear(sd, f"{prefix}.k_proj", bias=k_bias),
        "v": _linear(sd, f"{prefix}.v_proj"),
        "o": _linear(sd, f"{prefix}.out_proj"),
    }


def _block(sd: Mapping[str, Any], prefix: str, cross: bool, k_bias: bool = False) -> Params:
    p = {
        "attn": _attn(sd, f"{prefix}.self_attn", k_bias),
        "attn_ln": _ln(sd, f"{prefix}.self_attn_layer_norm"),
        "mlp": {"fc1": _linear(sd, f"{prefix}.fc1"), "fc2": _linear(sd, f"{prefix}.fc2")},
        "mlp_ln": _ln(sd, f"{prefix}.final_layer_norm"),
    }
    if cross:
        p["cross_attn"] = _attn(sd, f"{prefix}.encoder_attn", k_bias)
        p["cross_attn_ln"] = _ln(sd, f"{prefix}.encoder_attn_layer_norm")
    return p


def _stack(blocks: list[Params]) -> Params:
    """Per-layer trees -> one tree of [L, ...] tensors."""
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return torch.stack(blocks)


def params_from_state_dict(state_dict: Mapping[str, Any], cfg: WhisperConfig) -> Params:
    """Convert a transformers WhisperForConditionalGeneration state_dict
    (`model.`-prefixed keys) or a WhisperModel one (bare `encoder.` keys)."""
    sd = dict(state_dict)
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}

    if "encoder.embed_positions.weight" in sd:
        enc_pos = _t(sd["encoder.embed_positions.weight"])
    else:  # sinusoidal; some checkpoints omit it
        enc_pos = torch.from_numpy(sinusoids(cfg.n_audio_ctx, cfg.n_audio_state))
    return {
        "encoder": {
            "conv1": {"w": _t(sd["encoder.conv1.weight"]), "b": _t(sd["encoder.conv1.bias"])},
            "conv2": {"w": _t(sd["encoder.conv2.weight"]), "b": _t(sd["encoder.conv2.bias"])},
            "pos": enc_pos,
            "layers": _stack([_block(sd, f"encoder.layers.{i}", cross=False)
                              for i in range(cfg.n_audio_layer)]),
            "ln_post": _ln(sd, "encoder.layer_norm"),
        },
        "decoder": {
            "embed": _t(sd["decoder.embed_tokens.weight"]),
            "pos": _t(sd["decoder.embed_positions.weight"]),
            "layers": _stack([_block(sd, f"decoder.layers.{i}", cross=True)
                              for i in range(cfg.n_text_layer)]),
            "ln": _ln(sd, "decoder.layer_norm"),
        },
    }


def load_hf_checkpoint(model_dir: str) -> tuple[WhisperConfig, Params]:
    """An on-disk HF Whisper checkpoint directory (config.json and
    model.safetensors, or shards with model.safetensors.index.json)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    return cfg, params_from_state_dict(safetensors_io.load_dir(model_dir), cfg)


def save_converted(path: str, cfg: WhisperConfig, params: Params,
                   extra_meta: dict | None = None, tokenizer_file: str | None = None) -> None:
    """Write a converted directory. extra_meta rides in config.json under
    keys load_converted ignores (a distilled draft records
    `distill_enc_ctx`, so that serving can warn when a draft is deployed at
    another encoder context than it was trained for)."""
    os.makedirs(path, exist_ok=True)
    safetensors_io.save_tree(params, os.path.join(path, PARAMS_FILE))
    meta = {k: v for k, v in dataclasses.asdict(cfg).items() if k not in ("dtype", "tp")}
    meta.update(extra_meta or {})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(meta, f)
    if tokenizer_file:
        shutil.copy(tokenizer_file, os.path.join(path, "tokenizer.json"))


def load_converted(path: str) -> tuple[WhisperConfig, Params]:
    if not os.path.exists(os.path.join(path, PARAMS_FILE)):
        if os.path.isdir(os.path.join(path, "params")):
            raise ValueError(
                f"{path} is an orbax checkpoint of the JAX package, which the PyTorch port "
                "cannot read: point the port at the HF checkpoint directory it was "
                "converted from (or convert that with whisperlive_tpu_torch.cli.convert)"
            )
        raise ValueError(f"{path} holds neither an HF checkpoint nor a converted one "
                         f"({PARAMS_FILE})")
    fields = {f.name for f in dataclasses.fields(WhisperConfig)} - {"dtype", "tp"}
    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    cfg = WhisperConfig(**{k: v for k, v in meta.items() if k in fields})
    return cfg, safetensors_io.load_tree(os.path.join(path, PARAMS_FILE))
