"""Checkpoint conversion CLI: HF Whisper dir -> the port's converted dir.

    python -m whisperlive_tpu_torch.cli.convert /path/to/hf-whisper-large-v3 \
        --output ~/.cache/whisper-live-tpu/large-v3-torch

Port of whisperlive_tpu/cli/convert.py. The output is the port's own
format (models/convert.py: `params.safetensors` + `config.json` +
`tokenizer.json`), not the JAX package's orbax tree. `--verify` holds the
converted encoder against `transformers` on the CPU within 5e-3, where
`transformers` is installed.
"""

from __future__ import annotations

import argparse
import logging
import os

VERIFY_TOL = 5e-3


def verify_encoder(model_dir: str, cfg, params) -> float | None:
    """Max |encoder - transformers' encoder| on a random mel, on the CPU in
    float32; None when `transformers` is not installed."""
    try:
        from transformers import WhisperForConditionalGeneration
    except ImportError:
        return None
    import numpy as np
    import torch

    from whisperlive_tpu_torch.models import whisper as wmod

    model = WhisperForConditionalGeneration.from_pretrained(
        model_dir, torch_dtype=torch.float32).eval()
    mel = np.random.default_rng(0).standard_normal((1, 2 * cfg.n_audio_ctx, cfg.n_mels))
    mel = torch.from_numpy(mel.astype(np.float32))
    tree = wmod.cast_params(params, torch.float32, "cpu")
    with torch.inference_mode():
        ref = model.model.encoder(mel.transpose(1, 2)).last_hidden_state
        ours = wmod.encode(tree, cfg.replace(dtype=torch.float32), mel)
    return float((ours - ref).abs().max())


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description="convert HF Whisper -> whisperlive-tpu-torch")
    parser.add_argument("model_dir", help="HF checkpoint dir (config.json + *.safetensors)")
    parser.add_argument("--output", "-o", required=True, help="output dir")
    parser.add_argument("--verify", action="store_true",
                        help="hold the converted encoder against transformers' "
                             f"(within {VERIFY_TOL}; needs transformers)")
    args = parser.parse_args(argv)

    from whisperlive_tpu_torch.models import convert as convert_mod

    cfg, params = convert_mod.load_hf_checkpoint(args.model_dir)
    logging.info("loaded %s: %d-layer enc / %d-layer dec, d=%d, vocab=%d",
                 args.model_dir, cfg.n_audio_layer, cfg.n_text_layer,
                 cfg.n_audio_state, cfg.n_vocab)
    if args.verify:
        err = verify_encoder(args.model_dir, cfg, params)
        if err is None:
            logging.warning("--verify skipped: transformers is not installed")
        else:
            logging.info("encoder parity max abs err: %.2e", err)
            if not err < VERIFY_TOL:
                raise SystemExit(f"conversion parity check failed: {err:.3e} >= {VERIFY_TOL}")

    tok = os.path.join(args.model_dir, "tokenizer.json")
    convert_mod.save_converted(args.output, cfg, params,
                               tokenizer_file=tok if os.path.exists(tok) else None)
    logging.info("saved converted checkpoint to %s", args.output)


if __name__ == "__main__":
    main()
