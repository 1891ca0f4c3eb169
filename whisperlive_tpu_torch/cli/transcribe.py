"""Offline file transcription CLI of the port (`whisperlive-tpu-torch-transcribe`).

    python -m whisperlive_tpu_torch.cli.transcribe a.wav b.flac --model large-v3 \
        -tpu <checkpoint dir> -f srt -o out/

Port of whisperlive_tpu/cli/transcribe.py: the seek loop with temperature
fallback, word timestamps, the VAD filter, txt/srt/vtt/json output, the
batched pipeline (`--batched`) and speculative decoding with a draft
(`--draft_model` / `--draft_path`). The engine runs on `--device` (CUDA by
default; a missing card is an error, `--device cpu` runs on the CPU).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="whisperlive-tpu-torch offline transcription")
    p.add_argument("files", nargs="+", help="Audio files (wav/flac, others through PyAV).")
    p.add_argument("--model", "-m", default="small",
                   help="Model size for random init (ignored with a checkpoint).")
    p.add_argument("-tpu", "--tpu_model_path", default=None,
                   help="Converted checkpoint dir or HF checkpoint dir.")
    p.add_argument("--draft_model", default=None,
                   help="Distil-family draft size for speculative decoding "
                        "(e.g. distil-large-v3; must share the target's "
                        "encoder geometry and vocab).")
    p.add_argument("--draft_path", default=None,
                   help="Checkpoint dir for the draft model.")
    p.add_argument("--spec_k", type=int, default=4,
                   help="Speculation depth (draft tokens per verify pass).")
    p.add_argument("--language", "-l", default=None)
    p.add_argument("--task", default="transcribe",
                   choices=["transcribe", "translate"])
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--word_timestamps", action="store_true")
    p.add_argument("--vad_filter", action="store_true")
    p.add_argument("--initial_prompt", default=None)
    p.add_argument("--hotwords", default=None)
    p.add_argument("--max_new_tokens", type=int, default=None)
    p.add_argument("--no_gates", action="store_true",
                   help="Disable quality-gate fallbacks (useful with random "
                        "weights, which never pass the gates).")
    p.add_argument("--output_format", "-f", default="txt",
                   choices=["txt", "srt", "vtt", "json"])
    p.add_argument("--output_dir", "-o", default=None,
                   help="Write <stem>.<fmt> files here (default: stdout).")
    p.add_argument("--batched", action="store_true",
                   help="Transcribe the files concurrently through the "
                        "batched pipeline (BatchedTranscriber).")
    p.add_argument("--compute_dtype", default=None,
                   choices=[None, "bfloat16", "float32"],
                   help="Engine compute dtype (default bfloat16 on CUDA, float32 on "
                        "the CPU; the CUDA kernels take bfloat16).")
    p.add_argument("--device", default="cuda",
                   help="Torch device of the engine ('cuda' or 'cpu').")
    return p


def _format(segments, info, fmt: str) -> str:
    from whisperlive_tpu_torch.utils.text import segments_to_srt, segments_to_vtt

    dicts = []
    for s in segments:
        d = {"start": s.start, "end": s.end, "text": s.text}
        if s.words:
            d["words"] = [
                {"start": w.start, "end": w.end, "word": w.word,
                 "probability": w.probability}
                for w in s.words
            ]
        dicts.append(d)
    if fmt == "srt":
        return segments_to_srt(dicts)
    if fmt == "vtt":
        return segments_to_vtt(dicts)
    if fmt == "json":
        return json.dumps(
            {"language": info.language,
             "language_probability": info.language_probability,
             "duration": info.duration, "segments": dicts},
            ensure_ascii=False, indent=2,
        )
    return "".join(s.text for s in segments).strip() + "\n"


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    import torch

    from whisperlive_tpu_torch.audio.io import load_audio
    from whisperlive_tpu_torch.engine.engine import TranscribeOptions
    from whisperlive_tpu_torch.engine.transcribe import BatchedTranscriber, Transcriber
    from whisperlive_tpu_torch.loader import load_engine

    compute_dtype = ({"bfloat16": torch.bfloat16, "float32": torch.float32}[args.compute_dtype]
                     if args.compute_dtype else None)
    engine = load_engine(args.model, args.tpu_model_path, args.device, compute_dtype)

    spec = None
    if args.draft_model or args.draft_path:
        from whisperlive_tpu_torch.engine.speculative import SpeculativeDecoder

        # without --draft_path a random draft from seed 1 (the server's --seed + 1)
        draft = load_engine(args.draft_model or "distil-large-v3", args.draft_path,
                            args.device, compute_dtype, seed=1)
        spec = SpeculativeDecoder(engine, draft, k=args.spec_k)
        if args.batched:
            logger.warning("--batched runs the plain batched pipeline; "
                           "the draft accelerates the sequential path only")

    kw = {}
    if args.no_gates:
        kw = dict(temperatures=(0.0,), log_prob_threshold=None,
                  compression_ratio_threshold=None, no_speech_threshold=None)
    options = TranscribeOptions(
        language=args.language,
        task=args.task,
        beam_size=args.beam_size,
        word_timestamps=args.word_timestamps,
        initial_prompt=args.initial_prompt,
        hotwords=args.hotwords,
        max_new_tokens=args.max_new_tokens,
        **kw,
    )

    def emit(path: str, segments, info) -> None:
        out = _format(segments, info, args.output_format)
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
            stem = os.path.splitext(os.path.basename(path))[0]
            dest = os.path.join(args.output_dir, f"{stem}.{args.output_format}")
            with open(dest, "w") as f:
                f.write(out)
            logger.info("%s -> %s (%d segments, language=%s)",
                        path, dest, len(segments), info.language)
        else:
            sys.stdout.write(f"== {path} ==\n{out}\n")

    if args.batched and len(args.files) > 1:
        bt = BatchedTranscriber(engine)
        audios = [load_audio(f) for f in args.files]
        results = bt.transcribe(audios, options, vad_filter=args.vad_filter)
        for path, (segments, info) in zip(args.files, results):
            emit(path, segments, info)
    else:
        t = Transcriber(engine, spec_decoder=spec)
        for path in args.files:
            segments, info = t.transcribe(load_audio(path), options, vad_filter=args.vad_filter)
            emit(path, segments, info)
    if spec is not None and spec.stats["windows"]:
        logger.info(
            "speculative: %d windows, %d rounds, %d tokens, acceptance %.2f",
            spec.stats["windows"], spec.stats["iterations"],
            spec.stats["emitted"], spec.acceptance_rate(),
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
