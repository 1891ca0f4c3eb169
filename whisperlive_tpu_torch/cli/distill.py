"""Distill a speculative draft from a Whisper teacher.

    python -m whisperlive_tpu_torch.cli.distill --model large-v3 [-tpu <ckpt>]
        [--layers 2] [--steps 300] [--batch 4] [--pool 64] [--seq 48]
        [--enc_ctx 512] [--audio_dir <dir-of-wav-flac>] --out <draft-dir>

Port of scripts/distill_draft.py (the distil-whisper recipe on the port's
training path), with the same flags and steps:

1. an audio pool: the clips of --audio_dir, topped up with synthetic
   streaming-shaped clips drawn from --seed in the JAX script's order;
2. pseudo-labels: the teacher engine's greedy decode_batch of each clip at
   the serving context --enc_ctx (on CUDA through the int8 kernels: the
   numerics of the verifier the draft will be judged against);
3. the frozen teacher's encoder states and teacher-forced logits, from the
   dense tree rebuilt from the int8 one (dequantize_decoder_weights),
   kept on the device in bfloat16;
4. KD steps on a student of --layers maximally-spaced teacher layers,
   trained in float32;
5. the held-out teacher-forced agreement before and after;
6. the draft saved as a converted dir (models/convert.py) whose config.json
   records `distill_enc_ctx`. Serve it with --draft_path at that context.

Without a checkpoint the teacher has random weights (seed 0, as the
serving CLIs draw them) and the audio is synthetic: the pipeline runs, the quality needs real weights. The
engine runs on --device (CUDA by default; --device cpu for a CPU run).
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="whisperlive-tpu-torch draft distillation")
    ap.add_argument("--model", default="tiny")
    ap.add_argument("-tpu", "--tpu_model_path", default=None,
                    help="Teacher checkpoint: an HF or converted dir.")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--pool", type=int, default=64, help="Pseudo-labeled training clips.")
    ap.add_argument("--seq", type=int, default=48, help="Teacher-forced sequence length.")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--audio_dir", default=None,
                    help="Directory of wav/flac clips (synthetic if unset).")
    ap.add_argument("--enc_ctx", type=int, default=0,
                    help="Encoder context positions the draft will SERVE at (0 = full 30 s "
                         "windows, the offline path). The continuous pools encode short tails "
                         "at a reduced context (512 by default), and a draft agrees with its "
                         "target only at the context it was distilled at: use --enc_ctx 512 "
                         "for --continuous_spec serving drafts.")
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="Torch device of the teacher and the student ('cuda' or 'cpu').")
    return ap


def synth_pool(n: int, rng: np.random.Generator, enc_ctx: int) -> list[np.ndarray]:
    """n synthetic clips shaped like streaming windows: a speech-like family
    (harmonics, syllabic AM, noise) and a pure AM-tone family, either a
    young stream (signal from t = 0 for 0.5 s up to the live cap, then
    silence) or a full window sliced mid-stream at a random phase. The live
    cap is what the serving context holds (enc_ctx * 20 ms, at most 14 s)."""
    from whisperlive_tpu_torch.ops.mel import N_SAMPLES

    live_cap_s = min(14.0, enc_ctx * 0.02) if enc_ctx else 14.0

    def clip() -> np.ndarray:
        full = rng.random() < 0.5
        t0 = rng.uniform(0.0, 60.0) if full else 0.0
        t = t0 + np.arange(N_SAMPLES) / 16000.0
        if rng.random() < 0.5:
            f0 = rng.uniform(90, 240)
            sig = sum(rng.uniform(0.1, 0.4) * np.sin(2 * np.pi * f0 * (h + 1) * t)
                      for h in range(4))
            am = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2.5, 5.0) * t)
            out = sig * am * 0.2 + rng.normal(0, 0.01, t.shape)
        else:
            tone = rng.uniform(100, 420)
            am = rng.uniform(2.0, 4.0)
            out = 0.2 * np.sin(2 * np.pi * am * t) * np.sin(2 * np.pi * tone * t)
        n_live = int((live_cap_s if full else rng.uniform(0.5, live_cap_s)) * 16000)
        out[n_live:] = 0.0
        return out.astype(np.float32)

    return [clip() for _ in range(n)]


def audio_pool(args, rng: np.random.Generator) -> np.ndarray:
    """[pool, N_SAMPLES] float32: --audio_dir's clips padded or cut to 30 s,
    then synthetic clips up to --pool."""
    from whisperlive_tpu_torch.ops.mel import N_SAMPLES

    clips: list[np.ndarray] = []
    if args.audio_dir:
        from whisperlive_tpu_torch.audio.io import load_audio

        for path in sorted(glob.glob(os.path.join(args.audio_dir, "*")))[: args.pool]:
            try:
                a = load_audio(path)
            except (OSError, ValueError, RuntimeError) as e:
                logger.warning("skipping %s: %s", path, e)
                continue
            clips.append(np.pad(a[:N_SAMPLES], (0, max(0, N_SAMPLES - len(a))))
                         .astype(np.float32))
    clips += synth_pool(max(0, args.pool - len(clips)), rng, args.enc_ctx)
    return np.stack(clips)


def encode_at(params, cfg, clips: np.ndarray, enc_ctx: int, device) -> torch.Tensor:
    """Encoder states of clips [B, N_SAMPLES] at the serving context: the
    continuous pools encode tails with the mel cut to 2 * enc_ctx frames and
    the position table cut to match, and the encoder is a different function
    of the same audio at each context."""
    from whisperlive_tpu_torch.models import whisper as wmod
    from whisperlive_tpu_torch.ops import mel as mel_ops

    mel = mel_ops.log_mel_spectrogram(torch.from_numpy(clips).to(device), n_mels=cfg.n_mels)
    if enc_ctx:
        mel = mel[:, : 2 * enc_ctx]
    return wmod.encode(params, cfg, mel)


def _padded(a: np.ndarray, n: int) -> np.ndarray:
    """a with zero rows appended up to n rows."""
    return np.concatenate([a, np.zeros((n - len(a), *a.shape[1:]), a.dtype)])


@torch.no_grad()
def pseudo_label(teacher_eng, audio: np.ndarray, seq: int, enc_ctx: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The teacher's greedy transcripts of the pool as teacher-forced rows:
    tokens_in [P, seq] int32 (prompt + pseudo tokens, zero-padded) and
    loss_mask [P, seq] float32 over the generated region (the prompt is
    given, not predicted, and acceptance only runs past it)."""
    from whisperlive_tpu_torch.engine.engine import TranscribeOptions
    from whisperlive_tpu_torch.models import whisper as wmod

    opts = TranscribeOptions(language="en", temperatures=(0.0,), log_prob_threshold=None,
                             no_speech_threshold=None, compression_ratio_threshold=None,
                             max_new_tokens=seq - 8)
    prompt, sot = teacher_eng.build_prompt(opts, language="en")
    cfg = teacher_eng.cfg
    seqs = []
    bs = max(b for b in teacher_eng.batch_buckets if b <= 8)
    for i in range(0, len(audio), bs):
        chunk = audio[i : i + bs]
        enc = encode_at(teacher_eng.params, cfg, _padded(chunk, bs), enc_ctx, teacher_eng.device)
        cross = teacher_eng.quantize_cross(wmod.compute_cross_kv(teacher_eng.params, cfg, enc))
        results = teacher_eng.decode_batch(cross, [prompt] * bs, [sot] * bs, opts,
                                           temperatures=[0.0] * bs)
        seqs += [prompt + [int(x) for x in r.tokens] for r in results[: len(chunk)]]

    tokens_in = np.zeros((len(seqs), seq), np.int32)
    loss_mask = np.zeros((len(seqs), seq), np.float32)
    for i, s in enumerate(seqs):
        s = s[:seq]
        tokens_in[i, : len(s)] = s
        loss_mask[i, len(prompt) - 1 : max(len(s) - 1, len(prompt) - 1)] = 1.0
    return tokens_in, loss_mask


@torch.no_grad()
def precompute(teacher_eng, audio: np.ndarray, tokens_in: np.ndarray, enc_ctx: int):
    """-> (the dense teacher tree, encoder states [P, T_enc, d] and
    teacher-forced logits [P, seq, V], both bfloat16 on the device). The
    frozen teacher's outputs are constants of the pool, so every KD step is
    then a student-only forward and backward. The dense tree carries the int8
    decoder's dequantized values, rounding error included: KD against the
    raw float teacher would mis-target wherever quantization flips an argmax
    (a no-op for an unquantized engine)."""
    from whisperlive_tpu_torch.models import whisper as wmod
    from whisperlive_tpu_torch.training import decoder_forward_train

    cfg, dev = teacher_eng.cfg, teacher_eng.device
    teacher = wmod.dequantize_decoder_weights(
        teacher_eng.params, torch.bfloat16 if teacher_eng.decoder_int8 else torch.float32)
    eb = 8
    enc_parts, logit_parts = [], []
    for i in range(0, len(audio), eb):
        keep = len(audio[i : i + eb])
        enc = encode_at(teacher, cfg, _padded(audio[i : i + eb], eb), enc_ctx, dev)
        tok = torch.from_numpy(_padded(tokens_in[i : i + eb], eb)).to(dev)
        logits = decoder_forward_train(teacher, cfg, tok, enc)
        enc_parts.append(enc[:keep].to(torch.bfloat16))
        logit_parts.append(logits[:keep].to(torch.bfloat16))
    return teacher, torch.cat(enc_parts), torch.cat(logit_parts)


def train(teacher, cfg_t, enc_pool: torch.Tensor, logit_pool: torch.Tensor,
          tokens_in: np.ndarray, loss_mask: np.ndarray, args, rng: np.random.Generator):
    """KD steps on batches drawn from the first 90% of the pool; the rest is
    held out. -> (DistillState, losses [steps] float32 on the host,
    agreement before, agreement after)."""
    from whisperlive_tpu_torch import distill
    from whisperlive_tpu_torch.models import whisper as wmod
    from whisperlive_tpu_torch.training import make_optimizer

    dev = enc_pool.device
    cfg_s = distill.student_config(cfg_t, n_text_layer=args.layers)
    opt = make_optimizer(learning_rate=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
                         total_steps=args.steps)
    # the student trains in float32 whatever the teacher's dtype: Adam in
    # bf16 loses the small late-training updates
    dec0 = wmod.tree_map(lambda t: t.to(torch.float32),
                         distill.init_student_from_teacher(teacher, args.layers)["decoder"])
    state = distill.DistillState(dec0, opt.init(dec0), 0)
    step = distill.make_distill_step(cfg_s, cfg_t, opt)
    tok_pool = torch.from_numpy(tokens_in).to(dev)
    mask_pool = torch.from_numpy(loss_mask).to(dev)
    n_train = int(len(tokens_in) * 0.9)
    hold = slice(n_train, len(tokens_in))

    def agreement() -> float:
        return distill.measure_acceptance(
            teacher, distill.student_params(teacher, state), cfg_t, cfg_s, None,
            tokens_in[hold], loss_mask[hold], enc=enc_pool[hold])

    acc0 = agreement()
    logger.info("held-out teacher-forced agreement BEFORE: %.3f", acc0)
    losses = []
    t0 = time.monotonic()
    for i in range(args.steps):
        idx = torch.from_numpy(rng.integers(0, n_train, args.batch)).to(dev)
        state, loss = step(state, teacher, {"enc": enc_pool[idx], "t_logits": logit_pool[idx],
                                            "tokens_in": tok_pool[idx],
                                            "loss_mask": mask_pool[idx]})
        losses.append(loss)
        if i % 25 == 0 or i == args.steps - 1:
            logger.info("step %4d  loss %.4f  (%.1fs)", i, float(loss), time.monotonic() - t0)
    acc1 = agreement()
    logger.info("held-out teacher-forced agreement AFTER: %.3f (was %.3f)", acc1, acc0)
    return state, torch.stack(losses).float().cpu().numpy(), acc0, acc1


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from whisperlive_tpu_torch import distill
    from whisperlive_tpu_torch.loader import load_engine
    from whisperlive_tpu_torch.models import convert as convert_mod
    from whisperlive_tpu_torch.models import whisper as wmod

    rng = np.random.default_rng(args.seed)
    # the teacher loads as serving loads it (int8 decoder and cross-KV on
    # CUDA), so the pseudo-labels are the serving verifier's own
    teacher_eng = load_engine(args.model, args.tpu_model_path, args.device)
    cfg_t = teacher_eng.cfg
    audio = audio_pool(args, rng)
    logger.info("pseudo-labeling %d clips with the teacher (enc_ctx=%s)...", len(audio),
                args.enc_ctx or "full")
    tokens_in, loss_mask = pseudo_label(teacher_eng, audio, args.seq, args.enc_ctx)
    logger.info("precomputing encoder features + teacher logits (%d clips)...", len(audio))
    teacher, enc_pool, logit_pool = precompute(teacher_eng, audio, tokens_in, args.enc_ctx)
    state, _, _, _ = train(teacher, cfg_t, enc_pool, logit_pool, tokens_in, loss_mask, args, rng)

    draft = wmod.tree_map(lambda t: t.to(torch.float32), distill.student_params(teacher, state))
    convert_mod.save_converted(
        args.out, distill.student_config(cfg_t, n_text_layer=args.layers), draft,
        extra_meta={"distill_enc_ctx": args.enc_ctx or cfg_t.n_audio_ctx})
    logger.info("draft saved to %s: serve it with --draft_path %s (python -m "
                "whisperlive_tpu_torch.cli.transcribe or .cli.run_server)", args.out, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
