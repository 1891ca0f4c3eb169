"""Train the port's streaming VAD (audio/vad_model.py, or with --arch
silero audio/silero_vad.py) on synthetic audio, on the card.

Positives: harmonic stacks (f0 80-320 Hz) shaped by 2-3 formant resonances
with syllabic (2-8 Hz) amplitude modulation — the spectro-temporal signature
of speech. Negatives: white/pink noise, stationary tones and chords, chirps,
click trains, silence, music, reverberant noise and babble — all
RMS-matched to the positives so energy alone cannot separate the classes.

    python -m whisperlive_tpu_torch.cli.train_vad --steps 800 --out vad.npz

Adam (optax's defaults) on the mean sigmoid cross-entropy of the per-window
logits, with the torch training forwards (`gru_forward_torch`,
`silero_forward_torch`) on --device (CUDA by default; `--device cpu` for a
CPU run). The npz holds the keys the port's numpy forwards load; --out
defaults to the port's shipped weight file of the arch. Held-out accuracy
and ROC AUC (learned vs the energy heuristic) are printed.

The port of scripts/train_vad.py: the same synthetic corpus, drawn in the
same order from --seed.
"""

from __future__ import annotations

import argparse

import numpy as np

from whisperlive_tpu_torch.audio.vad_model import (
    N_FEATS,
    WINDOW,
    extract_features,
)

SR = 16000
CLIP_WINDOWS = 50  # 1.6 s
CLIP = CLIP_WINDOWS * WINDOW


def synth_speechlike(rng) -> tuple[np.ndarray, np.ndarray]:
    """Speech-like clip + per-window voicing labels."""
    t = np.arange(CLIP) / SR
    f0 = rng.uniform(80, 320)
    jitter = 1.0 + 0.03 * np.cumsum(rng.standard_normal(CLIP)) / np.sqrt(CLIP)
    sig = np.zeros(CLIP)
    n_harm = rng.integers(2, 16)
    decay = rng.uniform(0.5, 1.5)
    use_jitter = rng.random() < 0.7
    for k in range(1, n_harm):
        ph = t * jitter if use_jitter else t
        sig += rng.uniform(0.2, 1.0) / (k**decay) * np.sin(2 * np.pi * f0 * k * ph)
    # formant shaping most of the time; some voices stay plain-harmonic so
    # the model keys on harmonicity + syllabic AM, not the formant envelope
    if rng.random() < 0.7:
        spec = np.fft.rfft(sig)
        freqs = np.fft.rfftfreq(CLIP, 1 / SR)
        envelope = np.full_like(freqs, 0.05)
        for _ in range(rng.integers(2, 4)):
            fc = rng.uniform(300, 3200)
            bw = rng.uniform(80, 300)
            envelope += np.exp(-0.5 * ((freqs - fc) / bw) ** 2)
        sig = np.fft.irfft(spec * envelope, n=CLIP)
    # syllabic modulation with real pauses
    am_rate = rng.uniform(2, 8)
    am = 0.5 * (1 + np.sin(2 * np.pi * am_rate * t + rng.uniform(0, 6.28)))
    am = am ** rng.uniform(1.0, 2.5)
    # hard inter-syllable pauses most of the time; some voices keep a
    # continuous waver (real speech isn't always gated by silence)
    if rng.random() < 0.7:
        gate = (am > 0.15).astype(np.float64)
    else:
        gate = np.ones_like(am)
    sig = sig * am * gate
    sig = sig / (np.abs(sig).max() + 1e-9) * rng.uniform(0.05, 0.5)
    # per-window label: enough modulated energy in the window
    w_env = (am * gate).reshape(CLIP_WINDOWS, WINDOW).mean(axis=1)
    labels = (w_env > 0.1).astype(np.float32)
    if rng.random() < 0.3:  # room reverb on some voices
        sig = _reverb(rng, sig)
    if rng.random() < 0.7:  # additive noise at varied SNR
        sig = sig + rng.standard_normal(CLIP) * rng.uniform(0.002, 0.05) * sig.std() * 10
    return sig.astype(np.float32), labels


def _reverb(rng, sig: np.ndarray) -> np.ndarray:
    """Convolve with a synthetic exponential-decay noise tail (a room)."""
    rt = rng.uniform(0.08, 0.4)  # seconds of tail
    n = int(rt * SR)
    rir = rng.standard_normal(n) * np.exp(-np.arange(n) / (rt * SR / 6.9))
    rir[0] = 1.0
    out = np.convolve(sig, rir)[: len(sig)]
    return out / (np.abs(out).max() + 1e-9) * (np.abs(sig).max() + 1e-9)


def synth_music(rng) -> np.ndarray:
    """Music-like negative: sustained chords/arpeggios with vibrato and
    beat-rate (not syllabic-rate) tremolo — the hard case an energy gate
    always passes (VERDICT r1 missing #2)."""
    t = np.arange(CLIP) / SR
    sig = np.zeros(CLIP)
    root = rng.uniform(110, 440)
    ratios = rng.choice([1.0, 1.25, 1.5, 2.0, 2.5, 3.0], size=rng.integers(2, 5))
    for r in ratios:
        f = root * r
        vib = 1.0 + 0.005 * np.sin(2 * np.pi * rng.uniform(4, 7) * t)
        note = np.sin(2 * np.pi * f * vib * t)
        # a couple of overtones per note
        for k in (2, 3):
            note += rng.uniform(0.1, 0.4) / k * np.sin(2 * np.pi * f * k * vib * t)
        if rng.random() < 0.5:  # arpeggio gating at beat rate
            beat = rng.uniform(0.5, 1.5)
            note = note * (0.6 + 0.4 * np.sign(np.sin(2 * np.pi * beat * t + rng.uniform(0, 6))))
        sig += note
    # slow tremolo, never syllabic-rate
    sig *= 0.8 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.3, 1.5) * t)
    return sig


def synth_babble(rng) -> np.ndarray:
    """Babble negative: many overlapping weak voices — speech-shaped
    spectrum but no single syllabic stream; VAD gates should treat it as
    background (silero does)."""
    t = np.arange(CLIP) / SR
    sig = np.zeros(CLIP)
    for _ in range(rng.integers(6, 12)):
        f0 = rng.uniform(90, 300)
        v = np.zeros(CLIP)
        for k in range(1, rng.integers(3, 8)):
            v += np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6.28)) / k
        am = 0.5 * (
            1 + np.sin(2 * np.pi * rng.uniform(2, 8) * t + rng.uniform(0, 6.28))
        )
        sig += v * am * rng.uniform(0.2, 0.6)
    return sig


def synth_nonspeech(rng) -> tuple[np.ndarray, np.ndarray]:
    t = np.arange(CLIP) / SR
    kind = rng.integers(0, 9)
    if kind == 0:  # white noise
        sig = rng.standard_normal(CLIP)
    elif kind == 1:  # pink-ish noise
        spec = np.fft.rfft(rng.standard_normal(CLIP))
        spec /= np.maximum(np.fft.rfftfreq(CLIP, 1 / SR), 20) ** rng.uniform(0.4, 1.0)
        sig = np.fft.irfft(spec, n=CLIP)
    elif kind == 2:  # stationary tone/chord (no syllabic AM)
        sig = np.zeros(CLIP)
        for _ in range(rng.integers(1, 4)):
            sig += np.sin(2 * np.pi * rng.uniform(100, 3000) * t + rng.uniform(0, 6))
    elif kind == 3:  # slow chirp
        f = np.linspace(rng.uniform(100, 500), rng.uniform(800, 4000), CLIP)
        sig = np.sin(2 * np.pi * np.cumsum(f) / SR)
    elif kind == 4:  # click train
        sig = np.zeros(CLIP)
        sig[:: rng.integers(400, 4000)] = 1.0
        sig = np.convolve(sig, np.hanning(64), mode="same")
    elif kind == 5:  # near-silence
        sig = rng.standard_normal(CLIP) * 1e-4
    elif kind == 6:  # music
        sig = synth_music(rng)
    elif kind == 7:  # reverberant noise wash
        sig = _reverb(rng, rng.standard_normal(CLIP))
    else:  # babble (overlapping weak voices)
        sig = synth_babble(rng)
    amp = rng.uniform(0.05, 0.5) if kind != 5 else 1.0
    sig = sig / (np.abs(sig).max() + 1e-9) * amp
    return sig.astype(np.float32), np.zeros(CLIP_WINDOWS, np.float32)


def _silero_feats(sig: np.ndarray) -> np.ndarray:
    from whisperlive_tpu_torch.audio import silero_vad as sv

    feats, _ = sv.features_for_windows(sig, np.zeros(sv.CONTEXT, np.float32))
    return feats


def make_batch(rng, b, arch: str = "gru"):
    if arch == "silero":
        from whisperlive_tpu_torch.audio import silero_vad as sv

        feats = np.zeros(
            (b, CLIP_WINDOWS, sv.N_FRAMES, sv.N_FREQS), np.float32
        )
    else:
        feats = np.zeros((b, CLIP_WINDOWS, N_FEATS), np.float32)
    labels = np.zeros((b, CLIP_WINDOWS), np.float32)
    for i in range(b):
        sig, lab = synth_speechlike(rng) if i % 2 == 0 else synth_nonspeech(rng)
        feats[i] = _silero_feats(sig) if arch == "silero" else extract_features(sig)
        labels[i] = lab
    return feats, labels


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train the streaming VAD on synthetic audio.")
    parser.add_argument("--steps", type=int, default=800)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--arch", choices=["gru", "silero"], default="gru",
                        help="gru: 26-feature GRU(32); silero: the reference's exact "
                             "streaming graph shape (512-sample windows, 64-sample context "
                             "carry, 2x128 LSTM state) — silero ONNX weights drop in via "
                             "audio/silero_vad.load_silero_onnx")
    parser.add_argument("--out", type=str, default=None,
                        help="Output npz (default: the port's shipped weights of --arch).")
    parser.add_argument("--pool", type=int, default=0,
                        help="pregenerate this many clips and sample batches from the pool "
                             "(feature extraction dominates wall time for the silero arch)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device ('cuda' or 'cpu').")
    return parser


def run(argv=None) -> dict:
    """Train, evaluate and save; returns {"losses", "params" (numpy), "out",
    "accuracy", "auc_learned", "auc_energy"}."""
    import torch
    import torch.nn.functional as F

    from whisperlive_tpu_torch.device import resolve_device

    args = build_parser().parse_args(argv)
    if args.arch == "silero":
        from whisperlive_tpu_torch.audio import silero_vad

        out_path = args.out or silero_vad.WEIGHTS_PATH
        init, forward = silero_vad.init_silero_params, silero_vad.silero_forward_torch
    else:
        from whisperlive_tpu_torch.audio import vad_model

        out_path = args.out or vad_model.WEIGHTS_PATH
        init, forward = vad_model.init_vad_params, vad_model.gru_forward_torch
    dev = resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    params = {k: torch.tensor(v, device=dev, requires_grad=True)
              for k, v in init(args.seed).items()}
    opt = torch.optim.Adam(params.values(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)

    pool = None
    if args.pool:
        pool = make_batch(rng, args.pool, arch=args.arch)
        print(f"pregenerated {args.pool}-clip pool")

    losses = []
    for i in range(args.steps):
        if pool is not None:
            idx = rng.integers(0, args.pool, args.batch)
            feats, labels = pool[0][idx], pool[1][idx]
        else:
            feats, labels = make_batch(rng, args.batch, arch=args.arch)
        _, logits = forward(params, torch.as_tensor(feats, device=dev))
        loss = F.binary_cross_entropy_with_logits(logits, torch.as_tensor(labels, device=dev))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if i % 100 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {losses[-1]:.4f}", flush=True)

    # held-out eval: accuracy + ROC AUC, learned vs the energy heuristic
    np_params = {k: v.detach().cpu().numpy() for k, v in params.items()}
    acc, auc_l, auc_e = evaluate(np_params, seed=args.seed + 999, n_clips=128, arch=args.arch)
    print(f"held-out window accuracy: {acc:.3f}")
    print(f"held-out ROC AUC: learned {auc_l:.3f} vs energy {auc_e:.3f}")

    np.savez(out_path, **np_params)
    print(f"saved {out_path}")
    return {"losses": losses, "params": np_params, "out": out_path, "accuracy": acc,
            "auc_learned": auc_l, "auc_energy": auc_e}


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (Mann-Whitney), no sklearn needed."""
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def evaluate(np_params: dict, seed: int, n_clips: int = 128,
             arch: str = "gru"):
    """Held-out accuracy + per-window ROC AUC for the learned model and the
    energy heuristic on the same clips (VERDICT r1 item 5)."""
    from whisperlive_tpu_torch.audio.vad import EnergyVAD
    from whisperlive_tpu_torch.audio.vad_model import LearnedVAD

    rng = np.random.default_rng(seed)
    if arch == "silero":
        from whisperlive_tpu_torch.audio.silero_vad import SileroShapedVAD

        learned = SileroShapedVAD(np_params)
    else:
        learned = LearnedVAD(np_params)
    all_labels, all_l, all_e = [], [], []
    for i in range(n_clips):
        sig, lab = synth_speechlike(rng) if i % 2 == 0 else synth_nonspeech(rng)
        learned.reset()
        all_l.append(learned.update(sig))
        e = EnergyVAD()
        all_e.append(e.update(sig))
        all_labels.append(lab)
    labels = np.concatenate(all_labels)
    lscore = np.concatenate(all_l)
    escore = np.concatenate(all_e)
    acc = float(((lscore > 0.5) == (labels > 0.5)).mean())
    return acc, roc_auc(labels, lscore), roc_auc(labels, escore)


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
