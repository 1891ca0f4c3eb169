"""Train the port's speaker embedder (audio/speaker_model.py, or with
--arch resnet audio/wespeaker.py) on synthetic voices, on the card.

A synthetic SPEAKER is a fixed latent profile: fundamental frequency,
formant center frequencies/bandwidths, spectral tilt, jitter and vibrato
amounts. UTTERANCES from one speaker vary the syllabic modulation pattern,
phrase gating, small f0 drift and additive noise — so the only stable
signal across a speaker's utterances is vocal timbre, which is exactly
what the embedding must capture.

Training: softmax classification over N synthetic speakers on the
L2-normalized embedding (scaled cosine logits with an additive angular
margin on the target class), then the classifier head is dropped. Adam
(optax's defaults) with the torch training forwards (`embed_torch` of
either arch; the resnet's BatchNorm running statistics are EMA-tracked,
not optimized) on --device (CUDA by default; `--device cpu` for a CPU
run). Eval: same/different-speaker cosine ROC AUC and EER on HELD-OUT
speaker profiles, learned vs the weight-free spectral stand-in.

    python -m whisperlive_tpu_torch.cli.train_speaker --steps 1200 --out spk.npz

--out defaults to the port's shipped weight file of the arch. The port of
scripts/train_speaker.py: the same synthetic corpus, drawn in the same
order from --seed.
"""

from __future__ import annotations

import argparse

import numpy as np

from whisperlive_tpu_torch.audio.speaker_model import extract_features

SR = 16000
CLIP_S = 1.6
CLIP = int(CLIP_S * SR)
FRAMES = 120  # fixed feature length for batched training


def make_profile(rng) -> dict:
    return {
        "f0": rng.uniform(85, 300),
        "formants": [
            (rng.uniform(300, 900), rng.uniform(60, 160)),
            (rng.uniform(900, 2200), rng.uniform(80, 220)),
            (rng.uniform(2200, 3400), rng.uniform(120, 320)),
        ],
        "tilt": rng.uniform(0.6, 1.6),
        "jitter": rng.uniform(0.005, 0.03),
        "vibrato": rng.uniform(0.0, 0.01),
        "breath": rng.uniform(0.005, 0.06),
    }


def synth_utterance(rng, prof: dict) -> np.ndarray:
    t = np.arange(CLIP) / SR
    f0 = prof["f0"] * rng.uniform(0.96, 1.04)  # small intra-speaker drift
    jit = 1.0 + prof["jitter"] * np.cumsum(rng.standard_normal(CLIP)) / np.sqrt(CLIP)
    vib = 1.0 + prof["vibrato"] * np.sin(2 * np.pi * rng.uniform(4, 6) * t)
    sig = np.zeros(CLIP)
    for k in range(1, 14):
        sig += (1.0 / k ** prof["tilt"]) * np.sin(2 * np.pi * f0 * k * t * jit * vib)
    # speaker-fixed formant envelope (small per-utterance wobble)
    spec = np.fft.rfft(sig)
    freqs = np.fft.rfftfreq(CLIP, 1 / SR)
    envelope = np.full_like(freqs, 0.03)
    for fc, bw in prof["formants"]:
        fc_u = fc * rng.uniform(0.97, 1.03)
        envelope += np.exp(-0.5 * ((freqs - fc_u) / bw) ** 2)
    sig = np.fft.irfft(spec * envelope, n=CLIP)
    # utterance-specific syllabic AM + pauses
    am = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2.5, 7) * t + rng.uniform(0, 6.3)))
    am = am ** rng.uniform(1.0, 2.0)
    sig = sig * (0.25 + 0.75 * am)
    sig = sig + prof["breath"] * rng.standard_normal(CLIP) * np.abs(sig).std() * 3
    sig = sig / (np.abs(sig).max() + 1e-9) * rng.uniform(0.08, 0.4)
    return sig.astype(np.float32)


def apply_channel(rng, sig: np.ndarray) -> np.ndarray:
    """Utterance-level nuisances the embedding must IGNORE: room reverb,
    additive noise at varied SNR, and channel EQ (mic/telephone coloring).
    Real speaker verification is dominated by channel mismatch, not voice
    similarity — training with per-utterance channels forces the embedder
    onto the speaker traits (f0, formants, tilt) instead of the recording."""
    out = sig.astype(np.float64)
    if rng.random() < 0.5:  # room
        rt = rng.uniform(0.05, 0.35)
        n = int(rt * SR)
        rir = rng.standard_normal(n) * np.exp(-np.arange(n) / (rt * SR / 6.9))
        rir[0] = 1.0
        out = np.convolve(out, rir)[: len(sig)]
    if rng.random() < 0.7:  # noise
        snr_db = rng.uniform(5, 30)
        noise = rng.standard_normal(len(out))
        if rng.random() < 0.5:  # pink-ish
            spec = np.fft.rfft(noise)
            spec /= np.maximum(np.fft.rfftfreq(len(out), 1 / SR), 20) ** 0.5
            noise = np.fft.irfft(spec, n=len(out))
        g = out.std() / (noise.std() + 1e-9) * 10 ** (-snr_db / 20)
        out = out + g * noise
    if rng.random() < 0.5:  # channel EQ: random spectral tilt / bandpass
        spec = np.fft.rfft(out)
        freqs = np.fft.rfftfreq(len(out), 1 / SR)
        tilt = (np.maximum(freqs, 50) / 1000.0) ** rng.uniform(-0.4, 0.4)
        if rng.random() < 0.3:  # telephone-ish band
            tilt = tilt * (freqs > 250) * (freqs < 3600)
        out = np.fft.irfft(spec * tilt, n=len(out))
    out = out / (np.abs(out).max() + 1e-9) * rng.uniform(0.08, 0.4)
    return out.astype(np.float32)


def feats_fixed(audio: np.ndarray) -> np.ndarray:
    f = extract_features(audio)
    if f.shape[0] >= FRAMES:
        return f[:FRAMES]
    return np.pad(f, [(0, FRAMES - f.shape[0]), (0, 0)])


def feats_fbank_fixed(audio: np.ndarray, frames: int = 158) -> np.ndarray:
    from whisperlive_tpu_torch.audio.wespeaker import fbank

    f = fbank(audio)
    if f.shape[0] >= frames:
        return f[:frames]
    return np.pad(f, [(0, frames - f.shape[0]), (0, 0)])


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train the speaker embedder on synthetic "
                                                 "voices.")
    parser.add_argument("--arch", choices=("mlp", "resnet"), default="mlp",
                        help="mlp: audio/speaker_model.py; resnet: the WeSpeaker-ResNet-"
                             "shaped graph (audio/wespeaker.py, LITE config)")
    parser.add_argument("--steps", type=int, default=1200)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--n_speakers", type=int, default=256)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--scale", type=float, default=12.0,
                        help="cosine-logit scale for the softmax head")
    parser.add_argument("--margin", type=float, default=0.2,
                        help="additive angular margin on the target cosine (AAM-softmax, "
                             "the standard speaker-verification objective) — 0 disables")
    parser.add_argument("--no_channel", action="store_true",
                        help="disable per-utterance reverb/noise/EQ augmentation")
    parser.add_argument("--out", type=str, default=None,
                        help="Output npz (default: the port's shipped weights of --arch).")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device ('cuda' or 'cpu').")
    return parser


def run(argv=None) -> dict:
    """Train, evaluate and save; returns {"losses", "params" (numpy, no
    classifier head), "out", "learned": (auc, eer), "spectral": (auc, eer)}."""
    import torch
    import torch.nn.functional as F

    from whisperlive_tpu_torch.device import resolve_device

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    profiles = [make_profile(rng) for _ in range(args.n_speakers)]
    if args.arch == "resnet":
        from whisperlive_tpu_torch.audio import wespeaker

        out_path = args.out or wespeaker.WEIGHTS_PATH
        base = wespeaker.init_wespeaker_params(wespeaker.LITE, args.seed)
        lim = np.sqrt(6.0 / (wespeaker.LITE.emb_dim + args.n_speakers))
        base["wc"] = np.random.default_rng(args.seed + 1).uniform(
            -lim, lim, (wespeaker.LITE.emb_dim, args.n_speakers)
        ).astype(np.float32)

        def forward(p, feats):
            return wespeaker.embed_torch(p, feats, train=True)

        featurize = feats_fbank_fixed
    else:
        from whisperlive_tpu_torch.audio import speaker_model

        out_path = args.out or speaker_model.WEIGHTS_PATH
        base = speaker_model.init_speaker_params(args.seed, args.n_speakers)

        def forward(p, feats):
            return speaker_model.embed_torch(p, feats), {}

        featurize = feats_fixed
    params = {k: torch.tensor(v, device=dev) for k, v in base.items()}
    # BN running stats are EMA-tracked, not optimized
    trained = [v.requires_grad_() for k, v in params.items() if not k.endswith(("_m", "_v"))]
    opt = torch.optim.Adam(trained, lr=args.lr, betas=(0.9, 0.999), eps=1e-8)

    losses = []
    for i in range(args.steps):
        labels = rng.integers(0, args.n_speakers, args.batch)
        utts = [synth_utterance(rng, profiles[lab]) for lab in labels]
        if not args.no_channel:
            utts = [apply_channel(rng, u) for u in utts]
        feats = torch.as_tensor(np.stack([featurize(u) for u in utts]), device=dev)
        target = torch.as_tensor(labels, device=dev)
        emb, bn_stats = forward(params, feats)  # [B, E] normalized
        wc = params["wc"] / (torch.linalg.vector_norm(params["wc"], dim=0, keepdim=True) + 1e-8)
        cos = emb @ wc
        # AAM: subtract the margin from the TARGET class cosine only, so
        # same-speaker embeddings must clear other speakers by >= margin
        onehot = F.one_hot(target, cos.shape[1]).to(cos.dtype)
        loss = F.cross_entropy(args.scale * (cos - args.margin * onehot), target)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        with torch.no_grad():
            for k, v in bn_stats.items():
                params[k].copy_(v)
        losses.append(loss.item())
        if i % 100 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {losses[-1]:.4f}", flush=True)

    np_params = {k: v.detach().cpu().numpy() for k, v in params.items()}
    np_params.pop("wc", None)  # classifier head is training-only
    (auc_l, eer_l), (auc_s, eer_s) = evaluate(
        np_params, seed=args.seed + 7777, channel=not args.no_channel, arch=args.arch,
    )
    print(
        f"held-out verification (channel-mismatched): learned AUC {auc_l:.3f}"
        f" EER {eer_l * 100:.1f}% vs spectral AUC {auc_s:.3f}"
        f" EER {eer_s * 100:.1f}%"
    )
    np.savez(out_path, **np_params)
    print(f"saved {out_path}")
    return {"losses": losses, "params": np_params, "out": out_path,
            "learned": (auc_l, eer_l), "spectral": (auc_s, eer_s)}


def evaluate(np_params: dict, seed: int, n_speakers: int = 24, n_utt: int = 4,
             channel: bool = True, arch: str = "mlp"):
    """Same/diff-speaker cosine verification on held-out profiles, each
    utterance through an independent random channel (the real-world test:
    verification must survive recording mismatch). Returns
    ((auc, eer), (auc, eer)) for the learned and spectral embedders."""
    from whisperlive_tpu_torch.audio.speaker_model import LearnedSpeakerEmbedder
    from whisperlive_tpu_torch.diarization import SpectralEmbedder

    rng = np.random.default_rng(seed)
    profs = [make_profile(rng) for _ in range(n_speakers)]
    if arch == "resnet":
        from whisperlive_tpu_torch.audio.wespeaker import WeSpeakerEmbedder

        learned = WeSpeakerEmbedder(np_params)
    else:
        learned = LearnedSpeakerEmbedder(np_params)
    spectral = SpectralEmbedder()
    embs_l, embs_s, who = [], [], []
    for si, p in enumerate(profs):
        for _ in range(n_utt):
            a = synth_utterance(rng, p)
            if channel:
                a = apply_channel(rng, a)
            embs_l.append(learned(a))
            embs_s.append(spectral(a))
            who.append(si)
    who = np.asarray(who)

    def auc_eer(embs):
        embs = np.stack(embs)
        sims, labels = [], []
        n = len(embs)
        for i in range(n):
            for j in range(i + 1, n):
                sims.append(float(embs[i] @ embs[j]))
                labels.append(1.0 if who[i] == who[j] else 0.0)
        sims = np.asarray(sims)
        labels = np.asarray(labels)
        order = np.argsort(sims, kind="mergesort")
        ranks = np.empty(len(sims))
        ranks[order] = np.arange(1, len(sims) + 1)
        pos = labels > 0.5
        n_pos, n_neg = int(pos.sum()), int((~pos).sum())
        auc = float(
            (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
        )
        # EER: threshold where false-accept rate == false-reject rate
        desc = np.argsort(-sims, kind="mergesort")
        lab = labels[desc]
        fa = np.cumsum(1 - lab) / max(n_neg, 1)  # accepted impostors
        fr = 1.0 - np.cumsum(lab) / max(n_pos, 1)  # rejected targets
        k = int(np.argmin(np.abs(fa - fr)))
        eer = float((fa[k] + fr[k]) / 2)
        return auc, eer

    return auc_eer(embs_l), auc_eer(embs_s)


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
