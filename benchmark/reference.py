"""The plain reference: Whisper in float32 PyTorch, written from the
published architecture, and the greedy decoding rules of openai-whisper.

It imports nothing of the program. It makes its own weights again from the
seed (weights.py, the benchmark's own), and works out again every derived
state the configuration states (configs/<name>.json "serving"): int8
weight-only decoder linears and tied embedding with per-output-channel
(per-row) scales stored in bfloat16, and cross-attention K/V quantized per
(layer, k/v, window, head, channel) over the window's positions to int8
(or int4 for the control). Activations, layer norms, softmax and the mel
front end are float32 (the STFT and mel projection float64); TF32 is off.

For a window whose audio fits an encoder context bucket below the full
1500 positions (the streaming pool's 512-position bucket, a setting of the
mix), the encoder runs on the bucket's first 2 x ctx mel frames of the
zero-padded audio, and cross-attention sees ctx positions.

`token_gaps` judges served greedy tokens: for each served token, by how
much the reference's logits would have to move for the greedy rules to pick
it (0 when the reference picks it too).

This is the module a Whisper configuration names as its "reference"
(configs/<name>.json): the harness judges a run through `judge` and puts
the control in the program's place through `control_records`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.weights import dims, make_params

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
NEG = float("-inf")


# ---------------------------------------------------------------------------
# Token layout (closed form over the vocabulary size) and the rule sets
# ---------------------------------------------------------------------------


class Tokens:
    """Whisper's special tokens for a vocabulary size, and the suppress set
    of the benchmark's byte-level text vocabulary (the symbol bytes of
    openai-whisper's non-speech list, plus the specials)."""

    SYMBOLS = "\"#()*+/:;<=>@[\\]^_`{|}~「」『』♪♩♫♬"

    def __init__(self, n_vocab: int):
        self.n_vocab = n_vocab
        self.multilingual = n_vocab >= 51865
        n_lang = 100 if n_vocab >= 51866 else 99
        self.sot = n_vocab - 1501 - 6 - n_lang - 1
        self.eot = self.sot - 1
        self.languages = list(range(self.sot + 1, self.sot + 1 + n_lang))
        self.translate = self.sot + n_lang + 1
        self.transcribe = self.sot + n_lang + 2
        self.sot_lm = self.sot + n_lang + 3
        self.sot_prev = self.sot + n_lang + 4
        self.no_speech = self.sot + n_lang + 5
        self.no_timestamps = self.sot + n_lang + 6
        self.ts_begin = self.no_timestamps + 1
        self.blank = 32  # " " in the byte vocabulary
        sym = sorted({ord(c) for c in self.SYMBOLS if ord(c) < 256})
        self.suppress = sorted(set(sym) | {self.transcribe, self.translate, self.sot,
                                           self.sot_prev, self.sot_lm, self.no_speech})


def hard_rules(logits: torch.Tensor, history: list[int], tok: Tokens,
               timestamps: bool) -> tuple[torch.Tensor, float]:
    """openai-whisper's logit filters for the token after `history` (the
    tokens sampled so far in the window, a carried prefix included): the
    suppress set, SuppressBlank at the start, and with timestamps their
    pairing, monotonicity and the 1.0 s initial bound (without, timestamps
    and <|notimestamps|> are suppressed). Returns (float64 logits with -inf
    where a rule forbids, the timestamp rule's margin: log-probability of all
    timestamps minus the best text token's; > 0 forces a timestamp)."""
    tb, eot = tok.ts_begin, tok.eot
    x = logits.double().clone()
    x[torch.tensor(tok.suppress, device=x.device)] = NEG
    first = len(history) == 0
    if first:
        x[tok.blank] = NEG
        x[eot] = NEG
    if not timestamps:
        x[tb - 1:] = NEG
        return x, -math.inf
    x[tok.no_timestamps] = NEG
    last_ts = len(history) >= 1 and history[-1] >= tb
    penult_ts = len(history) < 2 or history[-2] >= tb
    if last_ts:
        if penult_ts:
            x[tb:] = NEG
        else:
            x[:eot] = NEG
    stamps = [t for t in history if t >= tb]
    if stamps:
        low = stamps[-1] if (last_ts and not penult_ts) else stamps[-1] + 1
        x[tb:low] = NEG
    if first:
        x[:tb] = NEG
        x[tb + 50 + 1:] = NEG  # max_initial_timestamp 1.0 s
    lp = torch.log_softmax(x, dim=0)
    margin = float(torch.logsumexp(lp[tb:], 0) - lp[:tb].max())
    return x, margin


def greedy_choice(logits: torch.Tensor, history: list[int], tok: Tokens,
                  timestamps: bool) -> int:
    """The token openai-whisper's greedy decoding picks."""
    x, margin = hard_rules(logits, history, tok, timestamps)
    if margin > 0:
        return int(x[tok.ts_begin:].argmax()) + tok.ts_begin
    return int(x.argmax())


def token_gaps(logits: torch.Tensor, history: list[int], served: list[int], tok: Tokens,
               timestamps: bool) -> list[float]:
    """logits [n, V]: row i predicts served[i], after `history` (the tokens
    sampled before served[0] in this window: a carried prefix). For each
    served token, the least change of the reference's logits that makes the
    greedy rules choose it: 0 if they choose it; else its distance below
    the best allowed token, plus the timestamp rule's margin where that
    rule had to decide otherwise; inf where a hard rule forbids it."""
    out = []
    tb = tok.ts_begin
    seq = list(history)
    for i, s in enumerate(served):
        x, margin = hard_rules(logits[i], seq, tok, timestamps)
        if x[s] == NEG:
            out.append(math.inf)
        else:
            v = float(x[s])
            gap = float(x.max()) - v
            if timestamps:
                ts_best, text_best = float(x[tb:].max()), float(x[:tb].max())
                if margin > 0:  # the rule forces a timestamp
                    gap = ts_best - v if s >= tb else margin + text_best - v
                elif s >= tb:  # a timestamp the rule did not force
                    gap = min(gap, -margin + ts_best - v)
            out.append(max(gap, 0.0))
        seq.append(s)
    return out


def language_gap(lang_logits: torch.Tensor, tok: Tokens, chosen: int) -> float:
    """Distance of the chosen language token from the reference's best."""
    row = lang_logits.double()
    return float(row.max() - row[tok.languages.index(chosen)])


# ---------------------------------------------------------------------------
# Front end
# ---------------------------------------------------------------------------


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) * 27.0 / np.log(6.4),
                    3.0 * f / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), 200.0 * m / 3.0)


def mel_filters(n_mels: int) -> np.ndarray:
    """Slaney-normalised mel filterbank [n_mels, 201] (librosa's htk=False)."""
    freqs = np.linspace(0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    return fb * (2.0 / (hz[2:] - hz[:-2]))[:, None]


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """[B, n] float PCM -> [B, n // 160, n_mels] float32: openai-whisper's
    log_mel_spectrogram (centered reflect-padded STFT, last frame dropped,
    log10, the max - 8 floor over each row, (x + 4) / 4), in float64."""
    x = audio.double()
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=x.device)
    spec = torch.stft(x, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    power = spec[..., :-1].abs() ** 2  # [B, 201, frames]
    fb = torch.from_numpy(mel_filters(n_mels)).to(x.device)
    mel = torch.log10(torch.clamp(fb @ power, min=1e-10))
    mel = torch.maximum(mel, mel.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((mel + 4.0) / 4.0).transpose(1, 2).float()


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _ln(x, p):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], 1e-5)


def quant_rows(w: torch.Tensor, axis: int, bits: int, scale_dtype) -> torch.Tensor:
    """Symmetric integer codes over `axis` (int8: max |w| / 127, codes in
    +-127; int4: max |w| / 7, codes in [-8, 7]; round half to even),
    dequantized with the scale rounded to scale_dtype."""
    top, lo = (127.0, -127) if bits == 8 else (7.0, -8)
    s = torch.clamp(w.abs().amax(dim=axis, keepdim=True), min=1e-8) / top
    q = torch.clamp(torch.round(w / s), lo, int(top))
    return q * s.to(scale_dtype).float()


def quant_cross(kv: torch.Tensor, bits: int, scale_dtype) -> torch.Tensor:
    """kv [..., T, H, hd] float32 -> the values a `bits`-bit cross-KV holds:
    per (head, channel) scales over the T positions (amax / 127, codes in
    +-127, or amax / 7, codes in [-8, 7]), scales rounded to scale_dtype."""
    if bits >= 16:
        return kv
    top, lo = (127.0, -127) if bits == 8 else (7.0, -8)
    s = torch.clamp(kv.abs().amax(dim=-3, keepdim=True), min=1e-6) / top
    q = torch.clamp(torch.round(kv / s), lo, int(top))
    return q * s.to(scale_dtype).float()


class Whisper:
    """Float32 Whisper of one configuration and seed, on `device`, in the
    precision the configuration serves (quantizations as values)."""

    def __init__(self, config: dict, seed: int, device, cross_kv_bits: int | None = None,
                 weight_bits: int | None = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dm = dims(config)
        serving = config["serving"]
        self.tok = Tokens(self.dm["n_vocab"])
        self.device = torch.device(device)
        self.cross_bits = serving["cross_kv_bits"] if cross_kv_bits is None else cross_kv_bits
        self.scale_dtype = getattr(torch, serving["scale_dtype"])
        self.weight_bits = serving["decoder_weight_bits"] if weight_bits is None else weight_bits
        raw = make_params(config, seed, device, dtype=getattr(torch, serving["weight_dtype"]))
        self.p = self._prepare(raw)

    def _prepare(self, raw: dict) -> dict:
        def f32(tree):
            return {k: f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}

        p = f32(raw)
        del raw
        bits = self.weight_bits
        if bits < 16:
            lay = p["decoder"]["layers"]
            for a in ("attn", "cross_attn", "mlp"):
                for lin in lay[a].values():
                    lin["w"] = quant_rows(lin["w"], -2, bits, self.scale_dtype)  # per out channel
            p["decoder"]["embed"] = quant_rows(p["decoder"]["embed"], -1, bits, self.scale_dtype)
        return p

    # -- encoder ----------------------------------------------------------

    @torch.no_grad()
    def encode(self, audio: np.ndarray, ctx: int) -> torch.Tensor:
        """audio [B, n] (n <= 2 * ctx * 160: zero-padded to it) -> encoder
        states [B, ctx, d] over the first 2 * ctx mel frames."""
        dm, p = self.dm, self.p["encoder"]
        n = 2 * ctx * HOP
        a = np.zeros((len(audio), n), np.float32)
        for i, row in enumerate(audio):
            a[i, : min(len(row), n)] = row[:n]
        mel = log_mel(torch.from_numpy(a).to(self.device), dm["n_mels"])  # [B, 2ctx, n_mels]
        x = F.gelu(F.conv1d(mel.transpose(1, 2), p["conv1"]["w"], p["conv1"]["b"], padding=1))
        x = F.gelu(F.conv1d(x, p["conv2"]["w"], p["conv2"]["b"], stride=2, padding=1))
        x = x.transpose(1, 2) + p["pos"][:ctx]
        h = dm["n_audio_head"]
        lay = p["layers"]
        for i in range(dm["n_audio_layer"]):
            a_ = {k: {kk: vv[i] for kk, vv in v.items()} for k, v in lay["attn"].items()}
            y = _ln(x, {k: v[i] for k, v in lay["attn_ln"].items()})
            x = x + self._mha(y, y, a_, h, causal=False)
            y = _ln(x, {k: v[i] for k, v in lay["mlp_ln"].items()})
            fc1 = {k: v[i] for k, v in lay["mlp"]["fc1"].items()}
            fc2 = {k: v[i] for k, v in lay["mlp"]["fc2"].items()}
            x = x + (F.gelu(y @ fc1["w"] + fc1["b"]) @ fc2["w"] + fc2["b"])
        return _ln(x, p["ln_post"])

    @staticmethod
    def _mha(xq, xkv, a, h, causal):
        b, tq, d = xq.shape
        q = (xq @ a["q"]["w"] + a["q"]["b"]).view(b, tq, h, -1).transpose(1, 2)
        k = (xkv @ a["k"]["w"]).view(b, xkv.shape[1], h, -1).transpose(1, 2)
        v = (xkv @ a["v"]["w"] + a["v"]["b"]).view(b, xkv.shape[1], h, -1).transpose(1, 2)
        s = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
        if causal:
            s = s.masked_fill(torch.ones_like(s, dtype=torch.bool).triu(1), NEG)
        o = torch.softmax(s, dim=-1) @ v
        return o.transpose(1, 2).reshape(b, tq, d) @ a["o"]["w"] + a["o"]["b"]

    # -- decoder ----------------------------------------------------------

    @torch.no_grad()
    def cross(self, enc: torch.Tensor, bits: int | None = None) -> list:
        """Per decoder layer (K, V) [B, H, T, hd] as the configured cross-KV
        width holds them."""
        dm, lay = self.dm, self.p["decoder"]["layers"]["cross_attn"]
        bits = self.cross_bits if bits is None else bits
        b, t, d = enc.shape
        h = dm["n_text_head"]
        out = []
        for i in range(dm["n_text_layer"]):
            k = (enc @ lay["k"]["w"][i]).view(b, t, h, -1)
            v = (enc @ lay["v"]["w"][i] + lay["v"]["b"][i]).view(b, t, h, -1)
            k = quant_cross(k, bits, self.scale_dtype)
            v = quant_cross(v, bits, self.scale_dtype)
            out.append((k.transpose(1, 2), v.transpose(1, 2)))
        return out

    @torch.no_grad()
    def logits(self, tokens: list[int], cross: list, row: int, first: int) -> torch.Tensor:
        """Teacher-forced pass over `tokens` (positions 0..n-1) against
        window `row` of `cross`: float32 logits [n - first, V] of positions
        first..n-1."""
        dm, p = self.dm, self.p["decoder"]
        h = dm["n_text_head"]
        t = torch.tensor(tokens, device=self.device)
        x = (p["embed"][t] + p["pos"][: len(tokens)])[None]
        lay = p["layers"]
        for i in range(dm["n_text_layer"]):
            def sub(name):
                return {k: {kk: vv[i] for kk, vv in v.items()} for k, v in lay[name].items()}

            y = _ln(x, {k: v[i] for k, v in lay["attn_ln"].items()})
            x = x + self._mha(y, y, sub("attn"), h, causal=True)
            y = _ln(x, {k: v[i] for k, v in lay["cross_attn_ln"].items()})
            ca = sub("cross_attn")
            q = (y @ ca["q"]["w"] + ca["q"]["b"]).view(1, len(tokens), h, -1).transpose(1, 2)
            kc, vc = cross[i][0][row: row + 1], cross[i][1][row: row + 1]
            s = (q @ kc.transpose(-1, -2)) * q.shape[-1] ** -0.5
            o = (torch.softmax(s, dim=-1) @ vc).transpose(1, 2).reshape(1, len(tokens), -1)
            x = x + (o @ ca["o"]["w"] + ca["o"]["b"])
            y = _ln(x, {k: v[i] for k, v in lay["mlp_ln"].items()})
            fc1 = {k: v[i] for k, v in lay["mlp"]["fc1"].items()}
            fc2 = {k: v[i] for k, v in lay["mlp"]["fc2"].items()}
            x = x + (F.gelu(y @ fc1["w"] + fc1["b"]) @ fc2["w"] + fc2["b"])
        x = _ln(x[0, first:], p["ln"])
        return x @ p["embed"].t()


# ---------------------------------------------------------------------------
# The judgement of a run, and the control
# ---------------------------------------------------------------------------

# the decoder's linears and embedding one step below the configuration's int8
CONTROL = {"weight_bits": 4}


def reference_gaps(config: dict, seed: int, device: str, sample: list) -> dict:
    """The reference's judgement of the sampled records: every served
    token's gap (token_gaps) and every language the program detected
    (language_gap)."""
    model = Whisper(config, seed, device)
    tok = model.tok
    out = {"token": [], "language": []}
    for rec in sample:
        cross = model.cross(model.encode(rec["audio"][None], rec["enc_ctx"]))
        prompt, served = rec["prompt"], rec["served"]
        if served:
            lg = model.logits(prompt + served, cross, 0, len(prompt) - 1)[: len(served)]
            out["token"] += token_gaps(lg, rec["history"], served, tok, rec["timestamps"])
        if rec.get("language") is not None:
            ll = model.logits([tok.sot], cross, 0, 0)[0][tok.languages]
            out["language"].append(language_gap(ll, tok, rec["language"]))
        del cross
    del model
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def judge(run, config: dict, seed: int, device: str, limits: dict) -> tuple[bool, dict]:
    """Compare a seeded sample of the run's answers with the reference.
    Returns (correct, {number: {"value", "limit"}})."""
    from benchmark import harness

    k = run.mix["check"]["sample"]
    sample = harness.sample_records(run.records, k, seed)
    res = reference_gaps(config, seed, device, sample)
    widest = max(res["token"] + res["language"], default=math.inf)
    served = sum(len(r["served"]) for r in sample)
    checks = {
        "widest_gap": {"value": widest, "limit": limits["widest_gap"]["limit"]},
        "unanswered": {"value": run.failed, "limit": 0},
        "tokens_compared": {"value": served, "limit": limits["tokens_compared"]["limit"]},
        # exact: the cross-KV width the configuration serves
        "cross_kv_bits_off": {"value": (abs(run.cross_kv_bits - config["serving"]["cross_kv_bits"])
                                        if run.cross_kv_bits is not None else math.inf),
                              "limit": 0},
    }
    ok = (widest <= checks["widest_gap"]["limit"] and run.failed == 0
          and served >= checks["tokens_compared"]["limit"] and run.attempted > 0
          and checks["cross_kv_bits_off"]["value"] <= 0)
    return ok, checks


def control_records(config: dict, seed: int, device: str, sample: list) -> list:
    """The sampled records with the control's answers in place of the
    program's: the reference one precision step below the configuration
    (CONTROL), its greedy tokens after each prompt and its language."""
    model = Whisper(config, seed, device, **CONTROL)
    tok = model.tok
    out = []
    for rec in sample:
        cross = model.cross(model.encode(rec["audio"][None], rec["enc_ctx"]))
        toks, seq, served = list(rec["prompt"]), list(rec["history"]), []
        for _ in rec["served"]:
            lg = model.logits(toks, cross, 0, len(toks) - 1)[0]
            c = greedy_choice(lg, seq, tok, rec["timestamps"])
            toks.append(c)
            seq.append(c)
            served.append(c)
            if c == tok.eot:
                break
        lang = rec.get("language")
        if lang is not None:
            ll = model.logits([tok.sot], cross, 0, 0)[0][tok.languages]
            lang = tok.languages[int(ll.argmax())]
        out.append(dict(rec, served=served, language=lang))
        del cross
    del model
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out
