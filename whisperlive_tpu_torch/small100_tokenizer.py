"""Self-contained SMALL100 tokenizer (no sentencepiece / AutoTokenizer).

SMALL100 checkpoints (alirezamsh/small100) ship `vocab.json` +
`sentencepiece.bpe.model` and need language-token handling stock
transformers doesn't have — the reference vendors a 364-line
PreTrainedTokenizer subclass for it
(whisper_live/backend/tokenization_small100.py). This environment has no
`sentencepiece` wheel either, so this module implements the whole stack
itself:

  * a minimal protobuf reader for the SentencePiece ModelProto (only the
    `pieces` field: piece string, score, type),
  * SentencePiece-BPE inference: NFKC-ish normalization, "▁" word-boundary
    marking, then greedy highest-score adjacent-pair merges — the exact
    algorithm sentencepiece uses for BPE models at encode time,
  * the SMALL100 id layout: ids from vocab.json, language tokens
    `__xx__` appended at encoder_size + index over the fairseq m2m100
    code list, `num_madeup_words` tail padding,
  * SMALL100's defining quirk (tokenization_small100.py:339-346): the
    TARGET language token is prefixed to the SOURCE sequence
    (`[tgt_lang] X [eos]`), and target sequences get no prefix.

Only inference (encode/decode) is implemented — enough for the translation
worker; training-side APIs are out of scope.

The port's copy of whisperlive_tpu/small100_tokenizer.py, unchanged:
`transformers` is reached only for a checkpoint dir that is not SMALL100's.
"""

from __future__ import annotations

import json
import os
import struct
import unicodedata
from typing import List, Optional

SPIECE_UNDERLINE = "▁"

# fairseq m2m100 language-code order — a fixed public constant of the
# SMALL100/M2M100 vocab layout
FAIRSEQ_LANGUAGE_CODES = (
    "af am ar ast az ba be bg bn br bs ca ceb cs cy da de el en es et fa ff "
    "fi fr fy ga gd gl gu ha he hi hr ht hu hy id ig ilo is it ja jv ka kk "
    "km kn ko lb lg ln lo lt lv mg mk ml mn mr ms my ne nl no ns oc or pa "
    "pl ps pt ro ru sd si sk sl so sq sr ss su sv sw ta th tl tn tr uk ur "
    "uz vi wo xh yi yo zh zu"
).split()


# ---------------------------------------------------------------------------
# minimal protobuf wire-format reader for the SentencePiece model
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:  # 64-bit
        pos += 8
    elif wire_type == 2:  # length-delimited
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire_type == 5:  # 32-bit
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return pos


def _parse_sentence_piece(buf: bytes) -> tuple[str, float, int]:
    """SentencePiece message: 1=piece (string), 2=score (float), 3=type."""
    pos = 0
    piece, score, ptype = "", 0.0, 1
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, pos = _read_varint(buf, pos)
            piece = buf[pos : pos + n].decode("utf-8")
            pos += n
        elif field == 2 and wire == 5:
            (score,) = struct.unpack("<f", buf[pos : pos + 4])
            pos += 4
        elif field == 3 and wire == 0:
            ptype, pos = _read_varint(buf, pos)
        else:
            pos = _skip_field(buf, pos, wire)
    return piece, score, ptype


def read_spm_model(path: str) -> list[tuple[str, float, int]]:
    """Parse a SentencePiece .model file into [(piece, score, type)].
    ModelProto field 1 = repeated SentencePiece; everything else skipped."""
    with open(path, "rb") as f:
        buf = f.read()
    pieces = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            n, pos = _read_varint(buf, pos)
            pieces.append(_parse_sentence_piece(buf[pos : pos + n]))
            pos += n
        else:
            pos = _skip_field(buf, pos, wire)
    return pieces


def write_spm_model(path: str, pieces: list[tuple[str, float, int]]) -> None:
    """Write a minimal BPE ModelProto (tests build toy models with this)."""

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                return out + bytes([b7])

    blob = b""
    for piece, score, ptype in pieces:
        p = piece.encode("utf-8")
        msg = (
            bytes([0x0A]) + varint(len(p)) + p
            + bytes([0x15]) + struct.pack("<f", score)
            + bytes([0x18]) + varint(ptype)
        )
        blob += bytes([0x0A]) + varint(len(msg)) + msg
    with open(path, "wb") as f:
        f.write(blob)


# ---------------------------------------------------------------------------
# SentencePiece-BPE inference
# ---------------------------------------------------------------------------


class SPMBpe:
    """Encode text into sentencepiece-BPE pieces by greedy highest-score
    adjacent merges (what the sentencepiece runtime does for model_type=bpe)."""

    def __init__(self, pieces: list[tuple[str, float, int]]):
        # type 1 = normal piece; specials (unk/bos/eos, type 2/3) never merge
        self.scores = {p: s for p, s, t in pieces if t == 1}
        self.known = set(self.scores)

    def encode(self, text: str) -> List[str]:
        text = unicodedata.normalize("NFKC", text)
        text = SPIECE_UNDERLINE + text.replace(" ", SPIECE_UNDERLINE)
        symbols = list(text)
        while len(symbols) > 1:
            best_score, best_i = None, -1
            for i in range(len(symbols) - 1):
                cand = symbols[i] + symbols[i + 1]
                s = self.scores.get(cand)
                if s is not None and (best_score is None or s > best_score):
                    best_score, best_i = s, i
            if best_i < 0:
                break
            symbols[best_i : best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        return symbols

    @staticmethod
    def decode(pieces: List[str]) -> str:
        return "".join(pieces).replace(SPIECE_UNDERLINE, " ").strip()


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------


class SMALL100Tokenizer:
    """SMALL100 checkpoint tokenizer over (vocab.json, sentencepiece.bpe.model).

    Ids come from vocab.json; language tokens __xx__ occupy
    [encoder_size, encoder_size + 100); `num_madeup_words` pads the tail.
    Source sequences are `[__tgt_lang__] X [eos]` (the target language is
    encoded on the SOURCE side — SMALL100's defining difference from
    M2M100); target sequences are `X [eos]`.
    """

    def __init__(
        self,
        vocab_file: str,
        spm_file: str,
        tgt_lang: str = "en",
        num_madeup_words: int = 8,
    ):
        with open(vocab_file) as f:
            self.encoder: dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe = SPMBpe(read_spm_model(spm_file))
        self.encoder_size = len(self.encoder)
        self.lang_code_to_id = {
            code: self.encoder_size + i
            for i, code in enumerate(FAIRSEQ_LANGUAGE_CODES)
        }
        self.id_to_lang_token = {
            v: f"__{k}__" for k, v in self.lang_code_to_id.items()
        }
        self.num_madeup_words = num_madeup_words
        self.unk_token, self.pad_token, self.eos_token = "<unk>", "<pad>", "</s>"
        self.eos_token_id = self.encoder[self.eos_token]
        self.pad_token_id = self.encoder[self.pad_token]
        self.unk_token_id = self.encoder[self.unk_token]
        self._tgt_lang = tgt_lang

    # -- layout ---------------------------------------------------------

    @classmethod
    def from_pretrained(cls, model_dir: str, **kw) -> "SMALL100Tokenizer":
        return cls(
            os.path.join(model_dir, "vocab.json"),
            os.path.join(model_dir, "sentencepiece.bpe.model"),
            **kw,
        )

    @property
    def vocab_size(self) -> int:
        return self.encoder_size + len(self.lang_code_to_id) + self.num_madeup_words

    @property
    def tgt_lang(self) -> str:
        return self._tgt_lang

    @tgt_lang.setter
    def tgt_lang(self, lang: str) -> None:
        if lang not in self.lang_code_to_id:
            raise ValueError(f"unsupported language code {lang!r}")
        self._tgt_lang = lang

    def get_lang_id(self, lang: str) -> int:
        return self.lang_code_to_id[lang]

    # -- encode / decode --------------------------------------------------

    def tokenize(self, text: str) -> List[str]:
        return self.bpe.encode(text)

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        return [self.encoder.get(t, self.unk_token_id) for t in tokens]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        """Source-mode encode: [__tgt_lang__] + X + [eos]
        (set_lang_special_tokens semantics, tokenization_small100.py:339-346)."""
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if not add_special_tokens:
            return ids
        return [self.get_lang_id(self._tgt_lang)] + ids + [self.eos_token_id]

    def encode_target(self, text: str) -> List[int]:
        """Target-mode encode: X + [eos] (no prefix)."""
        return self.convert_tokens_to_ids(self.tokenize(text)) + [self.eos_token_id]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        pieces = []
        for i in ids:
            i = int(i)
            if i in self.id_to_lang_token:
                if not skip_special_tokens:
                    pieces.append(self.id_to_lang_token[i])
                continue
            tok = self.decoder.get(i, self.unk_token)
            if skip_special_tokens and tok in (
                "<s>", "</s>", "<pad>", "<unk>",
            ):
                continue
            pieces.append(tok)
        return SPMBpe.decode(pieces)

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def __call__(self, text: str, return_tensors: Optional[str] = None):
        """transformers-style call for the translators: returns input_ids +
        attention_mask (lists, or torch tensors with return_tensors='pt')."""
        ids = self.encode(text)
        out = {"input_ids": [ids], "attention_mask": [[1] * len(ids)]}
        if return_tensors == "pt":
            import torch

            out = {k: torch.tensor(v) for k, v in out.items()}
        elif return_tensors == "np":
            import numpy as np

            out = {k: np.asarray(v) for k, v in out.items()}
        return out


def is_small100_checkpoint(model_dir: str) -> bool:
    """SMALL100 layout: vocab.json + sentencepiece.bpe.model, and either a
    tokenizer_config naming SMALL100Tokenizer or no tokenizer.json at all
    (plain M2M100 dirs ship a fast tokenizer.json AutoTokenizer can load)."""
    if not (
        os.path.exists(os.path.join(model_dir, "vocab.json"))
        and os.path.exists(os.path.join(model_dir, "sentencepiece.bpe.model"))
    ):
        return False
    cfg_path = os.path.join(model_dir, "tokenizer_config.json")
    if os.path.exists(cfg_path):
        try:
            with open(cfg_path) as f:
                if "SMALL100" in (json.load(f).get("tokenizer_class") or ""):
                    return True
        except Exception:
            pass
    return not os.path.exists(os.path.join(model_dir, "tokenizer.json"))


def load_checkpoint_tokenizer(model_dir: str):
    """The tokenizer for a translation checkpoint dir: our SMALL100
    implementation for SMALL100 layouts, AutoTokenizer otherwise."""
    if is_small100_checkpoint(model_dir):
        return SMALL100Tokenizer.from_pretrained(model_dir)
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(model_dir)
