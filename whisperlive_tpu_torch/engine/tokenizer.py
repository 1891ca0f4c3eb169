"""Whisper tokenizer: special-token layout + pluggable text BPE backend.

The reference gets this from the faster_whisper `Tokenizer` over HF's Rust
`tokenizers` (contract documented in SURVEY §2.9a: sot sequence, language
tokens, timestamp tokens at 0.02 s precision, non_speech_tokens,
split_to_word_tokens). Here the special-token ID layout is derived in closed
form from (n_vocab, multilingual) — it is a fixed function of the
architecture — while text encode/decode delegates to:

  * `tokenizers.Tokenizer` loaded from an HF `tokenizer.json` when model
    files are available (production path), or
  * a hermetic byte-level fallback (ids < 256 are raw UTF-8 bytes) used by
    offline tests and random-weight benchmarks where text content is
    irrelevant.

Special layout (verified against the public Whisper vocab):
    eot = sot - 1
    sot = n_vocab - 1501 - 6 - num_languages - 1
    languages:      sot+1 .. sot+num_languages
    translate:      sot+num_languages+1
    transcribe:     sot+num_languages+2
    startoflm:      +3,  startofprev: +4,  nospeech: +5,  notimestamps: +6
    timestamps:     notimestamps+1 .. n_vocab-1   (1501 tokens, 0.02 s steps)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

# Whisper language registry, in official token order. v3 vocabularies
# (n_vocab == 51866) append "yue" as the 100th language.
_LANGUAGE_CODES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su"
).split()
_LANGUAGE_CODES_V3 = _LANGUAGE_CODES + ["yue"]

LANGUAGES = {
    "en": "english", "zh": "chinese", "de": "german", "es": "spanish",
    "ru": "russian", "ko": "korean", "fr": "french", "ja": "japanese",
    "pt": "portuguese", "tr": "turkish", "pl": "polish", "ca": "catalan",
    "nl": "dutch", "ar": "arabic", "sv": "swedish", "it": "italian",
    "id": "indonesian", "hi": "hindi", "fi": "finnish", "vi": "vietnamese",
    "he": "hebrew", "uk": "ukrainian", "el": "greek", "ms": "malay",
    "cs": "czech", "ro": "romanian", "da": "danish", "hu": "hungarian",
    "ta": "tamil", "no": "norwegian", "th": "thai", "ur": "urdu",
    "hr": "croatian", "bg": "bulgarian", "lt": "lithuanian", "la": "latin",
    "mi": "maori", "ml": "malayalam", "cy": "welsh", "sk": "slovak",
    "te": "telugu", "fa": "persian", "lv": "latvian", "bn": "bengali",
    "sr": "serbian", "az": "azerbaijani", "sl": "slovenian", "kn": "kannada",
    "et": "estonian", "mk": "macedonian", "br": "breton", "eu": "basque",
    "is": "icelandic", "hy": "armenian", "ne": "nepali", "mn": "mongolian",
    "bs": "bosnian", "kk": "kazakh", "sq": "albanian", "sw": "swahili",
    "gl": "galician", "mr": "marathi", "pa": "punjabi", "si": "sinhala",
    "km": "khmer", "sn": "shona", "yo": "yoruba", "so": "somali",
    "af": "afrikaans", "oc": "occitan", "ka": "georgian", "be": "belarusian",
    "tg": "tajik", "sd": "sindhi", "gu": "gujarati", "am": "amharic",
    "yi": "yiddish", "lo": "lao", "uz": "uzbek", "fo": "faroese",
    "ht": "haitian creole", "ps": "pashto", "tk": "turkmen", "nn": "nynorsk",
    "mt": "maltese", "sa": "sanskrit", "lb": "luxembourgish", "my": "myanmar",
    "bo": "tibetan", "tl": "tagalog", "mg": "malagasy", "as": "assamese",
    "tt": "tatar", "haw": "hawaiian", "ln": "lingala", "ha": "hausa",
    "ba": "bashkir", "jw": "javanese", "su": "sundanese", "yue": "cantonese",
}

TIME_PRECISION = 0.02  # seconds per timestamp token
N_TIMESTAMP_TOKENS = 1501  # <|0.00|> .. <|30.00|>


@dataclasses.dataclass(frozen=True)
class TokenSpec:
    """Closed-form special-token IDs for a given vocabulary size."""

    n_vocab: int
    multilingual: bool

    @property
    def num_languages(self) -> int:
        if not self.multilingual:
            # English-only vocabs still reserve the 99-language block.
            return 99
        return 100 if self.n_vocab >= 51866 else 99

    @property
    def sot(self) -> int:
        return self.n_vocab - N_TIMESTAMP_TOKENS - 6 - self.num_languages - 1

    @property
    def eot(self) -> int:
        return self.sot - 1

    @property
    def translate(self) -> int:
        return self.sot + self.num_languages + 1

    @property
    def transcribe(self) -> int:
        return self.sot + self.num_languages + 2

    @property
    def sot_lm(self) -> int:
        return self.sot + self.num_languages + 3

    @property
    def sot_prev(self) -> int:
        return self.sot + self.num_languages + 4

    @property
    def no_speech(self) -> int:
        return self.sot + self.num_languages + 5

    @property
    def no_timestamps(self) -> int:
        return self.sot + self.num_languages + 6

    @property
    def timestamp_begin(self) -> int:
        return self.no_timestamps + 1

    @property
    def language_codes(self) -> list[str]:
        codes = _LANGUAGE_CODES_V3 if self.num_languages == 100 else _LANGUAGE_CODES
        return list(codes)

    def language_token(self, code: str) -> int:
        try:
            return self.sot + 1 + self.language_codes.index(code)
        except ValueError:
            raise ValueError(f"unsupported language code: {code!r}") from None

    def language_of(self, token: int) -> str:
        idx = token - self.sot - 1
        codes = self.language_codes
        if not 0 <= idx < len(codes):
            raise ValueError(f"token {token} is not a language token")
        return codes[idx]

    @property
    def all_language_tokens(self) -> list[int]:
        return [self.sot + 1 + i for i in range(self.num_languages)]

    def timestamp_token(self, seconds: float) -> int:
        return self.timestamp_begin + int(round(seconds / TIME_PRECISION))

    def timestamp_of(self, token: int) -> float:
        return (token - self.timestamp_begin) * TIME_PRECISION


class _ByteTextBackend:
    """Hermetic fallback: UTF-8 bytes as ids < 256. No model files needed."""

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")

    def id_to_piece(self, token_id: int) -> str:
        return chr(token_id) if 0 <= token_id < 256 else ""


class _HFTextBackend:
    """HF `tokenizers` Rust BPE over a tokenizer.json file (production)."""

    def __init__(self, tokenizer_file: str):
        from tokenizers import Tokenizer

        self._tok = Tokenizer.from_file(tokenizer_file)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def id_to_piece(self, token_id: int) -> str:
        piece = self._tok.decode([token_id], skip_special_tokens=True)
        return piece


class WhisperTokenizer:
    """Task-configured tokenizer (mirrors faster_whisper's Tokenizer facade)."""

    def __init__(
        self,
        spec: TokenSpec,
        backend=None,
        language: str | None = None,
        task: str = "transcribe",
    ):
        self.spec = spec
        self.backend = backend or _ByteTextBackend()
        self.language = language
        self.task = task

    @classmethod
    def from_files(
        cls,
        n_vocab: int,
        tokenizer_file: str | None = None,
        multilingual: bool = True,
        language: str | None = None,
        task: str = "transcribe",
    ) -> "WhisperTokenizer":
        backend = _HFTextBackend(tokenizer_file) if tokenizer_file else None
        return cls(TokenSpec(n_vocab, multilingual), backend, language, task)

    # -- special ids (delegate to spec) ------------------------------------
    @property
    def eot(self) -> int:
        return self.spec.eot

    @property
    def sot(self) -> int:
        return self.spec.sot

    @property
    def sot_prev(self) -> int:
        return self.spec.sot_prev

    @property
    def no_speech(self) -> int:
        return self.spec.no_speech

    @property
    def no_timestamps(self) -> int:
        return self.spec.no_timestamps

    @property
    def timestamp_begin(self) -> int:
        return self.spec.timestamp_begin

    @property
    def transcribe_token(self) -> int:
        return self.spec.transcribe

    @property
    def translate_token(self) -> int:
        return self.spec.translate

    def sot_sequence(self, include_timestamps: bool = True) -> list[int]:
        """[sot, lang, task(, notimestamps)] — english-only models use [sot]."""
        seq = [self.spec.sot]
        if self.spec.multilingual:
            lang = self.language or "en"
            seq.append(self.spec.language_token(lang))
            seq.append(
                self.spec.translate if self.task == "translate" else self.spec.transcribe
            )
        if not include_timestamps:
            seq.append(self.spec.no_timestamps)
        return seq

    # -- text ---------------------------------------------------------------
    def encode(self, text: str) -> list[int]:
        return self.backend.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self.backend.decode([i for i in ids if i < self.spec.eot])

    def decode_with_timestamps(self, ids: Sequence[int]) -> str:
        out = []
        chunk: list[int] = []
        for t in ids:
            if t >= self.spec.timestamp_begin:
                if chunk:
                    out.append(self.decode(chunk))
                    chunk = []
                out.append(f"<|{self.spec.timestamp_of(t):.2f}|>")
            else:
                chunk.append(t)
        if chunk:
            out.append(self.decode(chunk))
        return "".join(out)

    def split_to_word_tokens(
        self, tokens: Sequence[int]
    ) -> tuple[list[str], list[list[int]]]:
        """Group text tokens into display words (space/punct boundaries).

        Mirrors the behavior the reference relies on for word timestamps
        (transcriber_faster_whisper.py:1671-1673): languages written without
        spaces split per token, otherwise split where a decoded piece starts
        with whitespace.
        """
        if self.language in {"zh", "ja", "th", "lo", "my", "yue"}:
            words, word_tokens = [], []
            for t in tokens:
                piece = self.backend.id_to_piece(t)
                if not piece:
                    continue
                words.append(piece)
                word_tokens.append([t])
            return words, word_tokens

        words: list[str] = []
        word_tokens: list[list[int]] = []
        current = ""
        current_toks: list[int] = []
        for t in tokens:
            if t >= self.spec.eot:
                continue
            piece = self.backend.id_to_piece(t)
            if piece.startswith(" ") and current.strip():
                words.append(current)
                word_tokens.append(current_toks)
                current, current_toks = "", []
            current += piece
            current_toks.append(t)
        if current_toks:
            words.append(current)
            word_tokens.append(current_toks)
        # Words keep their leading space (faster-whisper convention: the
        # concatenation of Word.word fields reconstructs the segment text).
        return words, word_tokens

    @property
    def non_speech_tokens(self) -> list[int]:
        """Token ids for music/noise symbols, suppressed during decoding.

        Computed from the BPE vocab when a real backend is present (same
        symbol set the reference's tokenizer exposes); empty under the byte
        fallback (tests don't decode real text).
        """
        if isinstance(self.backend, _ByteTextBackend):
            # Bytes for the symbol set themselves.
            symbols = "\"#()*+/:;<=>@[\\]^_`{|}~「」『』♪♩♫♬"
            return sorted({ord(c) for c in symbols if ord(c) < 256})
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        )
        miscellaneous = set("♩♪♫♬♭♮♯")
        result = set()
        for symbol in symbols + list(miscellaneous):
            for tok_text in (symbol, " " + symbol):
                ids = self.backend.encode(tok_text)
                if len(ids) == 1:
                    result.add(ids[0])
        # "-" and "'" only in word-initial (spaced) position
        for symbol in "-'":
            ids = self.backend.encode(" " + symbol)
            if len(ids) == 1:
                result.add(ids[0])
        return sorted(result)


def get_suppressed_tokens(
    tokenizer: WhisperTokenizer, suppress_tokens: Sequence[int] | None
) -> list[int]:
    """Expand the user-facing suppress list (mirrors
    transcriber_faster_whisper.py:1831-1853): -1 means the default
    non-speech set; specials are always suppressed."""
    spec = tokenizer.spec
    tokens: set[int] = set()
    if suppress_tokens is None:
        suppress_tokens = [-1]
    for t in suppress_tokens:
        if t == -1:
            tokens.update(tokenizer.non_speech_tokens)
        elif t >= 0:
            tokens.add(t)
    tokens.update(
        {spec.transcribe, spec.translate, spec.sot, spec.sot_prev, spec.sot_lm}
    )
    # <|nospeech|> is read (its probability at the sot position), never
    # sampled: openai's _get_suppress_tokens always adds it, and HF configs
    # carry it in suppress_tokens — without this, temperature sampling can
    # emit the special token mid-hypothesis (it is neither text nor
    # timestamp, so the pairing rules don't block it everywhere).
    tokens.add(spec.no_speech)
    return sorted(tokens)
