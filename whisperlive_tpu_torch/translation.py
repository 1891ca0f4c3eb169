"""Any-to-any text translation of committed segments.

Behavioral port of the reference's translation backend
(whisper_live/backend/translation_backend.py, §2.16): a per-client worker
consumes completed segments from a bounded queue (maxsize 100), translates
them to `target_language`, and pushes `{"translated_segments": [...]}` to
the client.

The port's copy of whisperlive_tpu/translation.py. The worker is an asyncio
task (no thread per client), and the translation model is pluggable behind
`Translator`:

  * `TorchTranslator`: an on-disk SMALL100 or M2M100 checkpoint dir run by
    models/m2m100.py on the card (bf16; float32 on the CPU), loaded once
    and shared across clients;
  * `IdentityTranslator`: pass-through, when no model dir is configured.

Unlike the JAX package, a dir that fails to load raises instead of falling
through to a pass-through (which would hide that no model ran), and there is
no transformers-on-the-CPU translator.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import queue as queue_mod
import threading
from typing import Optional, Protocol

import torch

logger = logging.getLogger(__name__)

QUEUE_MAX = 100  # base.py:41


class Translator(Protocol):
    def translate(self, text: str, target_language: str) -> str: ...


class IdentityTranslator:
    """Pass-through (used when no translation model dir is configured)."""

    def translate(self, text: str, target_language: str) -> str:
        return text


class TorchTranslator:
    """M2M100/SMALL100 on the card (models/m2m100.py) from an HF checkpoint
    dir (config.json, model.safetensors). Source lengths are padded to
    buckets; SMALL100 carries the target language in the source sequence,
    M2M100 forces it as the decoder's first token."""

    _lock = threading.Lock()
    _shared: dict[str, "TorchTranslator"] = {}

    SRC_BUCKETS = (16, 32, 64, 128, 256)

    def __init__(self, model_dir: str, max_new: int = 200, beam_size: int | None = None,
                 device: str | torch.device = "cuda"):
        from whisperlive_tpu_torch.device import default_compute_dtype, resolve_device
        from whisperlive_tpu_torch.models import m2m100 as m2m
        from whisperlive_tpu_torch.models import safetensors_io
        from whisperlive_tpu_torch.small100_tokenizer import (
            SMALL100Tokenizer,
            load_checkpoint_tokenizer,
        )

        self.device = resolve_device(device)
        with open(os.path.join(model_dir, "config.json")) as f:
            cfg = m2m.config_from_hf(json.load(f))
        self.cfg = cfg.replace(dtype=default_compute_dtype(self.device))
        self.params = m2m.cast_params(
            m2m.params_from_state_dict(safetensors_io.load_dir(model_dir), self.cfg),
            self.cfg.dtype, self.device)
        self.tokenizer = load_checkpoint_tokenizer(model_dir)
        self.is_small100 = isinstance(self.tokenizer, SMALL100Tokenizer)
        self.max_new = max_new
        # The reference translates with M2M100's generation-config defaults,
        # beam 5 with early stopping (translation_backend.py calls a bare
        # generate()); WL_TRANSLATE_BEAM=1 decodes greedy.
        if beam_size is None:
            beam_size = int(os.environ.get("WL_TRANSLATE_BEAM", "5"))
        self.beam_size = max(beam_size, 1)
        self._lang_lock = threading.Lock()

    @classmethod
    def shared(cls, model_dir: str) -> "TorchTranslator":
        with cls._lock:
            if model_dir not in cls._shared:
                cls._shared[model_dir] = cls(model_dir)
            return cls._shared[model_dir]

    def _lang_id(self, code: str) -> int:
        tok = self.tokenizer
        if hasattr(tok, "get_lang_id"):
            return tok.get_lang_id(code)
        return tok.convert_tokens_to_ids(f"__{code}__")

    def generate(self, src: torch.Tensor, target_language: str) -> torch.Tensor:
        """src [B, bucket] pad-filled ids on the card -> [B, max_new] tokens."""
        from whisperlive_tpu_torch.models import m2m100 as m2m

        forced = None
        if not self.is_small100:
            forced = torch.full((src.shape[0],), self._lang_id(target_language),
                                dtype=torch.int64, device=src.device)
        if self.beam_size > 1:
            return m2m.generate_beam(self.params, self.cfg, src, forced, max_new=self.max_new,
                                     beam_size=self.beam_size)
        return m2m.generate_greedy(self.params, self.cfg, src, forced, max_new=self.max_new)

    def translate(self, text: str, target_language: str) -> str:
        tok = self.tokenizer
        if self.is_small100:
            with self._lang_lock:
                tok.tgt_lang = target_language
                ids = tok.encode(text)
        else:
            enc = tok(text)
            ids = enc["input_ids"] if isinstance(enc, dict) else enc.input_ids
        bucket = next((b for b in self.SRC_BUCKETS if len(ids) <= b), self.SRC_BUCKETS[-1])
        src = torch.full((1, bucket), self.cfg.pad_token_id, dtype=torch.int64)
        n = min(len(ids), bucket)
        src[0, :n] = torch.tensor(ids[:n], dtype=torch.int64)
        out = self.generate(src.to(self.device), target_language)[0].tolist()
        if self.cfg.eos_token_id in out:
            out = out[: out.index(self.cfg.eos_token_id)]
        return self.tokenizer.decode(out, skip_special_tokens=True)


def make_translator(model_dir: Optional[str] = None) -> Translator:
    """The shared TorchTranslator of `model_dir` (a load failure raises), or
    the pass-through without a dir."""
    if model_dir:
        return TorchTranslator.shared(model_dir)
    logger.warning("no translation model dir configured: translated_segments pass through "
                   "untranslated")
    return IdentityTranslator()


class TranslationWorker:
    """Per-client async worker: drains the session's translation queue,
    translates in a thread executor (model inference must not block the
    event loop), sends results (translation_backend.py:120-177)."""

    def __init__(
        self,
        client,  # ServeClient: needs .send(payload) and .uid
        target_language: str,
        translator: Translator,
        send_original: bool = False,
    ):
        self.client = client
        self.target_language = target_language or "fr"
        self.translator = translator
        self.send_original = send_original
        self.queue: "queue_mod.Queue[dict]" = queue_mod.Queue(maxsize=QUEUE_MAX)
        self._stop = False
        self._task = asyncio.get_running_loop().create_task(self._run())
        self._wake = asyncio.Event()

    def poke(self) -> None:
        self._wake.set()

    async def stop(self) -> None:
        self._stop = True
        self._wake.set()
        try:
            await asyncio.wait_for(self._task, timeout=5)
        except Exception:
            self._task.cancel()

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stop:
            batch: list[dict] = []
            while True:
                try:
                    batch.append(self.queue.get_nowait())
                except queue_mod.Empty:
                    break
            if not batch:
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=0.5)
                except asyncio.TimeoutError:
                    pass
                continue
            translated = []
            for seg in batch:
                try:
                    text = await loop.run_in_executor(
                        None,
                        self.translator.translate,
                        seg["text"],
                        self.target_language,
                    )
                except Exception:
                    logger.exception("translation failed")
                    text = seg["text"]
                out = dict(seg)
                out["text"] = text
                if self.send_original:
                    out["original_text"] = seg["text"]
                translated.append(out)
            if translated:
                await self.client.send(
                    {"uid": self.client.uid, "translated_segments": translated}
                )
