"""Draft distillation: a distil-style student decoder for speculative
serving (engine/speculative.py, the continuous pools' draft).

Port of whisperlive_tpu/distill.py. The student shares the teacher's
encoder (frozen) and keeps a few decoder layers, initialized from
maximally-spaced teacher layers; training minimizes a word-level KL to the
teacher's distribution plus the cross-entropy on the teacher's own argmax,
which is what speculative acceptance compares against. Encoder geometry
and vocabulary are shared by construction, so the result is a draft for
the teacher.

Two differences from JAX arrays shape the code: torch optimizers update in
place, so the student's tensors are copies, never views of the teacher's;
and the frozen teacher runs under torch.no_grad() in place of
stop_gradient, through the serving encoder (the K1 kernel on CUDA).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from whisperlive_tpu_torch.models import whisper as wmod
from whisperlive_tpu_torch.training import (
    AdamW,
    AdamWState,
    decoder_forward_train,
    leaves,
    value_and_grad,
)


def student_layer_indices(n_teacher: int, n_student: int) -> list[int]:
    """Maximally-spaced teacher layers, always including the first and the
    last (distil-whisper initializes a 2-layer student from [0, L-1])."""
    if n_student >= n_teacher:
        return list(range(n_teacher))
    if n_student == 1:
        return [n_teacher - 1]
    return [round(i * (n_teacher - 1) / (n_student - 1)) for i in range(n_student)]


def student_config(teacher_cfg: wmod.WhisperConfig, n_text_layer: int = 2) -> wmod.WhisperConfig:
    """The distil shape: the teacher's encoder, width, heads and vocabulary
    with fewer decoder layers (distil-large-v3 is large-v3 with 2)."""
    return teacher_cfg.replace(n_text_layer=n_text_layer)


def init_student_from_teacher(teacher_params: wmod.Params, n_text_layer: int = 2) -> wmod.Params:
    """Student params: the teacher's encoder (shared: it is never trained)
    and a decoder of copies of the teacher's embedding, position table,
    final norm and maximally-spaced layers. With the teacher's own layer
    count this is an exact copy."""
    dec = teacher_params["decoder"]
    n_teacher = leaves(dec["layers"])[0].shape[0]
    idx = torch.tensor(student_layer_indices(n_teacher, n_text_layer),
                       device=dec["embed"].device)
    return {
        "encoder": teacher_params["encoder"],
        "decoder": {
            "embed": dec["embed"].clone(),
            "pos": dec["pos"].clone(),
            "layers": wmod.tree_map(lambda t: t.index_select(0, idx), dec["layers"]),
            "ln": wmod.tree_map(torch.clone, dec["ln"]),
        },
    }


def distill_loss(student_decoder: dict, teacher_params: wmod.Params,
                 student_cfg: wmod.WhisperConfig, teacher_cfg: wmod.WhisperConfig,
                 mel: torch.Tensor | None, tokens_in: torch.Tensor, loss_mask: torch.Tensor,
                 kl_weight: float = 0.8, ce_weight: float = 1.0, temperature: float = 2.0,
                 enc: torch.Tensor | None = None,
                 t_logits: torch.Tensor | None = None) -> torch.Tensor:
    """The KD objective on one batch: mel [B, T_mel, n_mels] (or None with
    `enc` [B, T_enc, d] given), teacher-forced tokens_in [B, T], loss_mask
    [B, T] float32. The teacher's encoder states and logits are constants
    of the (clip, pseudo-label) pool, so callers may pass them precomputed
    (`enc`, `t_logits` [B, T, V]); only the student's decoder takes
    gradients."""
    with torch.no_grad():
        if enc is None:
            enc = wmod.encode(teacher_params, teacher_cfg, mel)
        if t_logits is None:
            t_logits = decoder_forward_train(teacher_params, teacher_cfg, tokens_in, enc)
    t_logits = t_logits.float()
    s_params = {"encoder": teacher_params["encoder"], "decoder": student_decoder}
    s_logits = decoder_forward_train(s_params, student_cfg, tokens_in, enc)

    # word-level KL at temperature tau (distil-whisper eq. 2)
    t_lp = torch.log_softmax(t_logits / temperature, dim=-1)
    s_lp = torch.log_softmax(s_logits / temperature, dim=-1)
    kl = torch.sum(torch.exp(t_lp) * (t_lp - s_lp), dim=-1)  # [B, T]
    # the teacher's argmax is what the verifier accepts a draft token by
    pseudo = torch.argmax(t_logits, dim=-1)
    ce = -torch.log_softmax(s_logits, dim=-1).gather(-1, pseudo[..., None])[..., 0]
    denom = torch.clamp(torch.sum(loss_mask), min=1.0)
    return (kl_weight * temperature**2 * torch.sum(kl * loss_mask)
            + ce_weight * torch.sum(ce * loss_mask)) / denom


@dataclasses.dataclass
class DistillState:
    student_decoder: dict
    opt_state: AdamWState
    step: int


def make_distill_step(student_cfg: wmod.WhisperConfig, teacher_cfg: wmod.WhisperConfig,
                      optimizer: AdamW, kl_weight: float = 0.8, ce_weight: float = 1.0,
                      temperature: float = 2.0):
    """-> step(state, teacher_params, batch) -> (state, loss): one update of
    the student decoder in place. batch holds "tokens_in", "loss_mask" and
    "mel" or the precomputed "enc" (and optionally "t_logits")."""

    def step(state: DistillState, teacher_params: wmod.Params, batch: dict):
        loss, grads = value_and_grad(lambda: distill_loss(
            state.student_decoder, teacher_params, student_cfg, teacher_cfg, batch.get("mel"),
            batch["tokens_in"], batch["loss_mask"], kl_weight=kl_weight, ce_weight=ce_weight,
            temperature=temperature, enc=batch.get("enc"), t_logits=batch.get("t_logits"),
        ), state.student_decoder)
        optimizer.update(grads, state.opt_state, state.student_decoder)
        state.step += 1
        return state, loss

    return step


def init_distill_state(teacher_params: wmod.Params, optimizer: AdamW,
                       n_text_layer: int = 2) -> DistillState:
    dec = init_student_from_teacher(teacher_params, n_text_layer)["decoder"]
    return DistillState(dec, optimizer.init(dec), 0)


def student_params(teacher_params: wmod.Params, state: DistillState) -> wmod.Params:
    """The draft's full params: the shared encoder and the trained decoder."""
    return {"encoder": teacher_params["encoder"], "decoder": state.student_decoder}


@torch.no_grad()
def measure_acceptance(teacher_params: wmod.Params, student: wmod.Params,
                       teacher_cfg: wmod.WhisperConfig, student_cfg: wmod.WhisperConfig,
                       mel, tokens_in, loss_mask, enc=None) -> float:
    """Teacher-forced greedy agreement over the masked positions: the upper
    bound of the speculative acceptance this draft reaches at k=1 on this
    data. Array inputs may be numpy arrays or tensors."""
    dev = teacher_params["decoder"]["pos"].device
    tokens_in = torch.as_tensor(tokens_in, device=dev)
    enc = (wmod.encode(teacher_params, teacher_cfg, torch.as_tensor(mel, device=dev))
           if enc is None else torch.as_tensor(enc, device=dev))
    t = torch.argmax(decoder_forward_train(teacher_params, teacher_cfg, tokens_in, enc), dim=-1)
    s = torch.argmax(decoder_forward_train(student, student_cfg, tokens_in, enc), dim=-1)
    t, s = t.cpu().numpy(), s.cpu().numpy()
    m = np.asarray(torch.as_tensor(loss_mask).cpu()) > 0
    return float((t[m] == s[m]).mean()) if m.any() else 0.0
