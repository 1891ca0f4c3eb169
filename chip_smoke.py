"""Drive the PyTorch port's serving paths (the websocket server, REST,
diarization and translation), its offline file path, its training and
distillation path, its tensor and data parallelism (two ranks), its
tooling (the profiler, the roofline, the WER harness and the VAD and speaker
trainers) and five published model configurations once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; without CUDA it exits 1 before printing
a result):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the five CUDA sources of whisperlive_tpu_torch/csrc with nvcc
   (one process per source, in parallel): nine kernel entry points. Print
   what `nvcc -Xptxas -v` reports for K1, K2, K3 and for each codec and Tq
   instantiation of the cross-attention source (Int8Packed: K4 and K5 at
   Tq = 1, K6 and K5's window form at 2..8; Int4Halves: K7 at Tq = 1, K8
   at 2..8; registers, spills); any spill there fails the phase.
3. Hold each kernel against its plain PyTorch version on the card at the
   serving paths' shapes (large-v3) in bf16, with the stated tolerance,
   and time both (CUDA events, median of 20 runs of 10 calls), plus one
   PyTorch call that computes the same function where there is one (the
   port never calls it). K1 is also checked at the 512-position encoder
   context and, at T = 1500, with q drawn 4x larger (a peaked softmax);
   its entry carries those shapes in `other_shapes`, each with its ratio
   to scaled_dot_product_attention (`sdpa_ratio`). K2 at the window
   batch's M=4 and the continuous pool's M=8 (its entry reports the
   pool's shape), and at the offline path's M = 1, 16, 32 and 256 (the
   decode step, the prompt buckets, --batched's pair). K3 at M = 1, 4, 8 (the pool's, its entry's shape), 16
   and 40 (the 8-slot verify window), each timed warm and cold (rotating
   over distinct embedding copies that exceed the L2) beside
   torch._weight_int8pack_mm and, cold, torch.matmul on the embedding
   dequantized to bf16 (`bf16_gemm_ms`); its entry carries them as
   `other_shapes` and `cold`. K2 is also timed cold (rotating over
   distinct weight copies that exceed the L2) at each of those shapes and
   at prefill M=64, and over a decode-step sweep (the 256 K2 calls of one
   large-v3 step at M=8, 32 layers of distinct weights), each beside
   torch.matmul on the weights dequantized to bf16 (`bf16_gemm_ms`); its
   entry carries them as `cold` and `step_sweep`. K4 at [B,20,64] x
   [B,20,1500,128] for the window buckets B = 1, 2, 4 and at B = 4 with
   lengths [1500,700,1,0], and at the beam routes' 10 rows: [10,20,64] x
   [10,20,1500,128] (the window route) and x [10,20,640,128] with lengths
   5 x 512 and 5 x 640 (the beam pool), and at the distiller's
   pseudo-labelling batch [8,20,64] x [8,20,512,128]; K5 at [8,20,64] x [8,20,640,128] with mixed
   lengths, half the rows active, an active row of length 0, lengths on
   and past the chunk boundaries of its split over T, and 8/8, 4/8 and
   1/8 rows active. The speculative verify's kernels at k=4 (a window of 5
   queries): K6 at [1,20,5,64] x [1,20,1500,128] and at Tq=8, each
   unmasked and with lengths; K5's window form at [8,20,5,64] x
   [8,20,640,128] in K5's cases but the chunk boundaries, and at Tq=8 with
   8/8 active; K7 at [4,20,64] x 2x[4,20,1500,32] and [8,20,64] x
   2x[8,20,640,32], unmasked and with lengths; K8 at [8,20,5,64] x
   2x[8,20,640,32], unmasked and with lengths. Every case of K4 and K6-K8,
   and K5's three occupancies, is also timed cold (rotating over distinct
   K/V copies that exceed the L2), beside scaled_dot_product_attention at
   the same Tq on K and V dequantized to bf16 (`sdpa_bf16_ms`; the port
   never calls it); each case of K7 and K8 also beside the int8 kernel
   (K4's entry at Tq = 1, K6's above) at the same [B,H,T], Tq and lengths
   on int8 K|V (`int8_ms`); the entries carry the other cases as
   `other_shapes` and `cold`. The cross-attention kernels' tolerance is a share of each
   batch row's own max|ref|.
   Then the encoder forward: one encode call (32 layers) at mel
   [4,3000,128] and at the insert bucket's [8,1024,128] on the host clock,
   beside 32 x K1's time as K1's share, printed as {"encoder_forward": ...}.
4. Serve the window path: large-v3 at full width with random bf16 weights
   from a seed, a WhisperEngine, BatchScheduler(max_batch_size=4) and
   TorchBackend, warmed up; two streaming sessions through the port's
   TranscriptionServer connection handler on an in-process websocket.
5. Serve the continuous path on the same engine: ContinuousScheduler
   (8 slots, 8 steps per chunk, cross cap 640, encoder buckets 512 and
   1500) behind TorchBackend; three ~10 s streaming sessions, the third
   joining 2 s late so that a window joins a running decode, one with the
   VAD gate off. A torch.profiler window over one step chunk prints the
   launches and device time per step, and the five largest CUDA kernels,
   K5 and K3 by device time per step.
6. Serve the three speculative routes with a random distil-large-v3 draft
   (seed + 1) at k=4: the window route (SpeculativeDecoder on the
   BatchScheduler, one stream of lone greedy requests) and the continuous
   `all` pool (every chunk is verify rounds) on the int8 engine, and the
   `mixed` routing (full re-decodes on a second, speculative pool with
   acceptance hysteresis, tails on the plain pool) on an int4 engine built
   from the same parameters. Acceptance and committed tokens per round are
   printed. Each path's launch counters are reset just before its sessions
   and read after its schedulers stopped; every kernel of the path must
   have launched, and the slot state must lie on the card. A torch.profiler
   window over two verify rounds prints the device time a round and the
   verify kernel's share: K6 on the window route (one decode of two rounds
   less one of none), K5's window form in an `all` pool and K8 in an int4
   speculative pool, each of one round a chunk.
7. Serve beam search and word timestamps on the int8 engine (no warmup:
   PyTorch compiles nothing, and the kernels are built). The window route
   at beam 5, batch bucket 2, 48 new tokens through transcribe_batch: the
   time per window, the K2/K3/K4 launches a beam step (a full decode less
   a one-step one), the device time a beam step and the self-KV parent
   gather's share (torch.profiler, a BEAM_PROFILE_TOKENS decode less a
   one-step one); beam K = 1 is
   token-exact against the greedy decode and the chunked beam (segments of
   8 steps) against the monolithic one. A beam pool (--beam_size 5
   --beam_mode full: 2 slots x 5 lanes) serving one session, which must
   launch K4 and never K5, with its launches and device time a step (one
   profiled chunk); a
   refresh-mode backend (greedy partials on an 8-slot pool, beamed full
   re-decodes on the window scheduler in preemptible segments) serving one
   session, which must route both ways. One word-timestamp session on the
   continuous route and one on the window route: every word has start <=
   end inside its window, and starts and ends are non-decreasing. Then the
   alignment pass of a 40-token hypothesis at 1500 and 640 positions, its
   time (the median of 5 and the first), its maps' copy and its launches.
8. Drive the offline file path on the int8 engine's parameters: write the
   random bf16 tree (regenerated from the seed) as an HF checkpoint in two
   shards with an index, convert it with the port's convert CLI, and load
   both dirs through loader.resolve_model: every leaf bit-equal to the
   source (write, convert and load times). Then the offline CLI
   (cli.transcribe, -tpu on the converted dir, --no_gates --language en
   --max_new_tokens OFFLINE_MAX_NEW --word_timestamps -f json) on two speech-like WAVs
   of 70 s and 12 s: exit 0, and its JSON segments (text, start, end) and
   words equal to Transcriber(engine).transcribe of the same audio on the
   in-memory engine; words ordered and in their segments (a segment's
   edge words at most EDGE_WORD_SLACK_S past it). Each seek
   window's host time and launches (K1 32 a window; K2 256, K3 1, K4 32 a
   decode step, plus the prefill's and the alignment pass's; no other
   kernel). --batched over the same files (one result each, segments
   ordered; the time a batch); Transcriber with the VAD filter on speech,
   10 s of silence and speech (no segment starts in the removed gap);
   detect_language over 2 windows (probabilities sum to 1); log_mel_full of
   the 70 s clip on the card against the CPU, and against a float32
   torch.stft of it on the CPU, within 1e-4. The tokenizer of
   the CLI's engine is the visible one (the repository has no BPE
   vocabulary). Printed as {"offline": ...}.
9. Check the output against a reference: the window path's encoder states
   and teacher-forced logits, an offline seek window's (B = 1, prepare_mel,
   prompts at the 16- and 256-token buckets), the first beam steps' logits (B*K = 10 rows;
   the plain path follows the kernel path's beams), the first steps of a
   2 x 5-lane beam pool from one inserted state (10 rows with the slots'
   cross_len 512 and 640, no active rows: K4 with lengths, never K5; the
   plain path follows its beams too), the continuous step (decode_step_masked
   on an 8-slot pool with per-slot cross_len and free rows, teacher
   forced; K5 at int8, K7 at int4), and the verify window (decode_window,
   and decode_window_masked with per-row cross_len and an inactive row) at
   int8 and int4, each against the same engine with every kernel wrapper swapped for its plain
   version; values must agree within the tolerance, be finite and have
   the expected shapes, and the argmax must agree on every active row up
   to ties within twice the measured error. One speculative greedy decode
   is held against the plain greedy decode of the same window: the tokens
   must be equal up to a tie within twice the verify's measured error.
   The distiller's pseudo-labelling shapes are held the same way: a batch
   of 8 clips encoded at 512 positions (cli.distill.encode_at), its int8
   cross-KV, and the teacher-forced logits of the prefill and 4 steps (K4
   at kvp [8, 20, 512, 128], which phase 3 also checks alone).
10. Training and draft distillation at large-v3 full width. (b) The
   distiller CLI (cli.distill.main, --layers 2 --enc_ctx 512 --seq 48
   --batch 4, a pool of 48 synthetic clips, 200 KD steps) on the seed's
   random teacher, which is the serving engine's: the pseudo-labelling
   launches K1-K4, the precompute K1 alone, the KD steps no kernel; the
   KD loss falls (the mean of the last 10 steps below the first 10's), the
   held-out teacher-forced agreement rises, and the written dir loads
   through loader.load_engine with distill_enc_ctx 512. Each stage's time
   and both agreements are printed. (c) That draft in place of the random
   one on phase 6's `all` pool (k = 4, 8 slots, encoder bucket 512), which
   must launch K5 and K5's window form: its acceptance, committed tokens
   per window round (a harvested window's tokens over the verify rounds it
   took part in) and device time per pool verify round (torch.profiler), beside
   phase 6's random-draft figures; no threshold on acceptance. (a) With
   the engines freed, make_train_step from the seed's random tree upcast
   to float32 master weights, bf16 compute: 3 steps (warmup 1) of B = 2
   mel [2,3000,128] from speech-like audio with 48 token rows. The losses
   are finite, the parameters unchanged after step 1 (lr 0) and every leaf
   moved after step 2, K1 never launched (the training encoder's attention
   is plain: K1 has no backward), and K1 called on CUDA inputs that
   require grad raises without launching; a save_checkpoint /
   load_checkpoint round trip is bit-equal (read back on the host), and
   one more step from the saved state and from the state load_checkpoint
   restores onto the card gives the same loss (within 1e-5). The step times,
   torch.cuda.max_memory_allocated and the checkpoint's size and times
   are printed, and all of phase 10 as {"training": ...}.
11. The rest of serving, on the int8 engine before the engines are freed.
   (a) REST through its aiohttp-free core (rest.handle_transcription) on a
   TorchBackend over a continuous pool (phase 5's configuration) and the
   window scheduler: a 35 s speech-like WAV (a 30 s window on the window
   route, K4; the rest on the pool, K5) as verbose_json with word
   timestamps, a 12 s raw f32 upload (one window, on the pool) as
   verbose_json, json, srt, vtt, text and stream=true (one window a
   format, for the script's time limit), and with two known
   speakers enrolled (alice, bob: source-filter voices that the speaker
   embedder tells apart), 35 s WAVs of 30 s of one voice then 5 s of the
   other, in both orders. Each request launches K1-K3 and K4 or K5 by its
   route; the upload's SSE events, json, srt, vtt and text equal its
   verbose_json segments formatted; the 35 s file's words are ordered and in
   their segments; every segment with MIN_AUDIO_S of the file's audio
   inside one voice's part carries that voice's name, and the first seek
   window has one; a wrong key gives 401 and a 2 rpm limit 429
   on the third request. (b) A SMALL100-shaped checkpoint dir (random
   bf16 weights from SEED + 2 at alirezamsh/small100's widths, HF keys,
   the port's safetensors writer, a toy SentencePiece vocabulary that
   spells the visible tokenizer's words), the translator loaded from it on
   the card, then a diarized and a translated (fr) streaming session on
   the continuous backend: every committed segment with MIN_AUDIO_S of
   audio has a speaker, and every translated text equals a fresh
   translation of its source on the card (beam 5, max_new 200); the load
   time, the time and decode steps a segment. (c) The same weights in
   bf16 against float32 on the card: encoder states and teacher-forced
   logits of 4 sources at the 64-token bucket within 5e-2 and 5e-3 of
   max|ref|, free-running greedy tokens over 16 steps equal up to a tie. Printed as
   {"rest_of_serving": ...}.

12. Tensor and data parallelism over two ranks on the one card (rank 0 this
   process, rank 1 spawned with torch.multiprocessing; gloo on the card's
   tensors, since NCCL refuses two ranks on one GPU; the backend printed on
   a line of its own), through the functions the server CLI calls
   (init_multihost, multihost_shardings, WhisperEngine(shardings=...),
   MultihostContinuousEngine over an HMAC-authenticated OpLeader /
   OpFollower with WL_OPS_SECRET set, run_follower). (a) Phase 3 also holds
   K1, K2, K4 and K5 at the shapes a rank of a tp = 2 and a tp = 4 group
   gives them, and K6 at [1,10,5,64] x [1,10,1500,128] and K5's window form
   at [8,10,5,64] x [8,10,640,128] (tp = 2), each with its bound and its
   cold time beside sdpa_bf16 (`sharded_shapes` in their entries). (b) tp = 2 at large-v3,
   32 + 32 layers, 10 heads a rank, int8 decoder and cross-KV, random bf16
   weights from the seed: rank 0 serves phase 5's three sessions through the
   op log (phase 5's pool, no warmup, PAR_MAX_NEW tokens a window), rank 1
   replays it; each rank's kernel
   launches, row-parallel all-reduces (3 a decoder layer) and host time per
   step and per insert, and a torch.profiler window over two chunks on rank
   0 (device busy share, the device-host copies' share, the host time
   inside the reduces). Then the prefill and PAR_STEPS teacher-forced steps
   against the tp = 1 engine of phases 4-11 on the same weights: within
   PAR_REL_TOL of max|ref| at every step, and the greedy tokens equal or
   parting only at a tie (the first divergence and the top-2 margins
   printed). (e) The window route on the op log, on (b)'s engines: each rank
   adds a 2-decoder-layer random draft sliced at tp = 2 (SEED + 1), the
   MultihostWindowEngine with its SpeculativeDecoder, a plain pool and the
   mixed mode's speculative pool, as a one-host `--tp 2` server builds
   them; rank 0 serves, PAR_MAX_NEW tokens a window: (i) two greedy windows
   as one batch and a no_repeat_ngram request routed to the window
   scheduler, (ii) a word-timestamps window, (iii) a PAR_REST_S s raw
   upload through rest.handle_transcription on a window-only backend, (iv)
   a `--beam_mode refresh` beam-5 full re-decode while a continuous
   session runs on the pool, (v) a lone greedy request on the window-path
   SpeculativeDecoder, (vi) a full re-decode on the mixed pool; rank 1
   replays. Tokens against the tp = 1 engine: equal, or parting only at a
   tie (tp = 1's logit gap at the first divergence within twice (b)'s
   largest teacher-forced error; top-2 margins printed). Each rank's
   launches by part (K1-K4 on the window ops, K6 on the speculative
   calls, K5 on the plain pool, K5 and its window form on the mixed
   pool), every window handle freed, the follower's replayed ops equal to
   the leader's published ones; host time a request and the op log's ops
   and bytes printed. (c) dp = 2 at large-v3's width, PAR_DP_LAYERS +
   PAR_DP_LAYERS layers (cut from 32 + 32 for the script's time limit): two
   replicas, 2 x 8 slots, one wave of two windows seated one in each
   replica, tokens equal to a tp = 1 pool's of the same depth. (d) One tp = 2 fine-tune step of phase 10's configuration at
   PAR_TRAIN_LAYERS + PAR_TRAIN_LAYERS layers, full width: the loss within
   PAR_TRAIN_REL_TOL of tp = 1's, no K1 launch. Printed as {"parallel": ...}.

13. The tooling, on the int8 engine of phases 4-12, with windows of
   TOOL_MAX_NEW tokens. (a) The server CLI's main (cli.run_server.main)
   with --profile_dir in a temp dir: its create_backend gives phase 5's pool
   on this engine and its server one TOOL_SESSION_S session through the
   connection handler in-process; the trace the shutdown path writes must
   exist, name K2 and K5 with as many kernel events as launches (K5's
   instantiation also serves the inserts' K4), K5 32 a step, and carry the
   scheduler's insert / step / harvest spans.
   (b) utils.roofline.measure_effective_peaks (budget PEAK_BUDGET_S) at the
   pool's cross-KV shape [8, 20, 640, 64]: the six envelopes, each bandwidth
   at most PEAK_SLACK x the nominal 3.35 TB/s and tflops at most PEAK_SLACK
   x 989; K4 and K2 must have launched. Then phase 5's profiled step
   (device time from torch.profiler) against step_time_roof of
   continuous_step_cost (the pool's rows, its self-KV columns, the cross
   positions K5 reads for its 3 occupied slots) under the nominal and the
   measured peaks: both shares printed, the nominal one at most 1.
   (c) cli.eval_wer.run_eval over a WER_CLIP_S speech-like clip through the
   port's server and client (loopback transport: no websockets here) on
   phase 5's pool: a WER, no threshold. (d) cli.train_vad (gru, silero) and
   cli.train_speaker (mlp, resnet), TOOL_TRAIN_STEPS steps each on the card
   into temp files: finite losses, the saved npz loaded into the port's
   numpy forward equal to the card's forward on a held-out clip within
   TOOL_TRAIN_TOL of max|ref|. Printed as {"tooling": ...}.

14. The published configurations (CONFIGS: small, both server CLIs'
   default; tiny.en, the narrowest and English-only; base; medium;
   large-v3-turbo, 128 mels and a 4-layer decoder), each at full width and
   depth on random bf16 weights from SEED, one int8 engine at a time after
   phase 10 freed the others. For each: K1-K5 at its shapes against their
   plain versions with phase 3's tolerances, timed warm and cold with phase
   3's helpers beside phase 3's library calls (K1 q/k/v [1|4,1500,H,64]; K2
   the d x d, d x 4d and 4d x d linears at M = 1, 4, 8; K3 x [1|8, d]
   against its vocabulary; K4 [4,H,64] x [4,H,1500,128] unmasked and with
   lengths [1500,700,1,0]; K5 [8,H,64] x [8,H,640,128], mixed lengths, half
   active), in each entry's `other_shapes` with the configuration's name.
   Then its engine serves: small's through the server CLI's default start
   (cli.run_server.main with no --model flag, its server driven in-process
   as phase 13 drives it) one DEFAULT_SESSION_S English session, every
   other one CONFIG_SESSION_S on phase 5's pool; each must reach the pool
   (n_text_layer K5 a step) and send segments. The window route's
   transcribe_batch of two speech-like clips, MAX_NEW_TOKENS tokens less
   one: a decode step launches 8 x n_text_layer K2, one K3, n_text_layer
   K4 and nothing else, and an English-only model never runs language
   detection; an encode at mel [4,3000,n_mels] launches n_audio_layer K1
   (host time, median of 5); a continuous step launches n_text_layer K5, 8
   x n_text_layer K2, one K3 and nothing else (host time over two chunks,
   device time from torch.profiler). window_reference and
   continuous_reference hold the engine against the plain path. Printed as
   {"configurations": {name: ...}}; the seconds of every phase as
   {"phase_s": ...}.

The line before the last is {"kernels": [...]}, after {"phase_s": {...}},
{"encoder_forward": [...]}, {"offline": {...}}, {"training": {...}},
{"rest_of_serving": {...}}, {"parallel": {...}}, {"tooling": {...}} and
{"configurations": {...}}; the last line is {"ok": true, "device": {"platform": "gpu", "kind":
..., "count": ...}}.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from whisperlive_tpu_torch.diarization import MIN_AUDIO_S
from whisperlive_tpu_torch.engine.continuous import ContinuousEngine, ContinuousScheduler
from whisperlive_tpu_torch.engine.engine import TranscribeOptions, WhisperEngine
from whisperlive_tpu_torch.engine.scheduler import BatchResult, BatchScheduler
from whisperlive_tpu_torch.engine.speculative import SpeculativeDecoder
from whisperlive_tpu_torch.engine.tokenizer import TokenSpec, WhisperTokenizer
from whisperlive_tpu_torch.models import whisper as wmod
from whisperlive_tpu_torch.ops import _kernels
from whisperlive_tpu_torch.ops import attention as attn_ops
from whisperlive_tpu_torch.ops import decoding as dec
from whisperlive_tpu_torch.ops import mel as mel_ops
from whisperlive_tpu_torch.ops import quant_matmul as qmm
from whisperlive_tpu_torch.serving import backends as backends_mod
from whisperlive_tpu_torch.serving.server import ClientManager, TranscriptionServer
from whisperlive_tpu_torch.serving.session import SessionOptions

MODEL = "large-v3"
SEED = 0
BATCH = 4
# new tokens a window (48 until the script's time limit cut it)
MAX_NEW_TOKENS = 24
# A session streams in real time and closes once a call finishes after its
# end, so the window path's check of two calls per session needs the first
# call (up to ~5 s on a busy host: one 48-token window) done before the
# audio ends: 8 s leaves room where 5 s did not.
WINDOW_SESSION_S = 8.0
# The same holds for the continuous path's late session (2 s shorter),
# whose first call took up to ~6 s on a busy host: 10 s leaves it room.
CONT_SESSION_S = 10.0
CONT_SLOTS = 8
FRAME_S = 0.5
DRAFT_MODEL = "distil-large-v3"
SPEC_K = 4
# A round takes k+2 ring columns however many drafts it accepts: with the
# random draft (acceptance near 0) a window of MAX_NEW_TOKENS tokens takes
# MAX_NEW_TOKENS rounds, so the speculative pools' ring holds that many
# rounds (the JAX mixed pool's 192 columns hold 32)
SPEC_RING = (SPEC_K + 2) * (MAX_NEW_TOKENS + 2)

# H100 SXM peaks (NVIDIA datasheet): HBM bytes/s, dense bf16 FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12

# The cross-attention checks draw q at scale 0.05 against random int8 codes
# (std 73.6). A random nibble's std is 4.6, 1/16 of that, so the int4
# checks draw q 16x larger: the scores then spread as in the int8 checks
# (std ~3.7 after the 1/8 softmax scale), and a wrongly decoded K nibble
# moves which positions dominate the softmax.
Q_SCALE_INT4 = 0.05 * 16

# K4-K8: one source, instantiated for each row codec and Tq
CROSS_SOURCE = "whisperlive_tpu_torch/csrc/cross_attention.cu"
CODECS = ("Int8Packed", "Int4Halves")
KERNELS = {
    "fused_attention": ("whisperlive_tpu_torch/csrc/fused_attention.cu",
                        "whisperlive_tpu/ops/attention.py:583"),
    "int8_matmul": ("whisperlive_tpu_torch/csrc/int8_matmul.cu",
                    "whisperlive_tpu/ops/quant_matmul.py:29"),
    "int8_matmul_t": ("whisperlive_tpu_torch/csrc/int8_matmul_t.cu",
                      "whisperlive_tpu/ops/quant_matmul.py:40"),
    "cross_attention_int8": (CROSS_SOURCE, "whisperlive_tpu/ops/attention.py:158"),
    "cross_attention_int8_skip": (CROSS_SOURCE, "whisperlive_tpu/ops/attention.py:212"),
    "cross_attention_int8_window": (CROSS_SOURCE, "whisperlive_tpu/ops/attention.py:409"),
    "cross_attention_int8_skip_window": (CROSS_SOURCE, "whisperlive_tpu/ops/attention.py:294"),
    "cross_attention_int4": (CROSS_SOURCE, "whisperlive_tpu/ops/attention.py:53"),
    "cross_attention_int4_window": (CROSS_SOURCE, "whisperlive_tpu/ops/attention.py:490"),
}
# the kernels each serving path must launch
WINDOW_PATH = ("fused_attention", "int8_matmul", "int8_matmul_t", "cross_attention_int8")
CONTINUOUS_PATH = ("fused_attention", "int8_matmul", "int8_matmul_t",
                   "cross_attention_int8_skip")
SPEC_WINDOW_PATH = WINDOW_PATH + ("cross_attention_int8_window",)
SPEC_ALL_PATH = CONTINUOUS_PATH + ("cross_attention_int8_skip_window",)
MIXED_INT4_PATH = ("fused_attention", "int8_matmul", "int8_matmul_t", "cross_attention_int4",
                   "cross_attention_int4_window")
INT8_CROSS = ("cross_attention_int8", "cross_attention_int8_skip", "cross_attention_int8_window",
              "cross_attention_int8_skip_window")


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_clock():
    """lap(label) logs and keeps the seconds since the previous lap (the
    first: since phase_clock was called); returns every lap so far."""
    laps, last = {}, [time.monotonic()]

    def lap(label: str) -> dict:
        now = time.monotonic()
        laps[label] = now - last[0]
        last[0] = now
        log(f"{label}: {laps[label]:.6g} s")
        return laps
    return lap


def speech_like(seconds: float, seed: int = 0) -> np.ndarray:
    """Harmonics with syllabic amplitude modulation (passes the VAD gate)."""
    t = np.arange(int(16000 * seconds)) / 16000.0
    rng = np.random.default_rng(seed)
    f0 = 140 + 40 * np.sin(2 * np.pi * 2.1 * t)
    sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
    sig = sig * (0.55 + 0.45 * np.sin(2 * np.pi * 3.7 * t)) + 0.02 * rng.standard_normal(t.shape)
    return (0.12 * sig / np.max(np.abs(sig))).astype(np.float32)


# Two speaker profiles that the speaker embedder tells apart (cosine ~0.07
# between them, ~1.0 within one); speech_like's variants all embed alike.
VOICES = {
    "alice": dict(f0=210.0, formants=((850, 90), (2000, 140), (3000, 220)), tilt=0.8),
    "bob": dict(f0=105.0, formants=((450, 80), (1100, 120), (2400, 200)), tilt=1.4),
}


def voice(seconds: float, seed: int, f0: float, formants, tilt: float) -> np.ndarray:
    """A source-filter voice: 13 harmonics of a gliding f0 falling off as
    1/k**tilt, shaped by formant resonances (centre, width in Hz), with
    syllabic amplitude modulation and a little noise (passes the VAD gate)."""
    n = int(16000 * seconds)
    t = np.arange(n) / 16000.0
    rng = np.random.default_rng(seed)
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.05 * np.sin(2 * np.pi * 2.1 * t))) / 16000.0
    sig = sum(np.sin(k * phase) / k ** tilt for k in range(1, 14))
    freqs = np.fft.rfftfreq(n, 1 / 16000)
    envelope = 0.03 + sum(np.exp(-0.5 * ((freqs - fc) / bw) ** 2) for fc, bw in formants)
    sig = np.fft.irfft(np.fft.rfft(sig) * envelope, n=n)
    sig = sig * (0.65 + 0.35 * np.sin(2 * np.pi * 3.7 * t))
    sig = sig / np.max(np.abs(sig)) + 0.01 * rng.standard_normal(n)
    return (0.12 * sig / np.max(np.abs(sig))).astype(np.float32)


class VisibleTokenizer(WhisperTokenizer):
    """Decodes each text token to a visible word: the repository has no BPE
    vocabulary, and empty text would keep the session from sending segments
    (or word timings: each text token is a word)."""

    def decode(self, tokens):
        return "".join(f" t{int(t)}" for t in tokens if int(t) < self.spec.eot)

    def split_to_word_tokens(self, tokens):
        text = [int(t) for t in tokens if int(t) < self.spec.eot]
        return [f" t{t}" for t in text], [[t] for t in text]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def visible_tokenizer(cfg: wmod.WhisperConfig) -> VisibleTokenizer:
    """VisibleTokenizer of cfg's vocabulary, English-only below 51865 ids
    (the engine's own rule)."""
    return VisibleTokenizer(TokenSpec(cfg.n_vocab, multilingual=cfg.n_vocab >= 51865))


def median_ms(fn, warmup: int = 3, iters: int = 20, reps: int = 10,
              spin_cycles: int = 20_000_000) -> float:
    """Device time of one call: the median over `iters` samples of a run of
    `reps` calls between two CUDA events. Each run is queued behind a
    spin kernel (~10 ms by default) so that the host has enqueued every
    call before the first starts; the events then bound device work only,
    not the Python and launch overhead of a single call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)  # GPU cycles
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def ptxas_summary(nvcc_stderr: str) -> str:
    """The registers, spills and stack lines of `nvcc -Xptxas -v` output."""
    return "; ".join(line.split(":", 1)[-1].strip() for line in nvcc_stderr.splitlines()
                     if "registers" in line or "spill" in line)


def ptxas_stderr(kernel: str) -> str:
    """What `nvcc -Xptxas -v` reports for one kernel source compiled with
    the build's own flags."""
    src = _kernels.CSRC_DIR / f"{kernel}.cu"
    flags = [f for f in _kernels.NVCC_FLAGS if f != "-shared"]
    return subprocess.run([_kernels._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", os.devnull,
                           str(src)], capture_output=True, text=True, check=True).stderr


def ptxas_usage(kernel: str) -> str:
    """ptxas_summary of one kernel source compiled with the build's own flags."""
    return ptxas_summary(ptxas_stderr(kernel))


def ptxas_by_tq(nvcc_stderr: str) -> dict[str, str]:
    """ptxas_summary of each entry function of the cross-attention source,
    keyed "<codec> Tq=<n>" by its instantiation (cross_attention_kernel<
    Codec, n>: the mangled name holds the codec's name, then Li<n>E)."""
    out, key = {}, None
    for line in nvcc_stderr.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = entry.group(1)
            codec = next((c for c in CODECS if c in name), "?")
            tq = re.search(r"Li(\d+)E", name)
            key = f"{codec} Tq={tq.group(1) if tq else '?'}"
            out[key] = []
        elif key and ("registers" in line or "spill" in line):
            out[key].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in sorted(out.items())}


def bound(n_bytes: float, n_flops: float) -> dict:
    """Least time on the card: the larger of bytes over HBM rate and bf16
    operations over the tensor-core peak."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def library_time(name: str, fn, **timing) -> float | None:
    """Time one PyTorch call computing the same function (median_ms with
    `timing`); None where this PyTorch has no CUDA implementation of it."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"{name}: library call unavailable here ({type(e).__name__}: "
            f"{str(e).splitlines()[0][:120]})")
        return None
    return median_ms(fn, **timing)


def compare(name, shape, kernel_fn, ref_fn, rel_tol, rows=None, per_row=False, timing=None):
    """Kernel vs plain version (on `rows` of the output only, when given).
    The tolerance is rel_tol of max|ref|; with per_row, of each batch row's
    own max|ref| (rows of one call differ in scale: a length-1 row copies
    one V row, a long row averages many). Both are timed by median_ms
    (with `timing`'s arguments when given)."""
    out = kernel_fn()
    torch.cuda.synchronize()
    ref = ref_fn()
    check(out.shape == ref.shape and out.dtype == ref.dtype,
          f"{name} {shape}: kernel gave {tuple(out.shape)} {out.dtype}, "
          f"plain {tuple(ref.shape)} {ref.dtype}")
    check(bool(torch.isfinite(out).all()), f"{name} {shape}: non-finite output")
    if rows is not None:
        out, ref = out[rows], ref[rows]
    diff = (out.float() - ref.float()).abs()
    if per_row:
        row_err = diff.flatten(1).amax(1)
        row_tol = rel_tol * ref.float().abs().flatten(1).amax(1)
        err, tol = row_err.max().item(), row_tol.min().item()
        worst = (row_err / row_tol.clamp_min(1e-30)).max().item()
        ok = bool((row_err <= row_tol).all())
        how = (f"per row, {rel_tol:g} x each row's max|ref|; least row tol {tol:.6g}, "
               f"worst err/tol {worst:.6g}")
    else:
        err = diff.max().item()
        scale = ref.float().abs().max().item()
        tol, ok = rel_tol * scale, err <= rel_tol * scale
        how = f"{rel_tol:g} x max|ref|={scale:.6g}"
    ms, plain_ms = median_ms(kernel_fn, **(timing or {})), median_ms(ref_fn, **(timing or {}))
    log(f"{name} {shape}: max_abs_err={err:.6g} tol={tol:.6g} ({how}) kernel_ms={ms:.6g} "
        f"plain_ms={plain_ms:.6g}")
    check(ok, f"{name} {shape}: max_abs_err {err} over the tolerance ({how})")
    return {"shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def k2_shapes(d: int) -> list[tuple[int, int, int]]:
    """(M, K, N) of K2's checks: every decoder linear (q, k, v, o and the
    cross q and o at d x d, fc1 d x 4d, fc2 4d x d) at the window path's
    decode M=B and the continuous pool's M=CONT_SLOTS, then prefill M=B*16."""
    decode = ((d, d), (d, 4 * d), (4 * d, d))
    return ([(BATCH, kk, n) for kk, n in decode] + [(CONT_SLOTS, kk, n) for kk, n in decode]
            + [(BATCH * 16, d, 4 * d)])


def k2_offline_shapes(d: int) -> list[tuple[int, int, int]]:
    """(M, K, N) of the offline path's K2 calls beyond k2_shapes: a seek
    window decodes at M = 1 (every linear) and prefills its first prompt at
    the 16-token bucket (the NT=2 instantiation), --batched's two files at
    M = 32 (NT=4), and a window with the most previous text at the 256-token
    bucket (four 64-row M tiles), each at fc1 and fc2."""
    decode = ((d, d), (d, 4 * d), (4 * d, d))
    return ([(1, kk, n) for kk, n in decode]
            + [(m, kk, n) for m in (16, 32, 256) for kk, n in decode[1:]])


def k2_bound(m: int, kk: int, n: int) -> dict:
    return bound(m * kk * 2 + kk * n + n * 2 + m * n * 2, 2 * m * kk * n)


def k2_phase(randn, int8, d: int) -> list[dict]:
    """K2 against its plain version at k2_shapes and k2_offline_shapes,
    times warm (the same weights call after call, so they sit in the L2).
    bf16 output, f32 sums in another order: 2^-7 of max|ref|."""
    k2 = []
    for m, kk, n in k2_shapes(d) + k2_offline_shapes(d):
        x, w8, s = randn(m, kk), int8(kk, n), randn(n, scale=0.01).abs()
        r = compare(
            "int8_matmul", f"x [{m},{kk}] w8 [{kk},{n}]",
            lambda x=x, w8=w8, s=s: qmm.int8_matmul(x, w8, s),
            lambda x=x, w8=w8, s=s: qmm.int8_matmul_ref(x, w8, s), 2.0**-7)
        w8_nk = w8.t().contiguous()  # the library call's [N, K] layout, made once
        r["library_ms"] = library_time(
            "_weight_int8pack_mm", lambda x=x, w=w8_nk, s=s: torch._weight_int8pack_mm(x, w, s))
        r.update(k2_bound(m, kk, n))
        log(f"int8_matmul [{m},{kk}]x[{kk},{n}]: library (_weight_int8pack_mm) "
            f"{r['library_ms']} ms, bound {r['bound_ms']:.6g} ms ({r['bound_by']})")
        k2.append(r)
    return k2


# Cold-weight timings rotate over distinct weight copies that together
# exceed the H100's 50 MB L2, as a decode step finds them
COLD_BYTES = 64 << 20


def rotating(fns):
    """One call of each of `fns` in turn, a call per invocation."""
    state = {"i": 0}

    def call():
        fn = fns[state["i"] % len(fns)]
        state["i"] += 1
        return fn()
    return call


def k2_cold_phase(randn, int8, d: int) -> list[dict]:
    """K2 with cold weights at each decode shape (M=B and M=CONT_SLOTS) and
    at prefill x [B*16, d] x [d, 4d]: a run calls K2 once on each of
    ceil(64 MiB / weight bytes) distinct copies. Beside it, over the same
    rotation, torch._weight_int8pack_mm (K2's function; its [N, K] copies)
    and, as `bf16_gemm_ms`, torch.matmul of x with the weights dequantized
    to bf16 beforehand (twice the bytes; not K2's function, the port never
    calls it)."""
    out = []
    for m, kk, n in k2_shapes(d):
        copies = -(-COLD_BYTES // (kk * n))
        x, s = randn(m, kk), randn(n, scale=0.01).abs()
        w8s = [int8(kk, n) for _ in range(copies)]
        ms = median_ms(rotating([lambda w=w: qmm.int8_matmul(x, w, s) for w in w8s]),
                       iters=10, reps=copies)
        packed = [w.t().contiguous() for w in w8s]
        lib = library_time("_weight_int8pack_mm", rotating(
            [lambda w=w: torch._weight_int8pack_mm(x, w, s) for w in packed]), iters=10,
            reps=copies)
        del packed
        wbf = [w.to(torch.bfloat16) for w in w8s]
        gemm = median_ms(rotating([lambda w=w: torch.matmul(x, w) for w in wbf]), iters=10,
                         reps=copies)
        del wbf, w8s
        r = {"shape": f"x [{m},{kk}] w8 [{kk},{n}]", "copies": copies, "ms": ms,
             "library_ms": lib, "bf16_gemm_ms": gemm, **k2_bound(m, kk, n)}
        r["bound_share"] = r["bound_ms"] / ms
        log(f"int8_matmul cold {r['shape']} ({copies} weight copies): {ms:.6g} ms, bound "
            f"{r['bound_ms']:.6g} ms ({r['bound_by']}), bound share {r['bound_share']:.6g}, "
            f"_weight_int8pack_mm {lib} ms, bf16_gemm {gemm:.6g} ms")
        out.append(r)
    torch.cuda.empty_cache()
    return out


def step_sweep_calls(randn, int8, cfg) -> list[tuple]:
    """(x, w8, s) of the K2 calls of one decode step at the continuous
    pool's M, in layer order over n_text_layer layers of distinct weights:
    per layer the self-attention q, k, v, o, the cross-attention q and o
    (d x d), fc1 (d x 4d) and fc2 (4d x d); the cross k and v are projected
    once per window, not per step."""
    d = cfg.n_text_state
    shapes = [(d, d)] * 6 + [(d, 4 * d), (4 * d, d)]
    xs = {kk: randn(CONT_SLOTS, kk) for kk in (d, 4 * d)}
    return [(xs[kk], int8(kk, n), randn(n, scale=0.01).abs())
            for _ in range(cfg.n_text_layer) for kk, n in shapes]


def k2_step_sweep(randn, int8, cfg) -> dict:
    """The K2 launches of one decode step (step_sweep_calls): device time
    per step (median of 10 runs, each queued behind a ~30 ms spin) against
    the step's byte bound, and the same products as torch.matmul on the
    weights dequantized to bf16 (`bf16_gemm_ms`, twice the bytes; the port
    never calls it)."""
    m = CONT_SLOTS
    calls = step_sweep_calls(randn, int8, cfg)
    n_calls = len(calls)
    w_bytes = sum(w.numel() for _, w, _ in calls)
    n_bytes = sum(m * w.shape[0] * 2 + w.numel() + w.shape[1] * (2 + m * 2) for _, w, _ in calls)
    n_flops = sum(2 * m * w.numel() for _, w, _ in calls)

    def step():
        for x, w, s in calls:
            qmm.int8_matmul(x, w, s)
    ms = median_ms(step, warmup=2, iters=10, reps=1, spin_cycles=60_000_000)
    wbf = [(x, w.to(torch.bfloat16)) for x, w, _ in calls]
    del calls

    def step_bf16():
        for x, w in wbf:
            torch.matmul(x, w)
    gemm = median_ms(step_bf16, warmup=2, iters=10, reps=1, spin_cycles=60_000_000)
    del wbf
    torch.cuda.empty_cache()
    r = {"calls": n_calls, "m": m, "weight_bytes": w_bytes, "ms": ms,
         "bf16_gemm_ms": gemm, **bound(n_bytes, n_flops)}
    r["bound_share"] = r["bound_ms"] / ms
    log(f"int8_matmul step sweep: {r['calls']} calls at M={m} over {w_bytes / 1e6:.6g} MB of "
        f"int8 weights: {ms * 1e3:.6g} us per step, bound {r['bound_ms'] * 1e3:.6g} us "
        f"({r['bound_by']}), bound share {r['bound_share']:.6g}, bf16_gemm "
        f"{gemm * 1e3:.6g} us")
    return r


# K3's M: one row, the window batch, the continuous pool, the window path
# at B = 16, and the 8-slot pool's verify window of k + 1 tokens a slot
K3_ROWS = (1, BATCH, CONT_SLOTS, 16, CONT_SLOTS * (SPEC_K + 1))


def k3_bound(m: int, d: int, v: int) -> dict:
    return bound(m * d * 2 + v * d + v * 2 + m * v * 4, 2 * m * d * v)


def k3_phase(randn, int8, cfg) -> dict:
    """K3, the tied-embedding logits x [M, d] @ w8 [V, d]^T * s at each of
    K3_ROWS: held against its plain version (f32 output over exact
    products: 1e-5 of max|ref|) and timed warm (the same embedding call
    after call) beside torch._weight_int8pack_mm (the same function on the
    same [N, K] layout), then cold: a run calls it 10 times on each of
    ceil(64 MiB / weight bytes) distinct embedding copies in turn, beside
    the library call and, as `bf16_gemm_ms`, torch.matmul of x with the
    embedding dequantized to bf16 beforehand (twice the bytes; the port
    never calls it) over the same rotation. The entry reports M =
    CONT_SLOTS (the continuous pool, the main path's shape)."""
    d, v = cfg.n_text_state, cfg.n_vocab
    copies = -(-COLD_BYTES // (v * d))
    w8s, s = [int8(v, d) for _ in range(copies)], randn(v, scale=0.01).abs()
    wbf = [w.to(torch.bfloat16) for w in w8s]
    cold_timing = {"iters": 10, "reps": 10 * copies}
    warm, cold = [], []
    for m in K3_ROWS:
        x = randn(m, d)
        shape = f"x [{m},{d}] w8 [{v},{d}]"
        r = compare("int8_matmul_t", shape, lambda x=x: qmm.int8_matmul_t(x, w8s[0], s),
                    lambda x=x: qmm.int8_matmul_t_ref(x, w8s[0], s), 1e-5)
        r["library_ms"] = library_time(
            "_weight_int8pack_mm", lambda x=x: torch._weight_int8pack_mm(x, w8s[0], s))
        r.update(k3_bound(m, d, v))
        warm.append(r)
        ms = median_ms(rotating([lambda w=w, x=x: qmm.int8_matmul_t(x, w, s) for w in w8s]),
                       **cold_timing)
        lib = library_time("_weight_int8pack_mm", rotating(
            [lambda w=w, x=x: torch._weight_int8pack_mm(x, w, s) for w in w8s]), **cold_timing)
        gemm = median_ms(rotating([lambda w=w, x=x: torch.matmul(x, w.t()) for w in wbf]),
                         **cold_timing)
        c = {"shape": shape, "copies": copies, "ms": ms, "library_ms": lib,
             "bf16_gemm_ms": gemm, **k3_bound(m, d, v)}
        c["bound_share"] = c["bound_ms"] / ms
        cold.append(c)
        log(f"int8_matmul_t {shape}: warm {r['ms'] * 1e3:.6g} us, cold ({copies} embedding "
            f"copies) {ms * 1e3:.6g} us, bound {c['bound_ms'] * 1e3:.6g} us ({c['bound_by']}), "
            f"cold bound share {c['bound_share']:.6g}; _weight_int8pack_mm warm "
            f"{r['library_ms']} ms, cold {lib} ms; bf16_gemm cold {gemm * 1e3:.6g} us")
    del w8s, wbf
    torch.cuda.empty_cache()
    main = K3_ROWS.index(CONT_SLOTS)
    return dict(warm[main], max_abs_err=max(r["max_abs_err"] for r in warm),
                other_shapes=warm[:main] + warm[main + 1:], cold=cold)


def random_makers(dev: torch.device, seed: int):
    """randn(*shape, scale) -> bf16 and int8(*shape) -> codes in [-127, 127],
    drawn on the card from one generator seeded with `seed`."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
    return randn, int8


# K5's content cap at large-v3 (the continuous pool's cross cap)
K5_T = 640


def cross_int8_work(h: int, hd: int, used: list[int], n_rows: int, masked: bool):
    """(bytes, operations) of one K4/K5 call: the K|V rows each computed
    batch row reads (`used` positions each), its bf16 q and f32 output, and
    the [B] int32 lengths and bool active flags when given (`n_rows`)."""
    n_bytes = sum(h * (n * 2 * hd + hd * 2 + hd * 4) for n in used)
    return n_bytes + (5 * n_rows if masked else 0), sum(4 * h * n * hd for n in used)


def int8_kv_bf16(kvp):
    """Packed int8 K|V [..., 128] -> K and V [..., 64] in bf16."""
    hd = kvp.shape[-1] // 2
    return kvp[..., :hd].to(torch.bfloat16), kvp[..., hd:].to(torch.bfloat16)


def int4_kv_bf16(k4, v4):
    """int4 K and V [..., 32] -> [..., 64] in bf16."""
    return (attn_ops.unpack_int4(k4).to(torch.bfloat16),
            attn_ops.unpack_int4(v4).to(torch.bfloat16))


def cold_ms(call, sets: list[tuple], spin_cycles: int = 20_000_000) -> float:
    """Device time of `call(*s)` over the K/V sets `sets` in turn (median_ms
    of 10 runs, each one call on every set)."""
    return median_ms(rotating([lambda s=s: call(*s) for s in sets]), iters=10, reps=len(sets),
                     spin_cycles=spin_cycles)


def int8_beside(label: str, call, shape: tuple, n_bytes: int, int8) -> float:
    """The int8 kernel's cold time (`call(kvp)`) at an int4 case's [B,H,T]:
    ceil(COLD_BYTES / n_bytes) random int8 K|V copies of `shape`, n_bytes
    of them read a call."""
    sets = [(int8(*shape),) for _ in range(-(-COLD_BYTES // n_bytes))]
    ms = cold_ms(call, sets)
    del sets
    torch.cuda.empty_cache()
    log(f"cold {label}: int8 kernel at the same [B,H,T], Tq and lengths {ms * 1e3:.6g} us")
    return ms


def cross_cold(label: str, call, kv: tuple, q, rows, work: tuple, to_bf16,
               spin_cycles: int = 20_000_000) -> dict:
    """`call(*kv)` with cold K/V: a run calls it once on each of
    ceil(COLD_BYTES / n_bytes) distinct copies of the K/V tensors `kv`
    (n_bytes: what one call reads), as a decode step or a verify round
    finds each layer's cross-KV behind the other layers' weights (`work`:
    its bytes and operations). Beside it, over as many copies dequantized
    to bf16 beforehand (`to_bf16(*kv)` -> K, V), `sdpa_bf16_ms`:
    scaled_dot_product_attention of q's queries (Tq = 1 for a [B, H, 64]
    q, else q's window) on the computed `rows` over all T positions (more
    bytes and not the function; the port never calls it)."""
    copies = -(-COLD_BYTES // work[0])
    sets = [kv] + [tuple(t.clone() for t in kv) for _ in range(copies - 1)]
    ms = cold_ms(call, sets, spin_cycles)
    qs = q[rows] if q.dim() == 4 else q[rows].unsqueeze(2)
    kv_bf16 = [to_bf16(*(t[rows] for t in s)) for s in sets]
    del sets
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_ms = median_ms(rotating([lambda k=k, v=v: sdpa(qs, k, v) for k, v in kv_bf16]),
                        iters=10, reps=copies, spin_cycles=spin_cycles)
    del kv_bf16
    torch.cuda.empty_cache()
    r = {"shape": label, "copies": copies, "ms": ms, "sdpa_bf16_ms": sdpa_ms, **bound(*work)}
    r["bound_share"] = r["bound_ms"] / ms
    log(f"cold {label} ({copies} K/V copies): {ms * 1e3:.6g} us, bound "
        f"{r['bound_ms'] * 1e3:.6g} us ({r['bound_by']}), bound share "
        f"{r['bound_share']:.6g}, sdpa_bf16 {sdpa_ms * 1e3:.6g} us")
    return r


def k4_phase(randn, int8, dev, h: int, hd: int, t_enc: int) -> dict:
    """K4, the window path's decode cross-attention, at q [B,H,64] x kvp
    [B,H,T,128] for the window path's batch buckets B = 1, 2, 4 over the
    full context, and at B = 4 with lengths [T, 700, 1, 0]; the beam
    routes' B*K = 10 rows: the window route's over the full context, the
    2 x 5-lane pool's over its 640 positions with the slots' lengths 512
    and 640 (the pool passes no active rows); the distiller's
    pseudo-labelling, B = 8 over its DISTILL_CTX encoder positions; each
    timed warm
    (the same K/V call after call) and cold (cross_cold). f32 output;
    a probability that rounds to the other bf16 neighbour moves the output
    by ~2^-9 of it: 1e-3 of each row's max|ref|. The entry reports B = 4
    unmasked (its launches come from the window path at B <= 4)."""
    warm, cold = [], []
    bk = BEAM_BATCH * BEAM
    for b, t, lens in ((1, t_enc, None), (2, t_enc, None), (BATCH, t_enc, None),
                       (BATCH, t_enc, [t_enc, 700, 1, 0]), (bk, t_enc, None),
                       (bk, K5_T, [512] * BEAM + [K5_T] * BEAM),
                       (DISTILL_BATCH, DISTILL_CTX, None)):
        q, kvp = randn(b, h, hd, scale=0.05), int8(b, h, t, 2 * hd)
        ln = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
        label = (f"q [{b},{h},{hd}] kvp [{b},{h},{t},{2 * hd}]"
                 + ("" if lens is None else f" lengths {lens}"))
        r = compare("cross_attention_int8", label,
                    lambda q=q, kvp=kvp, ln=ln: attn_ops.cross_attention_int8(q, kvp, ln),
                    lambda q=q, kvp=kvp, ln=ln: attn_ops.cross_attention_int8_ref(q, kvp, ln),
                    1e-3, per_row=True)
        used = [t] * b if lens is None else [min(n, t) or t for n in lens]
        work = cross_int8_work(h, hd, used, b, lens is not None)
        r.update(bound(*work))
        warm.append(r)
        cold.append(cross_cold(
            "cross_attention_int8 " + label,
            lambda k, q=q, ln=ln: attn_ops.cross_attention_int8(q, k, ln), (kvp,), q,
            slice(None), work, int8_kv_bf16))
    log("cross_attention_int8 warm / cold (us): " + ", ".join(
        f"{w['shape']} {w['ms'] * 1e3:.6g} / {c['ms'] * 1e3:.6g}" for w, c in zip(warm, cold)))
    return dict(warm[2], max_abs_err=max(r["max_abs_err"] for r in warm), library_ms=None,
                other_shapes=[warm[0], warm[1], *warm[3:]], cold=cold)


def k5_phase(randn, int8, dev, h: int, hd: int) -> dict:
    """K5, the continuous step's cross-attention, at the smoke pool's q
    [8,H,64] x kvp [8,H,640,128]: mixed lengths all and half active, a lone
    active row of length 0, lengths on and one past the chunk boundaries of
    a split over T in 2 or 4 (T/2 = 320, T/4 = 160) and of rows split small
    (2, 3), and 8/8, 4/8 and 1/8 rows active at length 640, each warm and,
    at the three occupancies, cold. Tolerance as K4's family on the card:
    2^-6 of each active row's max|ref|. The entry reports 8/8 active."""
    b5, t5 = CONT_SLOTS, K5_T
    q, kvp = randn(b5, h, hd, scale=0.05), int8(b5, h, t5, 2 * hd)
    cold = []

    def k5_case(label, lens, act, time_cold=False):
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        ac = torch.tensor(act, device=dev)
        label = f"q [{b5},{h},{hd}] kvp [{b5},{h},{t5},{2 * hd}] {label}"
        r = compare(
            "cross_attention_int8_skip", label,
            lambda: attn_ops.cross_attention_int8_skip(q, kvp, ln, ac),
            lambda: attn_ops.cross_attention_int8_skip_ref(q, kvp, ln, ac), 2.0**-6, rows=ac,
            per_row=True)
        out = attn_ops.cross_attention_int8_skip(q, kvp, ln, ac)
        check(not out[~ac].any(), f"cross_attention_int8_skip {label}: inactive rows must be zero")
        used = [min(n, t5) or t5 for n, a in zip(lens, act) if a]
        work = cross_int8_work(h, hd, used, b5, True)
        r.update(bound(*work))
        log(f"cross_attention_int8_skip {label}: bound {r['bound_ms']:.6g} ms ({r['bound_by']})")
        if time_cold:
            cold.append(cross_cold(
                "cross_attention_int8_skip " + label,
                lambda k: attn_ops.cross_attention_int8_skip(q, k, ln, ac), (kvp,), q, ac, work,
                int8_kv_bf16))
        return r

    mixed = [640, 300, 1, 640, 512, 17, 640, 100]
    k5 = [k5_case("all active, lengths mixed", mixed, [True] * b5),
          k5_case("half active", mixed, [i % 2 == 0 for i in range(b5)]),
          k5_case("one active row, len 0", [0] + mixed[1:], [True] + [False] * (b5 - 1)),
          k5_case("lengths on and past chunk boundaries", [320, 321, 160, 161, 2, 3, 319, 640],
                  [True] * b5)]
    occupancy = {n_act: k5_case(f"{n_act}/{b5} active, len {t5}", [t5] * b5,
                                [i < n_act for i in range(b5)], time_cold=True)
                 for n_act in (8, 4, 1)}
    log("cross_attention_int8_skip occupancy warm / cold (us): " + ", ".join(
        f"{n}/{b5} active {r['ms'] * 1e3:.6g} / {c['ms'] * 1e3:.6g} (bound "
        f"{r['bound_ms'] * 1e3:.6g})" for (n, r), c in zip(occupancy.items(), cold)))
    return dict(occupancy[8], max_abs_err=max(r["max_abs_err"] for r in k5 + list(
        occupancy.values())), library_ms=None, other_shapes=k5 + [occupancy[4], occupancy[1]],
                cold=cold)


def kernel_phase(dev: torch.device) -> dict:
    cfg = wmod.WHISPER_CONFIGS[MODEL]
    h, hd, t_enc, d = cfg.n_audio_head, cfg.head_dim, cfg.n_audio_ctx, cfg.n_text_state
    sdpa = torch.nn.functional.scaled_dot_product_attention
    randn, int8 = random_makers(dev, SEED)
    results = {}
    # K1: encoder self-attention, bf16 output; flash (unnormalised bf16
    # probabilities) vs two-pass softmax round differently: 2^-6 of max|ref|.
    # T = 1500 on the window path, 512 on the continuous path's short tails;
    # then T = 1500 with q drawn 4x larger, a peaked softmax in which a
    # wrong rescale of the running max shows.
    k1 = []
    for b, t, q_scale in ((BATCH, t_enc, 1.0), (8, 512, 1.0), (BATCH, t_enc, 4.0)):
        q, k, v = randn(b, t, h, hd, scale=q_scale), randn(b, t, h, hd), randn(b, t, h, hd)
        shape = f"q/k/v [{b},{t},{h},{hd}]" + (f", q x{q_scale:g}" if q_scale != 1.0 else "")
        r = compare(
            "fused_attention", shape,
            lambda: attn_ops.fused_attention(q, k, v),
            lambda: attn_ops.fused_attention_ref(q, k, v), 2.0**-6)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # [B, H, T, hd]
        r["library_ms"] = library_time("sdpa", lambda: sdpa(qh, kh, vh))
        n_flops = 4 * b * h * t * t * hd
        r.update(bound(4 * b * t * h * hd * 2, n_flops))
        r["sdpa_ratio"] = r["ms"] / r["library_ms"] if r["library_ms"] else None
        log(f"fused_attention {shape}: {n_flops / r['ms'] * 1e-9:.6g} TFLOP/s, "
            f"bound share {r['bound_ms'] / r['ms']:.6g}, library (sdpa) {r['library_ms']} ms, "
            f"kernel/sdpa {r['sdpa_ratio']}, bound {r['bound_ms']:.6g} ms ({r['bound_by']})")
        k1.append(r)
    # the entry reports the window path's shape and the worst error; the
    # insert's shape and the peaked case ride along in other_shapes
    results["fused_attention"] = dict(
        k1[0], max_abs_err=max(r["max_abs_err"] for r in k1), other_shapes=k1[1:])

    k2 = k2_phase(randn, int8, d)
    # the entry reports the continuous pool's decode fc1 shape (the main
    # path's) and the worst error over every shape, the offline path's
    # shapes in offline_shapes
    results["int8_matmul"] = dict(k2[4], max_abs_err=max(r["max_abs_err"] for r in k2),
                                  offline_shapes=k2[len(k2_shapes(d)):],
                                  cold=k2_cold_phase(randn, int8, d), step_sweep=k2_step_sweep(
                                      randn, int8, cfg))

    results["int8_matmul_t"] = k3_phase(randn, int8, cfg)

    results["cross_attention_int8"] = k4_phase(randn, int8, dev, h, hd, t_enc)
    results["cross_attention_int8_skip"] = k5_phase(randn, int8, dev, h, hd)
    results.update(window_kernel_phase(randn, int8, dev, h, hd, t_enc))
    for name, cases in sharded_kernel_phase(randn, int8, dev, cfg).items():
        results[name]["sharded_shapes"] = cases
        results[name]["max_abs_err"] = max([results[name]["max_abs_err"]]
                                           + [c["max_abs_err"] for c in cases])
    return results


# the tensor-parallel degrees whose per-rank shapes phase 3 checks
SHARDED_TPS = (2, 4)


# median_ms's arguments for the warm timings of the case helpers below
# (phase 3's defaults: 20 runs, each behind a ~10 ms spin; the cold ones run
# 10 behind the same spin)
PHASE3_TIMING = {"iters": 20, "spin_cycles": 20_000_000}
# spin cycles a queued launch of a rotating run needs (~75 us at 1.98 GHz;
# the host queues one such call in ~10-40 us)
SPIN_PER_LAUNCH = 150_000


def k1_case(randn, b: int, t: int, h: int, hd: int, tag: str, timing=PHASE3_TIMING) -> dict:
    """K1 at q/k/v [b, t, h, hd] against its plain version (2^-6 of max|ref|),
    timed warm beside sdpa, with its bound; `tag` ends the shape's label."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (randn(b, t, h, hd) for _ in range(3))
    r = compare("fused_attention", f"q/k/v [{b},{t},{h},{hd}]{tag}",
                lambda: attn_ops.fused_attention(q, k, v),
                lambda: attn_ops.fused_attention_ref(q, k, v), 2.0**-6, timing=timing)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    r["library_ms"] = library_time("sdpa", lambda: sdpa(qh, kh, vh), **timing)
    r.update(bound(4 * b * t * h * hd * 2, 4 * b * h * t * t * hd))
    return r


def k2_case(randn, int8, m: int, kk: int, n: int, tag: str, timing=PHASE3_TIMING) -> dict:
    """K2 at x [m, kk] w8 [kk, n] against its plain version (2^-7 of
    max|ref|), timed warm beside _weight_int8pack_mm and cold (`cold_ms`:
    ceil(64 MiB / weight bytes) weight copies in turn), with its bound."""
    x, w8, sc = randn(m, kk), int8(kk, n), randn(n, scale=0.01).abs()
    r = compare("int8_matmul", f"x [{m},{kk}] w8 [{kk},{n}]{tag}",
                lambda: qmm.int8_matmul(x, w8, sc), lambda: qmm.int8_matmul_ref(x, w8, sc),
                2.0**-7, timing=timing)
    w8_nk = w8.t().contiguous()
    r["library_ms"] = library_time("_weight_int8pack_mm",
                                   lambda: torch._weight_int8pack_mm(x, w8_nk, sc), **timing)
    r.update(k2_bound(m, kk, n))
    copies = -(-COLD_BYTES // (kk * n))
    w8s = [w8] + [int8(kk, n) for _ in range(copies - 1)]
    # a narrow width's weights take hundreds of copies: the spin must outlast
    # queueing them all, or the run times the host's launches
    r["cold_ms"] = median_ms(rotating([lambda w=w: qmm.int8_matmul(x, w, sc) for w in w8s]),
                             iters=10, reps=copies,
                             spin_cycles=max(timing["spin_cycles"], copies * SPIN_PER_LAUNCH))
    del w8s
    log(f"int8_matmul{tag} [{m},{kk}]x[{kk},{n}]: cold {r['cold_ms']:.6g} ms ({copies} copies), "
        f"bound {r['bound_ms']:.6g} ms ({r['bound_by']}), _weight_int8pack_mm "
        f"{r['library_ms']} ms")
    return r


def k4_case(randn, int8, dev, b: int, h: int, hd: int, t: int, lens, tag: str,
            timing=PHASE3_TIMING) -> dict:
    """K4 at q [b, h, hd] x kvp [b, h, t, 2 hd] (with `lens` when given)
    against its plain version (1e-3 of each row's max|ref|), timed warm and
    cold (cross_cold, beside sdpa_bf16), with its bound."""
    q, kvp = randn(b, h, hd, scale=0.05), int8(b, h, t, 2 * hd)
    ln = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
    label = (f"q [{b},{h},{hd}] kvp [{b},{h},{t},{2 * hd}]"
             + ("" if lens is None else f" lengths {lens}") + tag)
    r = compare("cross_attention_int8", label,
                lambda: attn_ops.cross_attention_int8(q, kvp, ln),
                lambda: attn_ops.cross_attention_int8_ref(q, kvp, ln), 1e-3, per_row=True,
                timing=timing)
    used = [t] * b if lens is None else [min(n, t) or t for n in lens]
    work = cross_int8_work(h, hd, used, b, lens is not None)
    r.update(bound(*work), library_ms=None)
    r["cold"] = cross_cold("cross_attention_int8 " + label,
                           lambda kv: attn_ops.cross_attention_int8(q, kv, ln), (kvp,), q,
                           slice(None), work, int8_kv_bf16, timing["spin_cycles"])
    return r


def k5_case(randn, int8, dev, h: int, hd: int, lens, act, tag: str,
            timing=PHASE3_TIMING) -> dict:
    """K5 at the pool's q [8, h, hd] x kvp [8, h, K5_T, 2 hd] with `lens` and
    the `act` rows active, against its plain version on the active rows
    (2^-6 of each row's max|ref|; the inactive rows must be zero), timed warm
    and cold (cross_cold, beside sdpa_bf16), with its bound."""
    b5 = len(lens)
    q, kvp = randn(b5, h, hd, scale=0.05), int8(b5, h, K5_T, 2 * hd)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    ac = torch.tensor(act, device=dev)
    n_act = sum(act)
    label = (f"q [{b5},{h},{hd}] kvp [{b5},{h},{K5_T},{2 * hd}] "
             + (f"{n_act}/{b5} active" if len(set(lens)) == 1 else
                f"lengths mixed, {n_act}/{b5} active") + tag)
    r = compare("cross_attention_int8_skip", label,
                lambda: attn_ops.cross_attention_int8_skip(q, kvp, ln, ac),
                lambda: attn_ops.cross_attention_int8_skip_ref(q, kvp, ln, ac), 2.0**-6,
                rows=ac, per_row=True, timing=timing)
    check(not attn_ops.cross_attention_int8_skip(q, kvp, ln, ac)[~ac].any(),
          f"cross_attention_int8_skip {label}: inactive rows must be zero")
    work = cross_int8_work(h, hd, [min(n, K5_T) or K5_T for n, a in zip(lens, act) if a], b5,
                           True)
    r.update(bound(*work), library_ms=None)
    r["cold"] = cross_cold("cross_attention_int8_skip " + label,
                           lambda kv: attn_ops.cross_attention_int8_skip(q, kv, ln, ac), (kvp,),
                           q, ac, work, int8_kv_bf16, timing["spin_cycles"])
    return r


def sharded_kernel_phase(randn, int8, dev, cfg) -> dict:
    """K1, K2, K4 and K5 at the shapes one rank of a tp = 2 and a tp = 4
    group gives them at large-v3 (phase 12 runs tp = 2): K1 at q/k/v
    [B, 1500, H/tp, 64]; K2 at the pool's M = CONT_SLOTS over every
    decoder linear's slice (q/k/v and the cross q [d, d/tp], o [d/tp, d],
    fc1 [d, 4d/tp], fc2 [4d/tp, d]), warm and cold; K4 at the window
    batch's [B, H/tp, 1500, 128] and K5 at the pool's [8, H/tp, 640, 128]
    with all rows and half of them active, warm and cold. The same
    tolerances, bounds and library calls as their main entries; K3 is
    unchanged (the logits are whole on every rank)."""
    h, hd, t_enc, d = cfg.n_audio_head, cfg.head_dim, cfg.n_audio_ctx, cfg.n_text_state
    out = {"fused_attention": [], "int8_matmul": [], "cross_attention_int8": [],
           "cross_attention_int8_skip": []}
    k2_done = set()
    for tp in SHARDED_TPS:
        hl, tag = h // tp, f" (tp={tp})"
        out["fused_attention"].append(k1_case(randn, BATCH, t_enc, hl, hd, tag))
        for kk, n in ((d, d // tp), (d // tp, d), (d, 4 * d // tp), (4 * d // tp, d)):
            if (kk, n) not in k2_done:
                k2_done.add((kk, n))
                out["int8_matmul"].append(k2_case(randn, int8, CONT_SLOTS, kk, n, tag))
        out["cross_attention_int8"].append(
            k4_case(randn, int8, dev, BATCH, hl, hd, t_enc, None, tag))
        b5 = CONT_SLOTS
        for n_act in (b5, b5 // 2):
            out["cross_attention_int8_skip"].append(k5_case(
                randn, int8, dev, hl, hd, [K5_T] * b5, [i < n_act for i in range(b5)], tag))
        if tp == PAR_TP:
            out.setdefault("cross_attention_int8_window", []).append(
                sharded_window_case(randn, int8, dev, 1, hl, hd, t_enc, tp))
            out.setdefault("cross_attention_int8_skip_window", []).append(
                sharded_window_case(randn, int8, dev, b5, hl, hd, K5_T, tp))
    torch.cuda.empty_cache()
    return out


def sharded_window_case(randn, int8, dev, b: int, hl: int, hd: int, t: int, tp: int) -> dict:
    """A verify window (SPEC_K + 1 queries) at a rank's heads: K6 (b = 1,
    the window route's full context) or K5's window form (b rows of the
    pool, every row active), held and timed as their main entries, with
    the bound and sdpa_bf16 beside the cold time."""
    tq = SPEC_K + 1
    name = "cross_attention_int8_window" if b == 1 else "cross_attention_int8_skip_window"
    q, kvp = randn(b, hl, tq, hd, scale=0.05), int8(b, hl, t, 2 * hd)
    ln = torch.full((b,), t, dtype=torch.int32, device=dev)
    ac = torch.ones((b,), dtype=torch.bool, device=dev)
    if b == 1:
        def call(kv):
            return attn_ops.cross_attention_int8_window(q, kv, None)

        def ref():
            return attn_ops.cross_attention_int8_window_ref(q, kvp, None)
    else:
        def call(kv):
            return attn_ops.cross_attention_int8_window(q, kv, ln, ac)

        def ref():
            return attn_ops.cross_attention_int8_skip_window_ref(q, kvp, ln, ac)
    label = f"q [{b},{hl},{tq},{hd}] kvp [{b},{hl},{t},{2 * hd}] (tp={tp})"
    r = compare(name, label, lambda: call(kvp), ref, 2.0**-6, per_row=True)
    # K/V of each row read once, the bf16 queries and f32 outputs
    work = (b * hl * (t * 2 * hd + tq * hd * (2 + 4)), 4 * b * hl * tq * t * hd)
    r.update(bound(*work), library_ms=None)
    r["cold"] = cross_cold(f"{name} {label}", call, (kvp,), q, slice(None), work, int8_kv_bf16)
    return r


def window_kernel_phase(randn, int8, dev, h: int, hd: int, t_enc: int) -> dict:
    """K6, K5's window form, K7 and K8 at the speculative routes' shapes (a
    verify window of SPEC_K + 1 queries; K6 and K5's window form also at
    Tq = 8, the most), each held against its plain version and timed warm
    (the same K/V call after call) and cold (cross_cold, beside sdpa at the
    same Tq). Tolerance as K4's family on the card: 2^-6 of each active
    row's max|ref| (a probability may round to the other bf16 neighbour;
    sums run in another order). No single PyTorch call attends over int8
    or int4 codes: library_ms is null."""
    results = {}
    tq = SPEC_K + 1
    b5, t5 = CONT_SLOTS, K5_T
    mixed = [640, 300, 1, 640, 512, 17, 640, 100]

    def row_bytes(t, tq_, kv_bytes_per_pos):
        # K/V of one (b, h) row read once, the bf16 queries and f32 outputs
        return h * (t * kv_bytes_per_pos + tq_ * hd * (2 + 4))

    def work(used, tq_, kv_bytes_per_pos, extra=0):
        """(bytes, operations) of one call over rows of `used` positions."""
        return (sum(row_bytes(n, tq_, kv_bytes_per_pos) for n in used) + extra,
                sum(4 * h * tq_ * n * hd for n in used))

    def summary(name, warm, cold):
        log(f"{name} warm / cold (us): " + ", ".join(
            f"{w['shape']} {w['ms'] * 1e3:.6g} / {c['ms'] * 1e3:.6g} (bound "
            f"{c['bound_ms'] * 1e3:.6g}, sdpa_bf16 {c['sdpa_bf16_ms'] * 1e3:.6g}"
            + (f", int8 {c['int8_ms'] * 1e3:.6g})" if "int8_ms" in c else ")")
            for w, c in zip(warm, cold)))

    # K6: the window route verifies one request over the full context
    k6, k6_cold = [], []
    for tq_ in (tq, 8):
        q, kvp = randn(1, h, tq_, hd, scale=0.05), int8(1, h, t_enc, 2 * hd)
        full = torch.tensor([t_enc], dtype=torch.int32, device=dev)
        for ln in (None, full):
            label = (f"q [1,{h},{tq_},{hd}] kvp [1,{h},{t_enc},{2 * hd}]"
                     + ("" if ln is None else " lengths"))
            r = compare(
                "cross_attention_int8_window", label,
                lambda q=q, kvp=kvp, ln=ln: attn_ops.cross_attention_int8_window(q, kvp, ln),
                lambda q=q, kvp=kvp, ln=ln: attn_ops.cross_attention_int8_window_ref(q, kvp, ln),
                2.0**-6, per_row=True)
            w = work([t_enc], tq_, 2 * hd, 0 if ln is None else 4)
            r.update(bound(*w))
            k6.append(r)
            k6_cold.append(cross_cold(
                "cross_attention_int8_window " + label,
                lambda k, q=q, ln=ln: attn_ops.cross_attention_int8_window(q, k, ln), (kvp,), q,
                slice(None), w, int8_kv_bf16))
    summary("cross_attention_int8_window", k6, k6_cold)
    results["cross_attention_int8_window"] = dict(
        k6[0], max_abs_err=max(r["max_abs_err"] for r in k6), library_ms=None,
        other_shapes=k6[1:], cold=k6_cold)

    # K5's window form: the continuous verify at the smoke pool's shape, in
    # K5's cases, and at Tq = 8 with every row active
    kvp = int8(b5, h, t5, 2 * hd)
    qs = {tq_: randn(b5, h, tq_, hd, scale=0.05) for tq_ in (tq, 8)}
    k5w, k5w_cold = [], []

    def k5w_case(label, lens, act, tq_=tq):
        q = qs[tq_]
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        ac = torch.tensor(act, device=dev)
        label = f"q [{b5},{h},{tq_},{hd}] kvp [{b5},{h},{t5},{2 * hd}] {label}"
        r = compare(
            "cross_attention_int8_skip_window", label,
            lambda: attn_ops.cross_attention_int8_window(q, kvp, ln, ac),
            lambda: attn_ops.cross_attention_int8_skip_window_ref(q, kvp, ln, ac), 2.0**-6,
            rows=ac, per_row=True)
        out = attn_ops.cross_attention_int8_window(q, kvp, ln, ac)
        check(not out[~ac].any(), f"cross_attention_int8_skip_window {label}: inactive rows "
              "must be zero")
        w = work([min(n, t5) or t5 for n, a in zip(lens, act) if a], tq_, 2 * hd, b5 * 5)
        r.update(bound(*w))
        k5w.append(r)
        k5w_cold.append(cross_cold(
            "cross_attention_int8_skip_window " + label,
            lambda k: attn_ops.cross_attention_int8_window(q, k, ln, ac), (kvp,), q, ac, w,
            int8_kv_bf16))
        return r

    entry = k5w_case(f"8/{b5} active, len {t5}", [t5] * b5, [True] * b5)
    for n_act in (4, 1):
        k5w_case(f"{n_act}/{b5} active, len {t5}", [t5] * b5, [i < n_act for i in range(b5)])
    k5w_case("all active, lengths mixed", mixed, [True] * b5)
    k5w_case("half active", mixed, [i % 2 == 0 for i in range(b5)])
    k5w_case("one active row, len 0", [0] + mixed[1:], [True] + [False] * (b5 - 1))
    k5w_case(f"8/{b5} active, len {t5}", [t5] * b5, [True] * b5, tq_=8)
    summary("cross_attention_int8_skip_window", k5w, k5w_cold)
    results["cross_attention_int8_skip_window"] = dict(
        entry, max_abs_err=max(r["max_abs_err"] for r in k5w), library_ms=None,
        other_shapes=k5w[1:], cold=k5w_cold)

    # K7: int4 decode steps, the window batch over the full context and the
    # continuous pool at its cross cap (the mixed route's shape, reported)
    k7, k7_cold = [], []
    for b, t, lens in ((BATCH, t_enc, [t_enc, 700, 1, 0]), (b5, t5, mixed)):
        q = randn(b, h, hd, scale=Q_SCALE_INT4)
        k4, v4 = int8(b, h, t, hd // 2), int8(b, h, t, hd // 2)
        for ln in (None, torch.tensor(lens, dtype=torch.int32, device=dev)):
            label = (f"q [{b},{h},{hd}] k4/v4 [{b},{h},{t},{hd // 2}]"
                     + ("" if ln is None else f" lengths {lens}"))
            r = compare(
                "cross_attention_int4", label,
                lambda q=q, k4=k4, v4=v4, ln=ln: attn_ops.cross_attention_int4(q, k4, v4, ln),
                lambda q=q, k4=k4, v4=v4, ln=ln: attn_ops.cross_attention_int4_ref(q, k4, v4, ln),
                2.0**-6, per_row=True)
            used = [t] * b if ln is None else [min(n, t) or t for n in lens]
            w = work(used, 1, hd, 0 if ln is None else 4 * b)
            r.update(bound(*w))
            k7.append(r)
            k7_cold.append(cross_cold(
                "cross_attention_int4 " + label,
                lambda k, v, q=q, ln=ln: attn_ops.cross_attention_int4(q, k, v, ln), (k4, v4), q,
                slice(None), w, int4_kv_bf16))
            k7_cold[-1]["int8_ms"] = int8_beside(
                "cross_attention_int4 " + label,
                lambda kvp, q=q, ln=ln: attn_ops.cross_attention_int8(q, kvp, ln),
                (b, h, t, 2 * hd), work(used, 1, 2 * hd)[0], int8)
    summary("cross_attention_int4", k7, k7_cold)
    results["cross_attention_int4"] = dict(
        k7[3], max_abs_err=max(r["max_abs_err"] for r in k7), library_ms=None,
        other_shapes=k7[:3], cold=k7_cold)

    # K8: the int4 verify of the continuous speculative pool
    q = randn(b5, h, tq, hd, scale=Q_SCALE_INT4)
    k4, v4 = int8(b5, h, t5, hd // 2), int8(b5, h, t5, hd // 2)
    k8, k8_cold = [], []
    for ln in (None, torch.tensor(mixed, dtype=torch.int32, device=dev)):
        label = (f"q [{b5},{h},{tq},{hd}] k4/v4 [{b5},{h},{t5},{hd // 2}]"
                 + ("" if ln is None else f" lengths {mixed}"))
        r = compare(
            "cross_attention_int4_window", label,
            lambda ln=ln: attn_ops.cross_attention_int4_window(q, k4, v4, ln),
            lambda ln=ln: attn_ops.cross_attention_int4_window_ref(q, k4, v4, ln), 2.0**-6,
            per_row=True)
        used = [t5] * b5 if ln is None else [min(n, t5) or t5 for n in mixed]
        w = work(used, tq, hd, 0 if ln is None else 4 * b5)
        r.update(bound(*w))
        k8.append(r)
        k8_cold.append(cross_cold(
            "cross_attention_int4_window " + label,
            lambda k, v, ln=ln: attn_ops.cross_attention_int4_window(q, k, v, ln), (k4, v4), q,
            slice(None), w, int4_kv_bf16))
        k8_cold[-1]["int8_ms"] = int8_beside(
            "cross_attention_int4_window " + label,
            lambda kvp, ln=ln: attn_ops.cross_attention_int8_window(q, kvp, ln),
            (b5, h, t5, 2 * hd), work(used, tq, 2 * hd)[0], int8)
    summary("cross_attention_int4_window", k8, k8_cold)
    results["cross_attention_int4_window"] = dict(
        k8[1], max_abs_err=max(r["max_abs_err"] for r in k8), library_ms=None,
        other_shapes=k8[:1], cold=k8_cold)
    return results


def encoder_phase(engine: WhisperEngine, k1: dict) -> list[dict]:
    """Host time of one encode call (every encoder layer, random bf16
    weights) at the window path's mel [BATCH, 3000, n_mels] and the insert
    bucket's [8, 1024, n_mels]: median of 5 calls after a warm-up, each
    ending in torch.cuda.synchronize(). Beside it n_audio_layer x K1's time
    at the same attention shape (phase 3), as K1's share of the encoder."""
    cfg, dev = engine.cfg, engine.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    k1_by_shape = {r["shape"]: r["ms"] for r in [k1, *k1["other_shapes"]]}
    out = []
    for b, t_mel in ((BATCH, 2 * cfg.n_audio_ctx), (8, 1024)):
        mel = torch.randn((b, t_mel, cfg.n_mels), generator=gen, device=dev)
        with torch.inference_mode():
            times = []
            for _ in range(6):
                t0 = time.perf_counter()
                enc = wmod.encode(engine.params, cfg, mel)
                torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t0) * 1e3)
        check(enc.shape == (b, t_mel // 2, cfg.n_audio_state) and bool(torch.isfinite(enc).all()),
              f"encode [{b},{t_mel}]: {tuple(enc.shape)}, finite {bool(torch.isfinite(enc).all())}")
        ms = statistics.median(times[1:])
        k1_ms = cfg.n_audio_layer * k1_by_shape[
            f"q/k/v [{b},{t_mel // 2},{cfg.n_audio_head},{cfg.head_dim}]"]
        out.append({"mel": [b, t_mel, cfg.n_mels], "encode_ms": ms, "k1_ms_x_layers": k1_ms,
                    "k1_share": k1_ms / ms})
        log(f"encoder forward mel [{b},{t_mel},{cfg.n_mels}]: {ms:.6g} ms (median of 5), "
            f"{cfg.n_audio_layer} x K1 {k1_ms:.6g} ms, share {k1_ms / ms:.6g}")
    return out


# ---------------------------------------------------------------------------
# Phases 4 and 5: the serving paths
# ---------------------------------------------------------------------------


class ConnectionClosedOK(Exception):
    """Ends the fake connection ("Closed" in the name: a normal close)."""


class FakeWebSocket:
    """In-process websocket: a queue of incoming messages, recorded sends."""

    CLOSE = object()

    def __init__(self):
        self.incoming: asyncio.Queue = asyncio.Queue()
        self.sent: list[dict] = []

    async def recv(self):
        item = await self.incoming.get()
        if item is self.CLOSE:
            raise ConnectionClosedOK()
        return item

    async def send(self, message):
        self.sent.append(json.loads(message))

    async def close(self, *args):
        pass


class CountingBackend(backends_mod.TorchBackend):
    """TorchBackend that records every call: the serving layer logs and
    swallows backend exceptions, so the smoke test counts them itself."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calls: list[dict] = []
        self.started: dict[str, int] = {}

    async def transcribe(self, chunk, options, **kw):
        t0 = time.monotonic()
        self.started[kw.get("uid")] = self.started.get(kw.get("uid"), 0) + 1
        try:
            result = await super().transcribe(chunk, options, **kw)
            error = None
        except Exception as e:  # recorded, then re-raised to the session
            result, error = None, e
        self.calls.append(dict(uid=kw.get("uid"), seconds=len(chunk) / 16000.0, audio=chunk,
                               latency_s=time.monotonic() - t0, result=result, error=error))
        if error is not None:
            raise error
        return result

    def n_calls(self, uid: str) -> int:
        return sum(1 for c in self.calls if c["uid"] == uid)


async def run_session(server, backend, uid, language, audio, delay_s=0.0, use_vad=True,
                      word_timestamps=False, extra=None, settle=None):
    """One streaming session through the server's connection handler.
    `extra` adds handshake fields; `settle(ws)` must hold (within 300 s)
    before the connection closes."""
    await asyncio.sleep(delay_s)
    ws = FakeWebSocket()
    handshake = {"uid": uid, "language": language, "task": "transcribe", "model": MODEL,
                 "use_vad": use_vad, "word_timestamps": word_timestamps, **(extra or {})}
    ws.incoming.put_nowait(json.dumps(handshake))
    task = asyncio.create_task(server.recv_audio(ws))
    step = int(16000 * FRAME_S)
    for off in range(0, len(audio), step):
        ws.incoming.put_nowait(audio[off:off + step].tobytes())
        await asyncio.sleep(FRAME_S)  # real-time pace
    ws.incoming.put_nowait(b"END_OF_AUDIO")
    # after the end of audio the session transcribes what is left of its
    # tail: close once a call that started after the server took the end
    # has finished (a call in flight then covers only the audio it was
    # given), or, with no call in flight, the whole tail was committed
    client = server.client_manager.get_client(ws)
    deadline = time.monotonic() + 300
    while client and not client.eos and time.monotonic() < deadline:
        await asyncio.sleep(0.01)
    at_eos = backend.started.get(uid, 0)
    while time.monotonic() < deadline:
        done = backend.n_calls(uid)
        drained = done == backend.started.get(uid, 0) and client and \
            client.session.buffered_duration() <= 1e-6
        if done > at_eos or (done and drained):
            break
        await asyncio.sleep(0.1)
    while settle is not None and not settle(ws) and time.monotonic() < deadline:
        await asyncio.sleep(0.1)
    ws.incoming.put_nowait(FakeWebSocket.CLOSE)
    await task
    return ws


def serve(backend, sessions, translation_model_dir=None) -> tuple[list, float]:
    """Run the sessions through the server's connection handler, with every
    launch counter reset to 0 just before; returns (sockets, wall seconds).
    The caller stops its schedulers and then reads the counters."""
    server = TranscriptionServer()  # attributes as serve() sets them
    server.translation_model_dir = translation_model_dir
    server.backend = backend
    server.backend_name = "torch"
    server.client_manager = ClientManager(max_clients=4, max_connection_time=600)

    async def all_sessions():
        return await asyncio.gather(*(run_session(server, backend, **s) for s in sessions))

    _kernels.reset_launches()
    t0 = time.monotonic()
    sockets = asyncio.run(all_sessions())
    torch.cuda.synchronize()
    return sockets, time.monotonic() - t0


def check_calls(backend, uids, min_calls):
    for c in backend.calls:
        res = c["result"]
        log(f"call {c['uid']}: {c['seconds']:.6g} s of audio, latency {c['latency_s']:.6g} s, "
            f"{len(res.raw_tokens) if isinstance(res, BatchResult) else 0} tokens, "
            f"error={c['error']!r}")
    check(len(backend.calls) >= min_calls, f"only {len(backend.calls)} backend calls")
    for c in backend.calls:
        check(c["error"] is None, f"backend call raised: {c['error']!r}")
        check(isinstance(c["result"], BatchResult), f"backend returned {c['result']!r}")
    check({c["uid"] for c in backend.calls} == set(uids), "every session must reach the backend")


def check_sockets(sockets):
    for ws in sockets:
        check(any(m.get("message") == "SERVER_READY" for m in ws.sent), "no SERVER_READY")
        check(any("segments" in m for m in ws.sent), "no segments reached the client")


def build_engine(dev: torch.device, name: str, params, batch_buckets,
                 cross_kv_bits: int = 8) -> WhisperEngine:
    """An engine on random bf16 weights (engines built from one parameter
    tree share its encoder tensors)."""
    backends_mod._DISABLE_GATES = True  # random weights: first attempt passes
    backends_mod.STREAMING_MAX_NEW_TOKENS = MAX_NEW_TOKENS
    t0 = time.monotonic()
    cfg = wmod.WHISPER_CONFIGS[name]
    engine = WhisperEngine(cfg, params, device=dev, batch_buckets=batch_buckets,
                           cross_kv_bits=cross_kv_bits, tokenizer=visible_tokenizer(cfg))
    torch.cuda.synchronize(dev)
    log(f"engine: {name} random bf16 weights, decoder int8, cross-KV "
        f"{engine.cross_kv_bits}-bit, built in {time.monotonic() - t0:.6g} s")
    leaves = []
    wmod.tree_map(leaves.append, engine.params)
    check(all(t.device.type == "cuda" for t in leaves), "engine parameters off the card")
    return engine


def window_phase(engine: WhisperEngine) -> dict:
    t0 = time.monotonic()
    engine.warmup(batch_sizes=set(engine.batch_buckets))
    log(f"window warmup: {time.monotonic() - t0:.6g} s")

    engine_calls = []
    transcribe_batch = engine.transcribe_batch

    def recorded_transcribe_batch(audio, prompts, *args, **kw):
        start = time.monotonic()
        out = transcribe_batch(audio, prompts, *args, **kw)
        results, _, cross = out
        engine_calls.append(dict(
            batch=audio.shape[0], n_real=len(prompts), seconds=time.monotonic() - start,
            tokens=sum(len(r.tokens) + 1 for r in results),
            cross_devices={t.device.type for t in cross.values() if t is not None}))
        return out

    engine.transcribe_batch = recorded_transcribe_batch
    scheduler = BatchScheduler(engine, max_batch_size=BATCH, batch_window_ms=50)
    scheduler.start()
    try:
        backend = CountingBackend(scheduler, model_name=MODEL)
        sessions = [
            dict(uid="window-en", language="en", audio=speech_like(WINDOW_SESSION_S, 1)),
            dict(uid="window-detect", language=None, audio=speech_like(WINDOW_SESSION_S, 2)),
        ]
        sockets, wall = serve(backend, sessions)
    finally:
        scheduler.stop()
        del engine.transcribe_batch
    launches = dict(_kernels.launches)

    check_calls(backend, [s["uid"] for s in sessions], 4)
    for e in engine_calls:
        log(f"engine batch {e['n_real']}/{e['batch']}: {e['seconds']:.6g} s, "
            f"{e['tokens']} decoded tokens, {e['tokens'] / e['seconds']:.6g} tokens/s")
    busy = sum(e["seconds"] for e in engine_calls)
    tokens = sum(e["tokens"] for e in engine_calls)
    log(f"window sessions: {wall:.6g} s wall, {len(backend.calls)} backend calls, "
        f"{len(engine_calls)} engine batches, decode {tokens} tokens in {busy:.6g} s "
        f"engine time = {tokens / max(busy, 1e-9):.6g} tokens/s")
    log(f"window path launch counts: {launches}")
    for name in WINDOW_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched by the window path")
    check(all(e["cross_devices"] == {"cuda"} for e in engine_calls), "cross-KV off the card")
    check_sockets(sockets)
    check(any("language" in m for m in sockets[1].sent), "detected language never sent")
    return launches


def continuous_phase(engine: WhisperEngine) -> dict:
    cs = ContinuousScheduler(engine, n_slots=CONT_SLOTS, steps_per_chunk=8, cross_ctx=640,
                             enc_buckets=(512, 1500))
    t0 = time.monotonic()
    cs.warmup()
    log(f"continuous warmup: {time.monotonic() - t0:.6g} s")
    window = BatchScheduler(engine, max_batch_size=BATCH, batch_window_ms=50)
    window.start()
    cs.start()
    try:
        backend = CountingBackend(window, model_name=MODEL, continuous_scheduler=cs)
        routed = []
        pick = backend._pick_scheduler
        backend._pick_scheduler = lambda *a, **kw: routed.append(pick(*a, **kw)) or routed[-1]
        sessions = [
            dict(uid="cont-en", language="en", audio=speech_like(CONT_SESSION_S, 5)),
            dict(uid="cont-detect", language=None, audio=speech_like(CONT_SESSION_S, 6),
                 use_vad=False),
            dict(uid="cont-late", language="en", audio=speech_like(CONT_SESSION_S - 2.0, 7),
                 delay_s=2.0),
        ]
        sockets, wall = serve(backend, sessions)
    finally:
        cs.stop()  # joins the worker: no chunk is in flight below
        window.stop()
    launches = dict(_kernels.launches)
    state_devices = set()
    wmod.tree_map(lambda t: state_devices.add(t.device.type), cs.cb.state)
    steps = cs.cb.gstep
    idle_steps = int(cs.cb.state["idle_row_steps"])

    check_calls(backend, [s["uid"] for s in sessions], 6)
    check(all(s is cs for s in routed), "a continuous-path request went to the window path")
    ts = cs.tick_stats
    log(f"continuous sessions: {wall:.6g} s wall, {len(backend.calls)} backend calls, "
        f"{ts['ticks']} chunks, {steps} steps, mean step {ts['step_s'] / max(steps, 1) * 1e3:.6g}"
        f" ms (host clock, chunk dispatch + status copy over steps), insert "
        f"{ts['insert_s']:.6g} s in {ts['insert_calls']} inserts of {ts['insert_windows']} "
        f"windows, harvest {ts['harvest_s']:.6g} s, steps with inactive rows "
        f"{idle_steps}/{steps} = {idle_steps / max(steps, 1):.6g}, mean occupied rows per "
        f"chunk {ts['step_rows'] / max(ts['ticks'], 1):.6g} of {CONT_SLOTS}")
    log(f"continuous path launch counts: {launches}; per step: " + ", ".join(
        f"{n} {launches[n] / max(steps, 1):.6g}" for n in CONTINUOUS_PATH))
    for name in CONTINUOUS_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched by the continuous path")
    check(state_devices == {"cuda"}, f"slot state on {state_devices}, not the card")
    check(steps > 0 and launches["cross_attention_int8_skip"] ==
          steps * engine.cfg.n_text_layer, "K5 must launch once per decoder layer per step")
    check_sockets(sockets)
    check(any("language" in m for m in sockets[1].sent), "detected language never sent")
    step_ms = profile_pool("continuous step", cs.cb, 1, "step",
                           {"K5": cross_kernel("Int8Packed", 1),
                            "K3": re.compile("int8_matmul_t_kernel")})
    # the profiled step's roofline inputs, as the scheduler's tick_stats count
    # them: the pool's rows, its self-KV columns, and the cross positions K5
    # reads for the occupied slots
    step = {"device_ms": step_ms, "n_rows": cs.cb.n_rows,
            "cache_len": cs.cb.cache_len,
            "cross_pos": PROFILE_SLOTS * min(PROFILE_ENC_CTX, cs.cb.cross_ctx)}
    return launches, step


def cuda_profile(fn) -> tuple[list, float, int]:
    """fn() under torch.profiler: (the CUDA events of key_averages(), wall
    seconds, kernel launches). A CPU op's device time repeats its kernels',
    so device time sums the CUDA events only."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        wall = time.monotonic() - t0
    events = prof.key_averages()
    launch_keys = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                   "cuLaunchKernelEx")
    n_launch = sum(e.count for e in events if e.key in launch_keys)
    return ([e for e in events if e.device_type == torch.autograd.DeviceType.CUDA], wall,
            n_launch)


def cross_kernel(codec: str, tq: int) -> re.Pattern:
    """The CUDA event names of the cross-attention kernel over the row codec
    `codec` at Tq queries: cross_attention_kernel<codec, Tq>."""
    return re.compile(rf"cross_attention_kernel<[\w:() ]*{codec}, {tq}>")


def device_us(events, pattern: re.Pattern | None = None) -> float:
    return sum(e.self_device_time_total for e in events
               if pattern is None or pattern.search(e.key))


PROFILE_SLOTS = 3  # slots decoding in a profiled pool window
PROFILE_ENC_CTX = 512  # their encoder bucket


def seat_profile_slots(cb) -> None:
    """The pool `cb` anew with PROFILE_SLOTS slots decoding 6 s windows at
    the PROFILE_ENC_CTX bucket, one chunk stepped (warm)."""
    cb.init_state()
    prompt, sot = cb.eng.build_prompt(
        backends_mod.transcribe_options_from_session(SessionOptions(language="en")),
        language="en")
    k = PROFILE_SLOTS
    windows = np.zeros((k, 480000), np.float32)
    for i in range(k):
        windows[i, :96000] = speech_like(6.0, 20 + i)
    cb.insert(windows, [prompt] * k, [sot] * k, [True] * k, list(range(k)), [0.0] * k,
              [True] * k, [1.0] * k, [cb.ring - 1] * k, enc_ctx=PROFILE_ENC_CTX)
    cb.step()  # warm


def profile_pool(label: str, cb, chunks: int, unit: str, named: dict) -> float | None:
    """torch.profiler over `chunks` chunks of the pool `cb` with three
    slots decoding 6 s windows: CUDA kernel launches per `unit` (a
    decode step, or a verify round of a speculative pool:
    cb.steps_per_chunk a chunk), the device's busy share of the wall time,
    and the device time per unit of the five largest CUDA kernels by name
    and of the kernels `named` ({label: name pattern}), each beside its
    share of the device time. A profiler that records no CUDA event is
    reported as not measured. Returns the device ms per unit, or None when
    not measured."""
    seat_profile_slots(cb)
    on_card, wall, n_launch = cuda_profile(lambda: [cb.step() for _ in range(chunks)])
    n = chunks * cb.steps_per_chunk
    total = device_us(on_card)
    device = (f"device time {total / 1e3 / n:.6g} ms per {unit} in {len(on_card)} kinds of "
              f"CUDA event, device busy share {total / 1e6 / wall:.6g}" if on_card
              else "device time not measured (no CUDA events recorded)")
    log(f"{label} profile ({n} {unit}s, 3 of {cb.n_slots} slots decoding): "
        f"{n_launch / n:.6g} kernel launches per {unit}, wall {wall / n * 1e3:.6g} "
        f"ms per {unit} under the profiler, {device}")
    top = sorted(on_card, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    groups = [("one of the five largest", top)] + [
        (name, [e for e in on_card if pattern.search(e.key)]) for name, pattern in named.items()]
    for name, events in groups:
        for e in events:
            log(f"{label} kernel ({name}): {e.self_device_time_total / n:.6g} us per {unit} "
                f"(share {e.self_device_time_total / max(total, 1e-9):.6g}) in "
                f"{e.count / n:.6g} launches: {e.key[:160]}")
    return total / 1e3 / n if on_card else None


# ---------------------------------------------------------------------------
# Phase 6: the speculative routes
# ---------------------------------------------------------------------------


def check_path(label: str, launches: dict, path, absent=()) -> None:
    log(f"{label} launch counts: {launches}")
    for name in path:
        check(launches[name] > 0, f"kernel {name} was not launched by the {label}")
    for name in absent:
        check(launches[name] == 0, f"kernel {name} launched on the {label}")


def spec_window_phase(engine: WhisperEngine, draft: WhisperEngine) -> dict:
    """SpeculativeDecoder on the BatchScheduler: one stream, so every
    request is a lone greedy request and takes the draft route (K4 in the
    draft steps, K6 in the verify)."""
    spec = SpeculativeDecoder(engine, draft, k=SPEC_K)
    t0 = time.monotonic()
    spec.warmup(options=TranscribeOptions(language="en", max_new_tokens=MAX_NEW_TOKENS))
    log(f"speculative window warmup: {time.monotonic() - t0:.6g} s")
    scheduler = BatchScheduler(engine, max_batch_size=BATCH, batch_window_ms=50,
                               spec_decoder=spec)
    plain_batches, decode_s = [], []
    transcribe_batch = engine.transcribe_batch
    decode = spec.decode

    def timed_decode(*a, **kw):
        t = time.monotonic()
        out = decode(*a, **kw)
        decode_s.append(time.monotonic() - t)
        return out

    spec.decode = timed_decode
    engine.transcribe_batch = lambda *a, **kw: plain_batches.append(1) or transcribe_batch(
        *a, **kw)
    scheduler.start()
    before = dict(spec.stats)
    try:
        backend = CountingBackend(scheduler, model_name=MODEL)
        sessions = [dict(uid="spec-window", language=None,
                         audio=speech_like(WINDOW_SESSION_S, 8))]
        sockets, wall = serve(backend, sessions)
    finally:
        scheduler.stop()
        del engine.transcribe_batch
        del spec.decode
    launches = dict(_kernels.launches)
    st = {k: spec.stats[k] - before[k] for k in before}

    check_calls(backend, ["spec-window"], 1)
    log(f"speculative window route: {wall:.6g} s wall, {len(backend.calls)} backend calls, "
        f"{st['windows']} windows, {st['iterations']} verify rounds, {st['emitted']} tokens, "
        f"acceptance {st['accepted'] / max(st['iterations'] * SPEC_K, 1):.6g}, committed tokens "
        f"per round {st['emitted'] / max(st['iterations'], 1):.6g}; speculative decodes took "
        f"{sum(decode_s):.6g} s, {sum(decode_s) / max(st['iterations'], 1) * 1e3:.6g} ms per "
        f"round (host clock)")
    # a call in flight when the session closed still decodes: windows >= calls
    check(st["windows"] >= len(backend.calls) and not plain_batches,
          f"{len(plain_batches)} lone greedy requests missed the draft route")
    check_path("speculative window route", launches, SPEC_WINDOW_PATH)
    check(launches["cross_attention_int8_window"] ==
          st["iterations"] * engine.cfg.n_text_layer,
          "K6 must launch once per target layer per verify round")
    check_sockets(sockets)
    check(any("language" in m for m in sockets[0].sent), "detected language never sent")
    profile_spec_decode(engine, spec)
    return launches


def profile_spec_decode(engine: WhisperEngine, spec: SpeculativeDecoder) -> None:
    """Device time a verify round of the window route: torch.profiler over
    one speculative greedy decode of max_new_tokens 3 (both prefills and
    the rounds for two tokens) less one of max_new_tokens 1 (both prefills
    alone), on the same window, over the rounds the decoder counted; K6's
    device time a round beside it, as its share."""
    audio = np.zeros((1, 480000), np.float32)
    audio[0, :96000] = speech_like(6.0, 50)
    enc, cross = engine.prepare(audio)
    cross_d = spec.cross_from_enc(enc)

    def decode(max_new):
        opts = TranscribeOptions(language="en", temperatures=(0.0,), max_new_tokens=max_new,
                                 log_prob_threshold=None, no_speech_threshold=None,
                                 compression_ratio_threshold=None)
        prompt, sot = engine.build_prompt(opts, language="en")
        before = spec.stats["iterations"]
        on_card, _, _ = cuda_profile(lambda: spec.decode(cross, cross_d, prompt, sot, opts))
        return on_card, spec.stats["iterations"] - before

    decode(3)  # warm
    (with_rounds, rounds), (prefill, _) = decode(3), decode(1)
    if rounds < 1 or not with_rounds:
        log("speculative window route profile: device time not measured "
            f"({rounds} rounds, {len(with_rounds)} CUDA events)")
        return
    k6 = cross_kernel("Int8Packed", SPEC_K + 1)
    per_round = (device_us(with_rounds) - device_us(prefill)) / rounds
    k6_round = (device_us(with_rounds, k6) - device_us(prefill, k6)) / rounds
    log(f"speculative window route profile ({rounds} verify rounds): device time "
        f"{per_round / 1e3:.6g} ms per round, K6 {k6_round:.6g} us per round (share "
        f"{k6_round / per_round:.6g})")


def spec_pool(engine: WhisperEngine, draft: WhisperEngine, n_slots: int,
              steps_per_chunk: int) -> ContinuousScheduler:
    cs = ContinuousScheduler(engine, n_slots=n_slots, steps_per_chunk=steps_per_chunk,
                             cross_ctx=640, enc_buckets=(512, 1500), ring=SPEC_RING,
                             draft_engine=draft, spec_k=SPEC_K)
    t0 = time.monotonic()
    cs.warmup()
    log(f"speculative pool warmup ({n_slots} slots, ring {cs.cb.ring}): "
        f"{time.monotonic() - t0:.6g} s")
    return cs


def log_spec_pool(label: str, cs: ContinuousScheduler, launches: dict, n_layer: int,
                  verify: str) -> dict:
    """Acceptance and committed tokens per round of a speculative pool; its
    verify kernel launches once per target layer per round. Returns them:
    `pool_rounds` counts the pool's verify rounds (every slot at once),
    `window_rounds` the rounds each harvested window took part in, summed
    over the windows, and `committed_per_window_round` is one window's
    committed tokens per round it took part in (at most k + 1)."""
    rounds = cs.cb.gstep // (SPEC_K + 2)
    ss = cs.spec_stats
    figures = {"pool_rounds": rounds, "window_rounds": ss["rounds"],
               "acceptance": cs.acceptance_rate(),
               "committed_per_window_round": ss["committed"] / max(ss["rounds"], 1)}
    log(f"{label}: {rounds} pool verify rounds ({cs.tick_stats['ticks']} chunks, "
        f"{cs.tick_stats['step_s'] / max(rounds, 1) * 1e3:.6g} ms per round on the host clock, "
        f"chunk dispatch + status copy over rounds), harvested "
        f"{ss['windows']} windows of {ss['rounds']} window rounds committing {ss['committed']} "
        f"tokens: committed tokens per window round "
        f"{ss['committed'] / max(ss['rounds'], 1):.6g}, acceptance "
        f"{cs.acceptance_rate():.6g} (EMA {cs.acceptance_ema:.6g})")
    check(ss["windows"] > 0, f"{label}: no window was harvested")
    check(rounds > 0 and launches[verify] == rounds * n_layer,
          f"{label}: {verify} must launch once per target layer per verify round")
    state_devices = set()
    wmod.tree_map(lambda t: state_devices.add(t.device.type), cs.cb.state)
    check(state_devices == {"cuda"}, f"{label}: slot state on {state_devices}, not the card")
    return figures


def spec_continuous_phase(engine: WhisperEngine, draft: WhisperEngine,
                          label: str = "continuous spec pool (all)") -> dict:
    """--continuous_spec (mode all): every chunk of the main pool is verify
    rounds (K5 in the draft steps, K5's window form in the verify).
    Returns the launches, the pool's acceptance and committed tokens per
    round, and the device ms per verify round (torch.profiler)."""
    cs = spec_pool(engine, draft, CONT_SLOTS, 4)
    window = BatchScheduler(engine, max_batch_size=BATCH, batch_window_ms=50)
    window.start()
    cs.start()
    try:
        backend = CountingBackend(window, model_name=MODEL, continuous_scheduler=cs)
        sessions = [
            dict(uid="spec-all-en", language="en", audio=speech_like(CONT_SESSION_S, 11)),
            dict(uid="spec-all-late", language="en", audio=speech_like(CONT_SESSION_S - 2.0, 12),
                 delay_s=2.0),
        ]
        sockets, wall = serve(backend, sessions)
    finally:
        cs.stop()
        window.stop()
    launches = dict(_kernels.launches)
    check_calls(backend, [s["uid"] for s in sessions], len(sessions))
    log(f"{label} sessions: {wall:.6g} s wall, {len(backend.calls)} backend calls")
    figures = log_spec_pool(label, cs, launches, engine.cfg.n_text_layer,
                            "cross_attention_int8_skip_window")
    check_path(label, launches, SPEC_ALL_PATH)
    check_sockets(sockets)
    # two verify rounds: a pool of the same shape at one round a chunk
    profiled = ContinuousEngine(engine, n_slots=CONT_SLOTS, prompt_pad=cs.cb.prompt_pad,
                                ring=SPEC_RING, steps_per_chunk=1, cross_ctx=640,
                                enc_buckets=(512, 1500), draft_engine=draft, spec_k=SPEC_K)
    figures["device_ms_per_round"] = profile_pool(
        label, profiled, 2, "verify round",
        {"K5's window form": cross_kernel("Int8Packed", SPEC_K + 1),
         "K5 in the draft steps": cross_kernel("Int8Packed", 1)})
    return {"launches": launches, **figures}


def mixed_phase(engine4: WhisperEngine, draft4: WhisperEngine) -> dict:
    """--continuous_spec --continuous_spec_mode mixed on an int4 engine: full
    re-decodes ride the speculative pool (K7 draft steps, K8 verify), the
    incremental tails the plain pool (K7)."""
    plain = ContinuousScheduler(engine4, n_slots=CONT_SLOTS, steps_per_chunk=8, cross_ctx=640,
                                enc_buckets=(512, 1500))
    plain.warmup()
    cs = spec_pool(engine4, draft4, CONT_SLOTS, 4)
    window = BatchScheduler(engine4, max_batch_size=BATCH, batch_window_ms=50)
    routes = []
    for which, sched in (("plain", plain), ("spec", cs)):
        submit = sched.submit
        sched.submit = lambda req, _s=submit, _w=which: routes.append(_w) or _s(req)
    for sched in (window, plain, cs):
        sched.start()
    try:
        backend = CountingBackend(window, model_name=MODEL, continuous_scheduler=plain,
                                  spec_scheduler=cs)
        sessions = [
            dict(uid="mixed-en", language="en", audio=speech_like(CONT_SESSION_S, 13)),
            dict(uid="mixed-late", language="en", audio=speech_like(CONT_SESSION_S - 2.0, 14),
                 delay_s=2.0),
        ]
        sockets, wall = serve(backend, sessions)
    finally:
        for sched in (cs, plain, window):
            sched.stop()
    launches = dict(_kernels.launches)
    check_calls(backend, [s["uid"] for s in sessions], len(sessions))
    log(f"mixed (int4) sessions: {wall:.6g} s wall, {len(backend.calls)} backend calls, "
        f"routes {routes.count('spec')} to the spec pool and {routes.count('plain')} to the "
        f"plain pool, route stats {backend.spec_route_stats}")
    check(routes.count("spec") > 0, "no full re-decode reached the speculative pool")
    log_spec_pool("mixed spec pool (int4)", cs, launches, engine4.cfg.n_text_layer,
                  "cross_attention_int4_window")
    check_path("mixed route (int4)", launches, MIXED_INT4_PATH, absent=INT8_CROSS)
    check_sockets(sockets)
    # two verify rounds: a speculative pool of the same shape at one round a
    # chunk
    profiled = ContinuousEngine(engine4, n_slots=CONT_SLOTS, prompt_pad=cs.cb.prompt_pad,
                                ring=SPEC_RING, steps_per_chunk=1, cross_ctx=640,
                                enc_buckets=(512, 1500), draft_engine=draft4, spec_k=SPEC_K)
    profile_pool("mixed spec pool (int4)", profiled, 2, "verify round",
                 {"K8": cross_kernel("Int4Halves", SPEC_K + 1),
                  "K7 in the draft steps": cross_kernel("Int4Halves", 1)})
    return launches


# ---------------------------------------------------------------------------
# Phase 7: beam search and word timestamps
# ---------------------------------------------------------------------------


BEAM = 5
BEAM_BATCH = 2
BEAM_CHUNK = 8
# new tokens of the profiled beam decodes (a torch.profiler window's cost
# grows with its events: ~2,500 kernels a beam step)
BEAM_PROFILE_TOKENS = 12
# the self-KV parent gather is the beam step's one index_select
GATHER = re.compile(r"index_?[sS]elect")
BEAM_PATH = ("fused_attention", "int8_matmul", "int8_matmul_t", "cross_attention_int8")


def beam_options(beam_size: int = BEAM, max_new: int = MAX_NEW_TOKENS) -> TranscribeOptions:
    return TranscribeOptions(language="en", beam_size=beam_size, temperatures=(0.0,),
                             log_prob_threshold=None, no_speech_threshold=None,
                             compression_ratio_threshold=None, max_new_tokens=max_new)


def beam_batch(engine: WhisperEngine, opts: TranscribeOptions):
    """(audio [2, N], prompts, sot indices) of the beam window batch: 8 s
    and 5 s of speech-like audio."""
    audio = np.zeros((BEAM_BATCH, 480000), np.float32)
    for i in range(BEAM_BATCH):
        seconds = 8.0 - 3.0 * i
        audio[i, : int(16000 * seconds)] = speech_like(seconds, 50 + i)
    prompt, sot = engine.build_prompt(opts, language="en")
    return audio, [prompt] * BEAM_BATCH, [sot] * BEAM_BATCH


def beam_steps(engine: WhisperEngine, fn):
    """fn() and the beam steps (expansions) its beam decodes ran."""
    steps = []
    best = engine._beam_best

    def recorded(carry, k, length_penalty):
        steps.append(carry.state.step)
        return best(carry, k, length_penalty)

    engine._beam_best = recorded
    try:
        out = fn()
    finally:
        del engine._beam_best
    return out, sum(steps)


def gather_bytes(engine: WhisperEngine, rows: int, cache_len: int) -> int:
    """Bytes the self-KV parent gather reads and writes a step."""
    cfg = engine.cfg
    return 2 * cfg.n_text_layer * 2 * rows * cache_len * cfg.n_text_state * 2


def log_step_profile(label: str, engine: WhisperEngine, full, short, steps: int,
                     rows: int, cache_len: int) -> None:
    """Device time per beam step (the difference of a long and a short run
    over their difference in steps) and the self-KV gather's share."""
    (ev_f, wall_f, n_f), (ev_s, wall_s, n_s) = full, short
    if not ev_f:
        log(f"{label}: device time not measured (no CUDA events recorded)")
        return
    dev_us = (device_us(ev_f) - device_us(ev_s)) / steps
    gat_us = (device_us(ev_f, GATHER) - device_us(ev_s, GATHER)) / steps
    names = sorted({e.key[:100] for e in ev_f if GATHER.search(e.key)})
    log(f"{label}: device time {dev_us / 1e3:.6g} ms per beam step ({steps} steps, "
        f"{(n_f - n_s) / steps:.6g} kernel launches a step, wall "
        f"{(wall_f - wall_s) / steps * 1e3:.6g} ms a step under the profiler); self-KV "
        f"parent gather {gat_us:.6g} us a step = share {gat_us / max(dev_us, 1e-9):.6g} "
        f"({gather_bytes(engine, rows, cache_len) / 1e6:.6g} MB read and written, "
        f"{gather_bytes(engine, rows, cache_len) / max(gat_us, 1e-9) / 1e3:.6g} GB/s) "
        f"in kernels {names}")
    top = sorted(ev_f, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    for e in top:
        log(f"{label} kernel (one of the five largest, long run): "
            f"{e.self_device_time_total / 1e3:.6g} ms in {e.count} launches: {e.key[:160]}")


def beam_window_phase(engine: WhisperEngine) -> dict:
    """The window route at beam 5 and batch bucket 2: transcribe_batch
    (prepare, language ID, the beam program), with the launches, the time
    per window, the launches and device time per beam step, the self-KV
    gather's share; beam K = 1 against the greedy decode, and the chunked
    beam (segments of BEAM_CHUNK steps) against the monolithic one."""
    opts = beam_options()
    audio, prompts, sots = beam_batch(engine, opts)
    args = (audio, prompts, sots, [True] * BEAM_BATCH, opts)
    engine.transcribe_batch(*args)  # first call at these shapes
    _kernels.reset_launches()
    t0 = time.monotonic()
    (results, _, cross), steps = beam_steps(engine, lambda: engine.transcribe_batch(*args))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(_kernels.launches)
    check_path("beam window route", launches, BEAM_PATH, absent=("cross_attention_int8_skip",))
    log(f"beam window route (beam {BEAM}, batch {BEAM_BATCH}, {MAX_NEW_TOKENS} new tokens): "
        f"{wall:.6g} s for the batch = {wall / BEAM_BATCH:.6g} s per window on the host clock "
        f"(prepare, language ID and the beam decode of {steps} steps); tokens "
        f"{[len(r.tokens) for r in results]}, avg_logprob {[r.avg_logprob for r in results]}")
    check(all(0 < len(r.tokens) <= MAX_NEW_TOKENS and np.isfinite(r.avg_logprob)
              for r in results), "beam window results out of range")
    check({t.device.type for t in cross.values() if t is not None} == {"cuda"},
          "cross-KV off the card")

    def decode(o):
        return engine.decode_batch(cross, prompts, sots, o)

    # launches and device time per step: a full decode less a one-step one
    # (prefill and one expansion, no decode step)
    counted = {}
    for max_new in (MAX_NEW_TOKENS, 1):
        before = dict(_kernels.launches)
        _, n = beam_steps(engine, lambda: decode(beam_options(max_new=max_new)))
        counted[max_new] = ({k: _kernels.launches[k] - before[k] for k in before}, n)
    (full, n_full), (short, n_short) = counted[MAX_NEW_TOKENS], counted[1]
    per_step = {k: (full[k] - short[k]) / (n_full - n_short) for k in BEAM_PATH[1:]}
    log(f"beam window route launches per beam step (B*K = {BEAM_BATCH * BEAM} rows): "
        f"K2 {per_step['int8_matmul']:.6g}, K3 {per_step['int8_matmul_t']:.6g}, "
        f"K4 {per_step['cross_attention_int8']:.6g}")
    n_layer = engine.cfg.n_text_layer
    check(per_step == {"int8_matmul": 8 * n_layer, "int8_matmul_t": 1,
                       "cross_attention_int8": n_layer},
          f"beam step launches {per_step}: K2 8 a layer, K3 once, K4 once a layer")
    cache_len = engine._cache_len(engine._pad_prompts(prompts)[0].shape[1], MAX_NEW_TOKENS)
    # device time per step: a BEAM_PROFILE_TOKENS decode less a one-step one,
    # each under torch.profiler
    (prof_full, n_prof), (prof_short, n_prof_short) = (
        beam_steps(engine, lambda n=n: cuda_profile(lambda: decode(beam_options(max_new=n))))
        for n in (BEAM_PROFILE_TOKENS, 1))
    log_step_profile("beam window route profile", engine, prof_full, prof_short,
                     n_prof - n_prof_short, BEAM_BATCH * BEAM,
                     engine._cache_len(engine._pad_prompts(prompts)[0].shape[1],
                                       BEAM_PROFILE_TOKENS))

    # beam K = 1 is the greedy decode
    greedy = decode(beam_options(beam_size=1))
    arr, plen = engine._pad_prompts(prompts)
    t = engine._tensor
    o1 = beam_options(beam_size=1)
    beam_args = (cross, t(arr), t(plen), t(np.asarray(sots, np.int32)),
                 engine.suppress_mask_for(o1), t(np.ones(BEAM_BATCH, bool)), 1.0,
                 MAX_NEW_TOKENS, cache_len, 0, True, -1)
    toks, gen, _, _ = engine._decode_beam(beam_args, 1, 1.0)
    toks, gen = toks.cpu().numpy(), gen.cpu().numpy()
    for i, r in enumerate(greedy):
        b1 = [int(x) for x in toks[i, : gen[i]] if x != engine.spec.eot]
        check(b1 == [int(x) for x in r.tokens],
              f"beam K = 1 differs from the greedy decode on item {i}: {b1} vs {list(r.tokens)}")
    log(f"beam K = 1 against the greedy decode: token-exact on {len(greedy)} items "
        f"({[len(r.tokens) for r in greedy]} tokens)")

    # the chunked (preemptible) beam against the monolithic one
    saved = engine.beam_chunk
    t0 = time.monotonic()
    mono = decode(opts)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    engine.beam_chunk = BEAM_CHUNK
    try:
        chunked = decode(opts)
        torch.cuda.synchronize()
    finally:
        engine.beam_chunk = saved
    t2 = time.monotonic()
    for a, b in zip(mono, chunked):
        check(list(a.tokens) == list(b.tokens) and a.avg_logprob == b.avg_logprob,
              "the chunked beam differs from the monolithic beam")
    log(f"chunked beam (segments of {BEAM_CHUNK} steps) token-exact against the monolithic "
        f"beam; decode {t2 - t1:.6g} s chunked, {t1 - t0:.6g} s monolithic (host clock)")
    return launches


def pool_beam_profile(engine: WhisperEngine) -> None:
    """Launches and device time per step of a beam pool of 2 slots x 5
    lanes, both slots decoding, and the self-KV gather's share."""
    cb = ContinuousEngine(engine, n_slots=2, beam_width=BEAM, steps_per_chunk=8, cross_ctx=640,
                          enc_buckets=(512, 1500))
    cb.init_state()
    prompt, sot = engine.build_prompt(beam_options(), language="en")
    windows = np.zeros((2, 480000), np.float32)
    for i in range(2):
        windows[i, :96000] = speech_like(6.0, 60 + i)
    cb.insert(windows, [prompt] * 2, [sot] * 2, [True] * 2, [0, 1], [0.0] * 2, [True] * 2,
              [1.0] * 2, [cb.ring - 1] * 2, enc_ctx=512)
    cb.step()
    before = dict(_kernels.launches)
    long = cuda_profile(cb.step)  # one chunk
    per_step = {k: (_kernels.launches[k] - before[k]) / cb.steps_per_chunk
                for k in BEAM_PATH[1:] + ("cross_attention_int8_skip",)}
    log(f"beam pool launches per step (2 slots x {BEAM} lanes): K2 {per_step['int8_matmul']:.6g}, "
        f"K3 {per_step['int8_matmul_t']:.6g}, K4 {per_step['cross_attention_int8']:.6g}, "
        f"K5 {per_step['cross_attention_int8_skip']:.6g}")
    n_layer = engine.cfg.n_text_layer
    check(per_step == {"int8_matmul": 8 * n_layer, "int8_matmul_t": 1,
                       "cross_attention_int8": n_layer, "cross_attention_int8_skip": 0},
          f"beam pool step launches {per_step}")
    log_step_profile("beam pool profile", engine, long, ([], 0.0, 0), cb.steps_per_chunk,
                     cb.n_rows, cb.cache_len)


def beam_pool_phase(engine: WhisperEngine) -> dict:
    """--beam_size 5 --beam_mode full: the continuous pool of 2 slots x 5
    lanes serving one session; its steps run K4 with lengths, never K5."""
    cs = ContinuousScheduler(engine, n_slots=2, beam_width=BEAM, steps_per_chunk=8,
                             cross_ctx=640, enc_buckets=(512, 1500))
    window = BatchScheduler(engine, max_batch_size=BATCH, batch_window_ms=50)
    window.start()
    cs.start()
    try:
        backend = CountingBackend(window, model_name=MODEL, continuous_scheduler=cs,
                                  beam_size=BEAM)
        routed = []
        pick = backend._pick_scheduler
        backend._pick_scheduler = lambda *a, **kw: routed.append(pick(*a, **kw)) or routed[-1]
        sessions = [dict(uid="beam-pool", language="en", audio=speech_like(CONT_SESSION_S, 62))]
        sockets, wall = serve(backend, sessions)
    finally:
        cs.stop()
        window.stop()
    launches = dict(_kernels.launches)
    check_calls(backend, ["beam-pool"], 2)
    check(all(s is cs for s in routed), "a beamed request went to the window path")
    steps = cs.cb.gstep
    log(f"beam pool sessions: {wall:.6g} s wall, {len(backend.calls)} backend calls, "
        f"{cs.tick_stats['ticks']} chunks, {steps} steps, mean step "
        f"{cs.tick_stats['step_s'] / max(steps, 1) * 1e3:.6g} ms (host clock)")
    check_path("beam pool", launches, BEAM_PATH, absent=("cross_attention_int8_skip",))
    # and once a layer in each insert wave's language-ID prefill (one token)
    waves = cs.tick_stats["insert_calls"]
    check(steps > 0 and launches["cross_attention_int8"] == (steps + waves) * engine.cfg.n_text_layer,
          "the beam pool's K4 must launch once per decoder layer per step and per insert wave")
    check_sockets(sockets)
    pool_beam_profile(engine)
    return launches


def hybrid_phase(engine: WhisperEngine) -> dict:
    """--beam_size 5 --beam_mode refresh: greedy incremental partials on the
    continuous pool (K5), beamed full re-decodes on the window scheduler in
    preemptible segments (K4): one session, whose commits may move its
    anchor on every call, then three calls of a stream whose anchor stays
    put (a full re-decode, then two partials extending its hypothesis)."""
    saved = engine.beam_chunk
    cs = ContinuousScheduler(engine, n_slots=CONT_SLOTS, steps_per_chunk=8, cross_ctx=640,
                             enc_buckets=(512, 1500))
    window = BatchScheduler(engine, max_batch_size=BATCH, batch_window_ms=50)
    window.start()
    cs.start()
    try:
        backend = CountingBackend(window, model_name=MODEL, continuous_scheduler=cs,
                                  beam_size=BEAM, beam_mode="refresh")
        check(backend.hybrid_beam and engine.beam_chunk > 0, "hybrid beam not enabled")
        sessions = [dict(uid="hybrid", language="en", audio=speech_like(CONT_SESSION_S, 63))]
        sockets, wall = serve(backend, sessions)
        stream = speech_like(6.0, 66)
        opts = SessionOptions(language="en", use_vad=False)
        for seconds in (4.0, 5.0, 6.0):
            asyncio.run(backend.transcribe(stream[: int(16000 * seconds)], opts, language="en",
                                           uid="hybrid-stream", window_anchor_s=0.0))
        torch.cuda.synchronize()
    finally:
        cs.stop()
        window.stop()
        engine.beam_chunk = saved
    launches = dict(_kernels.launches)
    check_calls(backend, ["hybrid", "hybrid-stream"], 4)
    log(f"hybrid beam sessions: {wall:.6g} s wall, {len(backend.calls)} backend calls, "
        f"{backend.hybrid_stats}")
    check(backend.hybrid_stats["beamed_fulls"] > 0 and backend.hybrid_stats["greedy_partials"] > 0,
          f"hybrid routes {backend.hybrid_stats}: a beamed full and a greedy partial expected")
    check_path("hybrid beam route", launches, BEAM_PATH + ("cross_attention_int8_skip",))
    check_sockets(sockets)
    return launches


def check_words(label: str, backend) -> int:
    """Every word of every result: start <= end, inside the window, and
    starts and ends non-decreasing. Returns the number of words."""
    n = 0
    for c in backend.calls:
        words = [w for g in c["result"].segments for w in (g.words or [])]
        check(all(g.words is not None for g in c["result"].segments),
              f"{label}: a segment without word timings")
        for a, b in zip(words, words[1:]):
            check(a.start <= b.start and a.end <= b.end, f"{label}: words out of order")
        for w in words:
            check(0.0 <= w.start <= w.end <= c["result"].duration + 1e-6,
                  f"{label}: word {w} outside its {c['result'].duration} s window")
        n += len(words)
    check(n > 0, f"{label}: no word timings")
    return n


def time_align_pass(engine: WhisperEngine, cross: dict, ctx: int, reps: int = 5) -> None:
    """The alignment pass of a 40-token hypothesis (prompt bucket 64) of an
    8 s window against `ctx` cross-KV positions, and the copy of its cut
    maps to the host, each the median of reps runs on the host clock."""
    text = [1000 + i for i in range(40)]
    arr, sot_len, _ = engine.align_prepare(text)
    seq_len, frames = sot_len + len(text) + 1, 400
    sub = engine.gather_cross(cross, [0])
    if ctx < engine.cfg.n_audio_ctx:
        sub = {k: None if v is None else (v[..., :ctx, :].contiguous() if k in ("kv8", "kv4")
                                          else v) for k, v in sub.items()}
    clen = torch.tensor([ctx], dtype=torch.int32, device=engine.device)
    passes, copies = [], []
    before = dict(_kernels.launches)
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with torch.inference_mode():
            logits, maps = wmod.decode_with_cross_attn(engine.params, engine.cfg,
                                                       engine._tensor(arr), sub, cross_len=clen)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        host = maps[:, :, :, :seq_len, :frames].float().cpu().numpy()
        logits[:, :seq_len].cpu()
        t2 = time.monotonic()
        passes.append(t1 - t0)
        copies.append(t2 - t1)
    per_pass = {k: (_kernels.launches[k] - before[k]) / reps for k in before
                if _kernels.launches[k] > before[k]}
    log(f"align pass at {ctx} positions (T = {arr.shape[1]}): "
        f"{statistics.median(passes) * 1e3:.6g} ms (the first of {reps}: "
        f"{passes[0] * 1e3:.6g} ms), the maps' copy "
        f"{statistics.median(copies) * 1e3:.6g} ms for {host.nbytes / 1e6:.6g} MB "
        f"(cut on the card from {maps.numel() * maps.element_size() / 1e6:.6g} MB); "
        f"launches per pass {per_pass}")
    check("cross_attention_int8" not in per_pass and per_pass.get("int8_matmul", 0) > 0,
          f"the align pass must run K2 and no cross-attention kernel: {per_pass}")


def word_ts_phase(engine: WhisperEngine) -> dict:
    """One word-timestamp session on the continuous route (alignment at
    harvest against the slot's cross-KV) and one on the window route
    (alignment at resolve), then the alignment pass's time and its copy."""
    _kernels.reset_launches()
    cs = ContinuousScheduler(engine, n_slots=CONT_SLOTS, steps_per_chunk=8, cross_ctx=640,
                             enc_buckets=(512, 1500))
    launches = {}
    for route in ("continuous", "window"):
        window = BatchScheduler(engine, max_batch_size=BATCH, batch_window_ms=50)
        window.start()
        pool = cs if route == "continuous" else None
        if pool is not None:
            pool.start()
        try:
            backend = CountingBackend(window, model_name=MODEL, continuous_scheduler=pool)
            sessions = [dict(uid=f"words-{route}", language="en", word_timestamps=True,
                             audio=speech_like(WINDOW_SESSION_S, 64))]
            sockets, wall = serve(backend, sessions)
        finally:
            if pool is not None:
                pool.stop()
            window.stop()
        launches[route] = dict(_kernels.launches)
        check_calls(backend, [s["uid"] for s in sessions], 2)
        n = check_words(f"word timestamps ({route} route)", backend)
        log(f"word timestamps ({route} route): {wall:.6g} s wall, {len(backend.calls)} calls, "
            f"{n} words")
        check(any("words" in g for m in sockets[0].sent for g in m.get("segments", [])),
              f"word timestamps ({route} route): no word reached the client")
        check_path(f"word timestamps ({route} route)", launches[route],
                   CONTINUOUS_PATH if route == "continuous" else WINDOW_PATH)
    audio = np.zeros((1, 480000), np.float32)
    audio[0, :128000] = speech_like(8.0, 65)
    with torch.inference_mode():
        _, cross = engine.prepare(audio)
    for ctx in (engine.cfg.n_audio_ctx, 640):
        time_align_pass(engine, cross, ctx)
    return launches


# ---------------------------------------------------------------------------
# Phase 8: the offline file path
# ---------------------------------------------------------------------------

OFFLINE_FILES_S = (70.0, 12.0)  # three seek windows, and one
# tokens a seek window, cut for the script's time limit (the seek windows'
# host time is their decode steps)
OFFLINE_MAX_NEW = 24
OFFLINE_SHARDS = 2


def hf_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """The port's parameter tree under the names of transformers'
    WhisperForConditionalGeneration: the inverse of models/convert.py.
    Linear weights go from [d_in, d_out] to HF's [out, in]; conv weights are
    torch's [out, in, k] in both; every leaf keeps its dtype."""
    sd: dict[str, torch.Tensor] = {}

    def linear(name, p, i):
        sd[f"{name}.weight"] = p["w"][i].T.contiguous()
        if "b" in p:
            sd[f"{name}.bias"] = p["b"][i]

    def norm(name, p, i=None):
        sd[f"{name}.weight"] = p["scale"] if i is None else p["scale"][i]
        sd[f"{name}.bias"] = p["bias"] if i is None else p["bias"][i]

    def blocks(prefix, p, cross):
        attns = (("attn", "self_attn"),) + ((("cross_attn", "encoder_attn"),) if cross else ())
        for i in range(p["mlp"]["fc1"]["w"].shape[0]):
            name = f"{prefix}.layers.{i}"
            for ours, hf in attns:
                for k, proj in zip("qkvo", ("q_proj", "k_proj", "v_proj", "out_proj")):
                    linear(f"{name}.{hf}.{proj}", p[ours][k], i)
                norm(f"{name}.{hf}_layer_norm", p[f"{ours}_ln"], i)
            linear(f"{name}.fc1", p["mlp"]["fc1"], i)
            linear(f"{name}.fc2", p["mlp"]["fc2"], i)
            norm(f"{name}.final_layer_norm", p["mlp_ln"], i)

    enc, dec_p = params["encoder"], params["decoder"]
    for conv in ("conv1", "conv2"):
        sd[f"model.encoder.{conv}.weight"] = enc[conv]["w"]
        sd[f"model.encoder.{conv}.bias"] = enc[conv]["b"]
    sd["model.encoder.embed_positions.weight"] = enc["pos"]
    blocks("model.encoder", enc["layers"], cross=False)
    norm("model.encoder.layer_norm", enc["ln_post"])
    sd["model.decoder.embed_tokens.weight"] = dec_p["embed"]
    sd["model.decoder.embed_positions.weight"] = dec_p["pos"]
    blocks("model.decoder", dec_p["layers"], cross=True)
    norm("model.decoder.layer_norm", dec_p["ln"])
    return sd


def write_hf_checkpoint(params: dict, cfg: wmod.WhisperConfig, path: str,
                        n_shards: int = 1) -> None:
    """An HF Whisper checkpoint directory of the tree: config.json and the
    state dict as model.safetensors, or as `n_shards` shards of about equal
    bytes with model.safetensors.index.json."""
    from whisperlive_tpu_torch.models import safetensors_io

    os.makedirs(path, exist_ok=True)
    hf_cfg = dict(model_type="whisper", architectures=["WhisperForConditionalGeneration"],
                  num_mel_bins=cfg.n_mels, vocab_size=cfg.n_vocab,
                  max_source_positions=cfg.n_audio_ctx, d_model=cfg.n_audio_state,
                  encoder_attention_heads=cfg.n_audio_head, encoder_layers=cfg.n_audio_layer,
                  encoder_ffn_dim=4 * cfg.n_audio_state, max_target_positions=cfg.n_text_ctx,
                  decoder_attention_heads=cfg.n_text_head, decoder_layers=cfg.n_text_layer,
                  decoder_ffn_dim=4 * cfg.n_text_state)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    sd = hf_state_dict(params)
    if n_shards == 1:
        safetensors_io.save_file(sd, os.path.join(path, "model.safetensors"),
                                 metadata={"format": "pt"})
        return
    names = sorted(sd)
    sizes = [sd[n].numel() * sd[n].element_size() for n in names]
    total, filled, weight_map = sum(sizes), 0, {}
    for name, size in zip(names, sizes):
        shard = min(filled * n_shards // total, n_shards - 1)
        weight_map[name] = f"model-{shard + 1:05d}-of-{n_shards:05d}.safetensors"
        filled += size
    for file in sorted(set(weight_map.values())):
        safetensors_io.save_file({n: sd[n] for n in names if weight_map[n] == file},
                                 os.path.join(path, file), metadata={"format": "pt"})
    with open(os.path.join(path, safetensors_io.INDEX_FILE), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)


def check_same_tree(label: str, src: dict, loaded: dict) -> int:
    """Every leaf of `loaded` bit-equal to `src`'s at the same path, in the
    same dtype and shape. Returns the number of leaves."""
    from whisperlive_tpu_torch.models.safetensors_io import flatten_tree

    a, b = flatten_tree(src), flatten_tree(loaded)
    check(a.keys() == b.keys(), f"{label}: leaves {sorted(set(a) ^ set(b))} differ")
    for path, x in a.items():
        y = b[path]
        check(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y.to(x.device)),
              f"{label}: leaf {path} differs")
    return len(a)


# How far a segment's first word may start before it, and its last word end
# after it: where a segment edge sits deep inside its edge word, the
# boundary rules (_reconcile_segment_edges) clamp the word toward the edge
# but keep it a median word long, and the median is capped at 0.7 s; plus
# the 0.01 s of the words' rounding
EDGE_WORD_SLACK_S = 0.71


def check_offline_words(label: str, segments: list[dict]) -> int:
    """Word timings of a file's JSON segments: every word has start <= end,
    starts are non-decreasing over the file, and each word lies in its
    segment: inside it, except that the first word may start and the last
    end up to EDGE_WORD_SLACK_S beyond the segment's edge. Returns the
    number of words."""
    words = [w for g in segments for w in g.get("words", [])]
    check(bool(words) and all(w["start"] <= w["end"] for w in words)
          and all(a["start"] <= b["start"] for a, b in zip(words, words[1:])),
          f"offline {label}: words out of order")
    for g in segments:
        ws = g.get("words", [])
        lo = [g["start"]] * len(ws)
        hi = [g["end"]] * len(ws)
        if ws:
            lo[0] -= EDGE_WORD_SLACK_S
            hi[-1] += EDGE_WORD_SLACK_S
        check(all(a <= w["start"] and w["end"] <= b for w, a, b in zip(ws, lo, hi)),
              f"offline {label}: a word outside its segment {g['start']}..{g['end']}: "
              f"{[(w['start'], w['end']) for w in ws]}")
    return len(words)


def offline_options(**kw) -> TranscribeOptions:
    """The options `cli.transcribe --no_gates --language en --max_new_tokens
    OFFLINE_MAX_NEW` builds."""
    return TranscribeOptions(language="en", temperatures=(0.0,), log_prob_threshold=None,
                             compression_ratio_threshold=None, no_speech_threshold=None,
                             max_new_tokens=OFFLINE_MAX_NEW, **kw)


def offline_window_launches(windows: list[dict]) -> list[dict]:
    """Each seek window's launches must be K1 32 (the encode), and per decode
    step K2 256, K3 1 and K4 32, plus the prefill's K2 256 and K3 2 (last and
    <|sot|> logits) and, where the window has text, the alignment pass's
    K2 256 and K3 1; no other kernel. Returns the per-window summary."""
    out = []
    for i, w in enumerate(windows):
        d = w["launches"]
        steps, rest = divmod(d["cross_attention_int8"], 32)
        passes, k2_rest = divmod(d["int8_matmul"], 256)
        aligns = passes - steps - 1
        others = {k: v for k, v in d.items() if v and k not in WINDOW_PATH}
        log(f"offline window {i} ({w['file']}): {w['seconds']:.6g} s, "
            f"{steps} decode steps, {aligns} alignment passes, launches {d}")
        check(d["fused_attention"] == 32, f"offline window {i}: K1 {d['fused_attention']}, "
              "not 32")
        check(rest == 0 and k2_rest == 0 and aligns in (0, 1)
              and d["int8_matmul_t"] == steps + 2 + aligns and not others,
              f"offline window {i}: launches {d} are not K2 256, K3 1, K4 32 a step")
        out.append(dict(file=w["file"], seconds=w["seconds"], steps=steps,
                        align_passes=aligns, launches=d))
    return out


def log_mel_full_f32(audio: np.ndarray, n_mels: int) -> np.ndarray:
    """The plain version of log_mel_full in the reference's float32
    arithmetic, on the CPU through torch.stft (the port takes the power and
    the mel projection in float64): HOP_LENGTH zero samples appended, a
    centered reflect-padded periodic-Hann STFT, the last frame dropped, the
    max - 8 clamp over the whole clip."""
    from whisperlive_tpu_torch.ops.mel import HOP_LENGTH, N_FFT, mel_filter_bank

    x = torch.from_numpy(np.pad(np.asarray(audio, np.float32), (0, HOP_LENGTH)))
    spec = torch.stft(x, N_FFT, HOP_LENGTH, window=torch.hann_window(N_FFT), center=True,
                      pad_mode="reflect", return_complex=True)[:, :-1]
    mel = torch.from_numpy(mel_filter_bank(n_mels=n_mels)).T @ spec.abs().square()
    log_spec = torch.log10(mel.clamp(min=1e-10)).T.numpy()
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def offline_phase(engine: WhisperEngine) -> dict:
    """Write the engine's source parameters as a sharded HF checkpoint,
    convert it with the port's CLI, load both dirs bit-equal, then drive the
    offline CLI (sequential, with word timestamps, and --batched) on two
    WAVs and hold it against the in-memory engine; then the VAD filter,
    language detection and log_mel_full on the card."""
    import gc
    import shutil
    import tempfile

    from whisperlive_tpu_torch import loader
    from whisperlive_tpu_torch.audio import io as audio_io
    from whisperlive_tpu_torch.audio.vad import VadOptions, get_speech_timestamps
    from whisperlive_tpu_torch.cli import convert as convert_cli
    from whisperlive_tpu_torch.cli import transcribe as transcribe_cli
    from whisperlive_tpu_torch.engine import transcribe as tr
    from whisperlive_tpu_torch.ops.mel import log_mel_full

    cfg, dev = wmod.WHISPER_CONFIGS[MODEL], engine.device
    tmp = tempfile.mkdtemp(prefix="chip_smoke_offline_")
    hf_dir, conv_dir = os.path.join(tmp, "hf"), os.path.join(tmp, "converted")
    report: dict = {}
    resolve_model, load_audio = loader.resolve_model, audio_io.load_audio
    prepare_mel, prepare = WhisperEngine.prepare_mel, WhisperEngine.prepare
    try:
        # 1. the checkpoint round trip: the engine was built from this seed
        src = wmod.init_params(cfg, SEED, torch.bfloat16, dev)
        t0 = time.monotonic()
        write_hf_checkpoint(src, cfg, hf_dir, n_shards=OFFLINE_SHARDS)
        report["write_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        convert_cli.main([hf_dir, "-o", conv_dir])
        report["convert_s"] = time.monotonic() - t0
        for label, path in (("hf", hf_dir), ("converted", conv_dir)):
            t0 = time.monotonic()
            _, tree, tok = loader.resolve_model(MODEL, path, device=dev)
            report[f"load_{label}_s"] = time.monotonic() - t0
            n = check_same_tree(f"checkpoint ({label} dir)", src, tree)
            check(tok is None, f"{label} dir: a tokenizer without tokenizer.json")
            del tree
        gb = sum(os.path.getsize(os.path.join(d, f)) for d in (hf_dir, conv_dir)
                 for f in os.listdir(d)) / 2 / 1e9
        log(f"offline checkpoint: {n} leaves bit-equal through the HF dir ({OFFLINE_SHARDS} "
            f"shards) and the converted dir, {gb:.6g} GB each; write {report['write_s']:.6g} s, "
            f"convert {report['convert_s']:.6g} s, load {report['load_hf_s']:.6g} s (HF) and "
            f"{report['load_converted_s']:.6g} s (converted)")
        del src

        # 2. the CLI on two WAVs against the in-memory engine; the CLI's
        # engine gets the visible tokenizer (the repository has no BPE
        # vocabulary, and the loader finds no tokenizer.json)
        def visible(*args, **kw):
            c, p, t = resolve_model(*args, **kw)
            return c, p, t or VisibleTokenizer(TokenSpec(c.n_vocab, multilingual=True))

        windows: list[dict] = []
        current = {}

        def close_window():
            if windows and "seconds" not in windows[-1]:
                w = windows[-1]
                w["seconds"] = time.monotonic() - w["t0"]
                w["launches"] = {k: v - w["before"][k] for k, v in _kernels.launches.items()}

        def recorded_prepare_mel(self, melspec):
            close_window()
            windows.append(dict(file=current.get("file"), t0=time.monotonic(),
                                before=dict(_kernels.launches)))
            return prepare_mel(self, melspec)

        wavs = []
        for j, seconds in enumerate(OFFLINE_FILES_S):
            path = os.path.join(tmp, f"speech{j}.wav")
            audio_io.write_wav(path, speech_like(seconds, 80 + j))
            wavs.append(path)
        out_dir = os.path.join(tmp, "out")
        argv = [*wavs, "--model", MODEL, "-tpu", conv_dir, "--no_gates", "--language", "en",
                "--max_new_tokens", str(OFFLINE_MAX_NEW), "--word_timestamps", "-f", "json",
                "-o", out_dir, "--device", str(dev)]

        def traced_load(path, *a, **kw):
            close_window()
            current["file"] = os.path.basename(path)
            return load_audio(path, *a, **kw)

        loader.resolve_model = visible
        WhisperEngine.prepare_mel = recorded_prepare_mel
        audio_io.load_audio = traced_load
        _kernels.reset_launches()
        t0 = time.monotonic()
        rc = transcribe_cli.main(argv)
        report["cli_s"] = time.monotonic() - t0
        close_window()
        WhisperEngine.prepare_mel = prepare_mel
        audio_io.load_audio = load_audio
        check(rc == 0, f"offline CLI exit code {rc}")
        gc.collect()
        torch.cuda.empty_cache()

        n_words = 0
        for path, seconds in zip(wavs, OFFLINE_FILES_S):
            stem = os.path.splitext(os.path.basename(path))[0]
            with open(os.path.join(out_dir, f"{stem}.json")) as f:
                got = json.load(f)
            segs, info = tr.Transcriber(engine).transcribe(
                load_audio(path), offline_options(word_timestamps=True))
            want = [(s.text, s.start, s.end) for s in segs]
            check([(g["text"], g["start"], g["end"]) for g in got["segments"]] == want,
                  f"offline CLI on {stem}: segments differ from the in-memory engine's")
            check(bool(want) and got["duration"] == info.duration,
                  f"offline CLI on {stem}: no segments, or another duration")
            for s, g in zip(segs, got["segments"]):
                check([(w["word"], w["start"], w["end"]) for w in g.get("words", [])]
                      == [(w.word, w.start, w.end) for w in s.words or []],
                      f"offline CLI on {stem}: words differ from the in-memory engine's")
            n_words += check_offline_words(stem, got["segments"])
            log(f"offline CLI {stem} ({seconds:.6g} s): {len(want)} segments token-exact "
                f"against the in-memory engine, {sum(len(s.words or []) for s in segs)} words")
        per_window = offline_window_launches(windows)
        steps = sum(w["steps"] for w in per_window)
        report.update(
            windows=len(per_window), words=n_words, decode_steps=steps,
            windows_per_file=[sum(w["file"] == os.path.basename(p) for w in per_window)
                              for p in wavs],
            steps_per_window=[w["steps"] for w in per_window],
            window_s=[w["seconds"] for w in per_window],
            window_s_median=statistics.median(w["seconds"] for w in per_window),
            launches_per_window=[w["launches"] for w in per_window])
        log(f"offline CLI: {report['cli_s']:.6g} s for {sum(OFFLINE_FILES_S):.6g} s of audio "
            f"in {len(per_window)} seek windows (engine load included), host time a window "
            f"median {report['window_s_median']:.6g} s, {steps} decode steps")

        # 3. --batched over the same files: one result each, held
        # structurally (the batch pads to a bucket: other GEMM shapes)
        batches = []

        def recorded_prepare(self, audio):
            batches.append(audio.shape[0])
            return prepare(self, audio)

        WhisperEngine.prepare = recorded_prepare
        out_b = os.path.join(tmp, "batched")
        argv_b = [a if a != out_dir else out_b for a in argv] + ["--batched"]
        t0 = time.monotonic()
        rc = transcribe_cli.main(argv_b)
        report["batched_s"] = time.monotonic() - t0
        WhisperEngine.prepare = prepare
        check(rc == 0 and batches, f"offline --batched: exit code {rc}, {len(batches)} batches")
        for path, seconds in zip(wavs, OFFLINE_FILES_S):
            stem = os.path.splitext(os.path.basename(path))[0]
            with open(os.path.join(out_b, f"{stem}.json")) as f:
                segs = json.load(f)["segments"]
            check(bool(segs) and all(a["start"] <= b["start"] for a, b in zip(segs, segs[1:]))
                  and all(0 <= g["start"] <= g["end"] for g in segs)
                  and segs[0]["start"] < seconds,
                  f"offline --batched {stem}: segments out of order or outside the file")
            check_offline_words(f"--batched {stem}", segs)
            past = sum(g["end"] > seconds for g in segs)
            log(f"offline --batched {stem}: {len(segs)} segments, {past} ending past the "
                f"file's {seconds:.6g} s (random weights' timestamps)")
        report["batches"] = batches
        report["batch_s"] = report["batched_s"] / len(batches)
        log(f"offline --batched: {report['batched_s']:.6g} s (engine load included), "
            f"{len(batches)} batches {batches}, {report['batch_s']:.6g} s a batch")
        gc.collect()
        torch.cuda.empty_cache()

        # 4. the VAD filter and language detection on the in-memory engine
        audio = np.concatenate([speech_like(8.0, 90), np.zeros(160000, np.float32),
                                speech_like(8.0, 91)])
        t0 = time.monotonic()
        segs, _ = tr.Transcriber(engine).transcribe(audio, offline_options(),
                                                    vad_filter=True)
        report["vad_s"] = time.monotonic() - t0
        chunks = get_speech_timestamps(audio, VadOptions())
        gap = (chunks[0]["end"] / 16000, chunks[-1]["start"] / 16000)
        check(len(chunks) >= 2 and bool(segs)
              and not any(gap[0] < s.start < gap[1] for s in segs),
              f"offline VAD: {len(chunks)} speech chunks, a segment starts in the gap {gap}")
        t0 = time.monotonic()
        lang, prob, probs = tr.Transcriber(engine).detect_language(
            speech_like(45.0, 92), language_detection_segments=2)
        report["detect_s"] = time.monotonic() - t0
        total = sum(p for _, p in probs)
        check(lang in engine.tokenizer.spec.language_codes and abs(total - 1.0) <= 1e-3,
              f"offline language detection: {lang!r}, probabilities sum to {total}")
        log(f"offline VAD: {len(segs)} segments, none in the removed gap {gap} s, "
            f"{report['vad_s']:.6g} s; language detection over 2 windows: {lang} "
            f"p={prob:.6g}, sum {total:.6g}, {report['detect_s']:.6g} s")

        # 5. log_mel_full on the card against the CPU
        clip = load_audio(wavs[0])
        t0 = time.monotonic()
        on_card = log_mel_full(clip, n_mels=cfg.n_mels, device=dev)
        report["mel_s"] = time.monotonic() - t0
        err = float(np.abs(on_card - log_mel_full(clip, n_mels=cfg.n_mels, device="cpu")).max())
        check(err <= 1e-4, f"log_mel_full on the card: max abs err {err} > 1e-4")
        err32 = float(np.abs(on_card - log_mel_full_f32(clip, cfg.n_mels)).max())
        check(err32 <= 1e-4, f"log_mel_full on the card: max abs err {err32} > 1e-4 from the "
              "float32 STFT on the CPU")
        report["mel_max_abs_err"], report["mel_max_abs_err_f32"] = err, err32
        log(f"offline log_mel_full [{on_card.shape[0]}, {on_card.shape[1]}] on the card: "
            f"{report['mel_s']:.6g} s, max abs err vs the CPU {err:.6g}, vs the float32 "
            f"STFT on the CPU {err32:.6g}")
    finally:
        loader.resolve_model = resolve_model
        WhisperEngine.prepare_mel, WhisperEngine.prepare = prepare_mel, prepare
        audio_io.load_audio = load_audio
        shutil.rmtree(tmp, ignore_errors=True)
    return report


# ---------------------------------------------------------------------------
# Phase 9: output against the plain versions
# ---------------------------------------------------------------------------


PLAIN = {
    "fused_attention": attn_ops.fused_attention_ref,
    "int8_matmul": qmm.int8_matmul_ref,
    "int8_matmul_t": qmm.int8_matmul_t_ref,
    "cross_attention_int8": lambda q, kvp, lengths=None, active=None: (
        attn_ops.cross_attention_int8_ref(q, kvp, lengths) if active is None
        else attn_ops.cross_attention_int8_skip_ref(q, kvp, lengths, active)),
    "cross_attention_int8_window": lambda q, kvp, lengths=None, active=None: (
        attn_ops.cross_attention_int8_window_ref(q, kvp, lengths) if active is None
        else attn_ops.cross_attention_int8_skip_window_ref(q, kvp, lengths, active)),
    "cross_attention_int4": attn_ops.cross_attention_int4_ref,
    "cross_attention_int4_window": attn_ops.cross_attention_int4_window_ref,
}


def plain_run(fn):
    """fn() with every kernel wrapper that models/whisper.py calls swapped
    for its plain version; no kernel may launch."""
    saved = {name: getattr(wmod, name) for name in PLAIN}
    try:
        for name, plain in PLAIN.items():
            setattr(wmod, name, plain)
        before = dict(_kernels.launches)
        out = fn()
        check(_kernels.launches == before, "the plain run launched a kernel")
        return out
    finally:
        for name, kernel in saved.items():
            setattr(wmod, name, kernel)


def compare_logits(label, a, b, rel_tol, shape, errs=None):
    """Max error within rel_tol of max|b|. Returns whether the argmax agrees
    on every row up to ties: a row whose two argmaxes differ must have them
    within 2 x max_abs_err of each other in b (random weights give flat
    logits, and bf16 rounding then decides such a near-tie either way).
    Appends the error over max|b| to `errs` when given."""
    check(a.shape == shape and a.dtype == torch.float32, f"{label}: logits {a.shape}")
    err = (a - b).abs().max().item()
    scale = b.abs().max().item()
    ka, kb = a.argmax(-1), b.argmax(-1)
    rows = torch.nonzero(ka != kb).flatten()
    gaps = (b[rows, kb[rows]] - b[rows, ka[rows]]).tolist()
    log(f"reference: {label} max_abs_err={err:.6g} tol={rel_tol * scale:.6g} "
        f"argmax equal on {shape[0] - len(gaps)}/{shape[0]} rows"
        + (f"; rows {rows.tolist()} differ by plain-logit gaps {gaps} "
           f"(ties: <= {2 * err:.6g})" if gaps else ""))
    check(bool(torch.isfinite(a).all()) and err <= rel_tol * scale, f"{label} disagrees")
    if errs is not None:
        errs.append(err / scale)
    return all(g <= 2 * err for g in gaps)


def window_reference(engine: WhisperEngine, steps: int = 4, rel_tol: float = 5e-2) -> float:
    """Encoder states and teacher-forced logits of the kernel path against
    the plain path. Returns the largest error over max|ref| of the states
    and of each step's logits."""
    cfg, dev = engine.cfg, engine.device
    audio = np.zeros((2, 480000), np.float32)
    audio[0, :128000] = speech_like(8.0, 3)
    audio[1, :64000] = speech_like(4.0, 4)
    prompt, _ = engine.build_prompt(
        backends_mod.transcribe_options_from_session(SessionOptions(language="en")))
    prompts = torch.tensor([prompt, prompt], dtype=torch.int32, device=dev)
    plen = torch.full((2,), len(prompt), dtype=torch.int32, device=dev)

    def run(tokens=None):
        with torch.inference_mode():
            enc, cross = engine.prepare(audio)
            self_kv = wmod.init_self_kv(cfg, 2, len(prompt) + steps, device=dev)
            logits = [wmod.decode_prefill(engine.params, cfg, prompts, plen, self_kv, cross)]
            forced = tokens if tokens is not None else []
            for i in range(steps):  # greedy on the kernel path, forced on both
                if tokens is None:
                    forced.append(logits[-1].argmax(-1).to(torch.int32))
                logits.append(wmod.decode_step(engine.params, cfg, forced[i], plen + i,
                                               len(prompt) + i, plen, len(prompt), self_kv,
                                               cross))
            return enc, logits, forced

    enc_k, logits_k, tokens = run()
    enc_r, logits_r, _ = plain_run(lambda: run(tokens))
    check(enc_k.shape == (2, cfg.n_audio_ctx, cfg.n_audio_state), f"encoder {enc_k.shape}")
    err = (enc_k.float() - enc_r.float()).abs().max().item()
    scale = enc_r.float().abs().max().item()
    log(f"reference: encoder states max_abs_err={err:.6g} tol={rel_tol * scale:.6g}")
    check(bool(torch.isfinite(enc_k.float()).all()) and err <= rel_tol * scale,
          "encoder states disagree with the plain path")
    errs = [err / scale]
    for i, (a, b) in enumerate(zip(logits_k, logits_r)):
        compare_logits(f"window logits step {i}", a, b, rel_tol, (2, cfg.n_vocab), errs)
    return max(errs)


def distill_reference(engine: WhisperEngine, steps: int = 4, rel_tol: float = 5e-2) -> None:
    """The distiller's pseudo-labelling shapes on the kernel path against
    the plain path: a batch of DISTILL_BATCH clips encoded at DISTILL_CTX
    positions through cli.distill.encode_at (K1 at T = 512), its int8
    cross-KV, and teacher-forced logits of the prefill and `steps` greedy
    steps (K2, K3, and K4 at kvp [8, H, 512, 128])."""
    from whisperlive_tpu_torch.cli.distill import encode_at

    cfg, dev = engine.cfg, engine.device
    b = DISTILL_BATCH
    audio = np.zeros((b, 480000), np.float32)
    for i in range(b):
        n = 16000 * (4 + i)
        audio[i, :n] = speech_like(n / 16000, 70 + i)
    prompt, _ = engine.build_prompt(
        backends_mod.transcribe_options_from_session(SessionOptions(language="en")))
    prompts = torch.tensor([prompt] * b, dtype=torch.int32, device=dev)
    plen = torch.full((b,), len(prompt), dtype=torch.int32, device=dev)

    def run(tokens=None):
        with torch.inference_mode():
            enc = encode_at(engine.params, cfg, audio, DISTILL_CTX, dev)
            cross = engine.quantize_cross(wmod.compute_cross_kv(engine.params, cfg, enc))
            self_kv = wmod.init_self_kv(cfg, b, len(prompt) + steps, device=dev)
            logits = [wmod.decode_prefill(engine.params, cfg, prompts, plen, self_kv, cross)]
            forced = tokens if tokens is not None else []
            for i in range(steps):  # greedy on the kernel path, forced on both
                if tokens is None:
                    forced.append(logits[-1].argmax(-1).to(torch.int32))
                logits.append(wmod.decode_step(engine.params, cfg, forced[i], plen + i,
                                               len(prompt) + i, plen, len(prompt), self_kv,
                                               cross))
            return enc, logits, forced

    before = dict(_kernels.launches)
    enc_k, logits_k, tokens = run()
    check_path("distiller reference", {k: n - before[k] for k, n in _kernels.launches.items()},
               WINDOW_PATH)
    enc_r, logits_r, _ = plain_run(lambda: run(tokens))
    check(enc_k.shape == (b, DISTILL_CTX, cfg.n_audio_state), f"encoder {enc_k.shape}")
    err = (enc_k.float() - enc_r.float()).abs().max().item()
    scale = enc_r.float().abs().max().item()
    log(f"reference: distiller encoder states [{b}, {DISTILL_CTX}] max_abs_err={err:.6g} "
        f"tol={rel_tol * scale:.6g}")
    check(bool(torch.isfinite(enc_k.float()).all()) and err <= rel_tol * scale,
          "distiller: encoder states disagree with the plain path")
    for i, (a, r) in enumerate(zip(logits_k, logits_r)):
        compare_logits(f"distiller logits [{b}] step {i}", a, r, rel_tol, (b, cfg.n_vocab))


def offline_reference(engine: WhisperEngine, steps: int = 4, rel_tol: float = 5e-2) -> None:
    """A seek window of the offline path (B = 1) on the kernel path against
    the plain path: prepare_mel of a log_mel_full window, then teacher-forced
    logits of the prefill at both ends of the prompt buckets (the first
    window's [1, 16]; [1, 256] for a window with the most previous text)
    and of `steps` decode steps after each: K2 at M = 16, 256 and 1."""
    from whisperlive_tpu_torch.ops.mel import log_mel_full, pad_or_trim_frames

    cfg, dev = engine.cfg, engine.device
    mel = pad_or_trim_frames(log_mel_full(speech_like(20.0, 5), n_mels=cfg.n_mels,
                                          device=dev))[None]
    opts = offline_options()
    previous = np.random.default_rng(7).integers(0, engine.spec.eot, cfg.n_text_ctx)
    for prev in ((), previous.tolist()):
        prompt, _ = engine.build_prompt(opts, prev, context_preseeded=True)
        arr, lens = engine._pad_prompts([prompt])
        pad = arr.shape[1]

        def run(tokens=None):
            with torch.inference_mode():
                enc, cross = engine.prepare_mel(mel)
                prompts, plen = engine._tensor(arr), engine._tensor(lens)
                self_kv = wmod.init_self_kv(cfg, 1, pad + steps, device=dev)
                logits = [wmod.decode_prefill(engine.params, cfg, prompts, plen, self_kv, cross)]
                forced = tokens if tokens is not None else []
                for i in range(steps):  # greedy on the kernel path, forced on both
                    if tokens is None:
                        forced.append(logits[-1].argmax(-1).to(torch.int32))
                    logits.append(wmod.decode_step(engine.params, cfg, forced[i], plen + i,
                                                   pad + i, plen, pad, self_kv, cross))
                return enc, logits, forced

        enc_k, logits_k, tokens = run()
        enc_r, logits_r, _ = plain_run(lambda: run(tokens))
        err = (enc_k.float() - enc_r.float()).abs().max().item()
        scale = enc_r.float().abs().max().item()
        log(f"reference: offline window, prompt [1, {pad}] ({len(prompt)} tokens): encoder "
            f"states max_abs_err={err:.6g} tol={rel_tol * scale:.6g}")
        check(enc_k.shape == (1, cfg.n_audio_ctx, cfg.n_audio_state)
              and bool(torch.isfinite(enc_k.float()).all()) and err <= rel_tol * scale,
              "offline window: encoder states disagree with the plain path")
        for i, (a, b) in enumerate(zip(logits_k, logits_r)):
            compare_logits(f"offline window [1, {pad}] logits step {i}", a, b, rel_tol,
                           (1, cfg.n_vocab))


def beam_reference(engine: WhisperEngine, steps: int = 4, rel_tol: float = 5e-2) -> None:
    """The first beam steps of the window route (beam 5, batch 2: logits of
    B*K = 10 rows a step) against the plain path, which follows the kernel
    path's beams: its top-K returns the kernel path's choices."""
    cfg = engine.cfg
    opts = beam_options(max_new=steps)
    audio, prompts, sots = beam_batch(engine, opts)
    with torch.inference_mode():
        _, cross = engine.prepare(audio)

    def run(choices=None):
        logits, picked = [], []
        top_k, decode_step = dec.top_k, wmod.decode_step

        def recorded_top_k(x, k):
            if choices is None:
                vals, idx = top_k(x, k)
            else:
                idx = choices[len(picked)]
                vals = x.gather(-1, idx)
            picked.append(idx)
            return vals, idx

        def recorded_step(*args, **kw):
            logits.append(decode_step(*args, **kw))
            return logits[-1]

        dec.top_k, wmod.decode_step = recorded_top_k, recorded_step
        try:
            engine.decode_batch(cross, prompts, sots, opts)
        finally:
            dec.top_k, wmod.decode_step = top_k, decode_step
        return logits, picked

    before = _kernels.launches["cross_attention_int8"]
    logits_k, choices = run()
    check(_kernels.launches["cross_attention_int8"] - before == (steps - 1) * cfg.n_text_layer,
          "the beam steps did not go through K4")
    logits_r, _ = plain_run(lambda: run(choices))
    check(len(logits_k) == len(logits_r) == steps - 1, f"{len(logits_k)} beam decode steps")
    for i, (a, b) in enumerate(zip(logits_k, logits_r)):
        same = compare_logits(f"beam window logits step {i} (B*K rows)", a, b, rel_tol,
                              (BEAM_BATCH * BEAM, cfg.n_vocab))
        check(same, f"beam step {i}: argmax differs from the plain path by more than a tie")


def beam_pool_reference(engine: WhisperEngine, steps: int = 4, rel_tol: float = 5e-2) -> None:
    """A beam pool's first steps (2 slots x 5 lanes, one chunk of `steps`
    steps: decode_step_masked over B*K = 10 rows with the slots' cross_len
    512 and 640 and no active rows; K4 with lengths on the kernel path)
    from one inserted state, against the plain path from the same state,
    which follows the kernel path's beams: its top-K returns the kernel
    path's choices."""
    cfg = engine.cfg
    cb = ContinuousEngine(engine, n_slots=2, beam_width=BEAM, prompt_pad=64, ring=16,
                          steps_per_chunk=steps, cross_ctx=K5_T, enc_buckets=(512, 1500))
    cb.init_state()
    prompt, sot = engine.build_prompt(beam_options(), language="en")
    for slot, seconds, enc_ctx in ((0, 4.0, 512), (1, 12.0, 1500)):
        window = np.zeros((1, 480000), np.float32)
        window[0, : int(16000 * seconds)] = speech_like(seconds, 70 + slot)
        cb.insert(window, [prompt], [sot], [True], [slot], [0.0], [True], [1.0], [cb.ring - 1],
                  enc_ctx=enc_ctx)
    want_len = [512] * BEAM + [K5_T] * BEAM
    check(cb.state["cross_len"].tolist() == want_len,
          f"beam pool cross_len {cb.state['cross_len'].tolist()}")
    start = wmod.tree_map(torch.clone, cb.state)
    gstep = cb.gstep

    def run(choices=None):
        cb.state = wmod.tree_map(torch.clone, start)
        cb.gstep = gstep
        logits, picked = [], []
        top_k, decode_step = dec.top_k, wmod.decode_step_masked

        def recorded_top_k(x, k):
            if choices is None:
                vals, idx = top_k(x, k)
            else:
                idx = choices[len(picked)]
                vals = x.gather(-1, idx)
            picked.append(idx)
            return vals, idx

        def recorded_step(*args, **kw):
            check(kw.get("active") is None, "the beam pool passed active rows")
            logits.append(decode_step(*args, **kw))
            return logits[-1]

        dec.top_k, wmod.decode_step_masked = recorded_top_k, recorded_step
        try:
            cb.step()
        finally:
            dec.top_k, wmod.decode_step_masked = top_k, decode_step
        return logits, picked

    before = dict(_kernels.launches)
    logits_k, choices = run()
    n4 = _kernels.launches["cross_attention_int8"] - before["cross_attention_int8"]
    n5 = _kernels.launches["cross_attention_int8_skip"] - before["cross_attention_int8_skip"]
    check(n4 == steps * cfg.n_text_layer and n5 == 0,
          f"the beam pool's steps launched K4 {n4} and K5 {n5} times")
    logits_r, _ = plain_run(lambda: run(choices))
    check(len(logits_k) == len(logits_r) == steps, f"{len(logits_k)} beam pool steps")
    for i, (a, b) in enumerate(zip(logits_k, logits_r)):
        same = compare_logits(f"beam pool logits step {i} (2 slots x {BEAM} lanes)", a, b,
                              rel_tol, (2 * BEAM, cfg.n_vocab))
        check(same, f"beam pool step {i}: argmax differs from the plain path by more than a tie")


def continuous_reference(engine: WhisperEngine, steps: int = 4, rel_tol: float = 5e-2) -> float:
    """The continuous step (decode_step_masked with per-slot cross_len and
    active rows; K5 on the kernel path at int8, K7 with lengths at int4)
    teacher forced from one inserted slot state of the serving pool's
    size, against the plain path. Active and free (inactive) rows lie in
    both 4-row M tiles of K2 and K3. Returns the largest error over
    max|ref| of the steps' logits."""
    cfg, dev = engine.cfg, engine.device
    bits = engine.cross_kv_bits
    cross_kernel = "cross_attention_int8_skip" if bits == 8 else "cross_attention_int4"
    cb = ContinuousEngine(engine, n_slots=CONT_SLOTS, prompt_pad=64, ring=16,
                          steps_per_chunk=1, cross_ctx=640, enc_buckets=(512,))
    cb.init_state()
    prompt, sot = engine.build_prompt(
        backends_mod.transcribe_options_from_session(SessionOptions(language="en")),
        language="en")
    # (slot, seconds, encoder bucket); slots 3 and 4 stay free
    seats = ((0, 4.0, 512), (1, 6.0, 512), (5, 3.0, 512), (6, 8.0, 512), (2, 9.0, 1500),
             (7, 12.0, 1500))
    for enc_ctx in (512, 1500):
        wave = [(slot, sec) for slot, sec, e in seats if e == enc_ctx]
        windows = np.zeros((len(wave), 480000), np.float32)
        for i, (slot, seconds) in enumerate(wave):
            windows[i, : int(16000 * seconds)] = speech_like(seconds, 10 + slot)
        n = len(wave)
        cb.insert(windows, [prompt] * n, [sot] * n, [True] * n, [slot for slot, _ in wave],
                  [0.0] * n, [True] * n, [1.0] * n, [8] * n, enc_ctx=enc_ctx)
    st = cb.state
    want_len = [640] * CONT_SLOTS
    for slot, _, enc_ctx in seats:
        want_len[slot] = min(enc_ctx, 640)
    check(st["cross_len"].tolist() == want_len, f"cross_len {st['cross_len'].tolist()}")
    active = st["active"].clone()
    want_active = [i in {slot for slot, _, _ in seats} for i in range(CONT_SLOTS)]
    check(active.tolist() == want_active, f"active {active.tolist()}")
    plen = st["prompt_len"].clone()
    j = torch.arange(cb.cache_len, device=dev)[None, :]

    def run(tokens=None):
        self_kv = st["self_kv"].clone()
        logits = [st["logits"].clone()]
        forced = tokens if tokens is not None else []
        with torch.inference_mode():
            for i in range(steps):
                if tokens is None:
                    forced.append(logits[-1].argmax(-1).to(torch.int32))
                mask = (j < plen[:, None]) | ((j >= cb.prompt_pad) & (j < cb.prompt_pad + i))
                logits.append(wmod.decode_step_masked(
                    engine.params, cfg, forced[i], plen + i, cb.prompt_pad + i, mask, self_kv,
                    st["cross_kv"], cross_len=st["cross_len"], active=active))
        return logits, forced

    n_cross = _kernels.launches[cross_kernel]
    logits_k, tokens = run()
    check(_kernels.launches[cross_kernel] == n_cross + steps * cfg.n_text_layer,
          f"the continuous step did not go through {cross_kernel}")
    logits_r, _ = plain_run(lambda: run(tokens))
    errs = []
    for i, (a, b) in enumerate(zip(logits_k[1:], logits_r[1:])):
        same = compare_logits(f"int{bits} continuous logits step {i} (active rows)", a[active],
                              b[active], rel_tol, (len(seats), cfg.n_vocab), errs)
        check(same, f"int{bits} continuous step {i}: argmax differs from the plain path on an "
              "active row by more than a tie")
    return max(errs)


def verify_reference(engine: WhisperEngine, rel_tol: float = 5e-2) -> float:
    """The verify window's teacher-forced logits against the plain path, on
    three windows (4, 8 and 2 s of audio) after a prompt prefill:
    decode_window over the full context (K6 at int8, K8 at int4) and
    decode_window_masked with per-row cross_len [1500, 512, 1500] and the
    third row inactive (K5's window form at int8, K8 with lengths at int4),
    compared on the active rows. Returns the largest error measured."""
    cfg, dev = engine.cfg, engine.device
    bits = engine.cross_kv_bits
    audio = np.zeros((3, 480000), np.float32)
    for i, seconds in enumerate((4.0, 8.0, 2.0)):
        audio[i, : int(16000 * seconds)] = speech_like(seconds, 30 + i)
    prompt, _ = engine.build_prompt(
        backends_mod.transcribe_options_from_session(SessionOptions(language="en")),
        language="en")
    p, w = len(prompt), SPEC_K + 1
    prompts = torch.tensor([prompt] * 3, dtype=torch.int32, device=dev)
    plen = torch.full((3,), p, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(SEED)
    win = torch.tensor(rng.integers(0, engine.spec.eot, (3, w)), dtype=torch.int32, device=dev)
    wpos = plen[:, None] + torch.arange(w, device=dev)[None, :]
    cross_len = torch.tensor([cfg.n_audio_ctx, 512, cfg.n_audio_ctx], dtype=torch.int32,
                             device=dev)
    active = torch.tensor([True, True, False], device=dev)
    j = torch.arange(p + w, device=dev)[None, None, :]
    mask = (j < p) | (j <= p + torch.arange(w, device=dev)[None, :, None])
    mask = mask.expand(3, w, p + w)
    with torch.inference_mode():
        _, cross = engine.prepare(audio)

    def run():
        with torch.inference_mode():
            out = []
            for masked in (False, True):
                self_kv = wmod.init_self_kv(cfg, 3, p + w, device=dev)
                wmod.decode_prefill(engine.params, cfg, prompts, plen, self_kv, cross)
                if masked:
                    out.append(wmod.decode_window_masked(
                        engine.params, cfg, win, wpos, p, mask, self_kv, cross,
                        cross_len=cross_len, active=active))
                else:
                    out.append(wmod.decode_window(engine.params, cfg, win, wpos, p, plen, p,
                                                  self_kv, cross))
            return out

    names = (("cross_attention_int8_window", "cross_attention_int8_skip_window") if bits == 8
             else ("cross_attention_int4_window", "cross_attention_int4_window"))
    before = dict(_kernels.launches)
    kernel_logits = run()
    after = dict(_kernels.launches)
    # the two prefills of a short prompt (1 < Tq <= 8) take the unmasked
    # window kernel too
    n_layer, n_pre = cfg.n_text_layer, 2 if 1 < p <= attn_ops.MAX_WINDOW else 0
    want = ({names[0]: (n_pre + 1) * n_layer, names[1]: n_layer} if bits == 8
            else {names[0]: (n_pre + 2) * n_layer})
    check(all(after[n] - before[n] == c for n, c in want.items()),
          f"the verify windows did not go through {names}")
    plain_logits = plain_run(run)
    err = 0.0
    for label, a, b, rows in (("decode_window", kernel_logits[0], plain_logits[0], 3),
                              ("decode_window_masked", kernel_logits[1], plain_logits[1], 2)):
        check(a.shape == (3, w, cfg.n_vocab), f"{label} logits {tuple(a.shape)}")
        a2, b2 = a[:rows].reshape(-1, cfg.n_vocab), b[:rows].reshape(-1, cfg.n_vocab)
        same = compare_logits(f"int{bits} {label} ({rows} active rows x {w} window positions)",
                              a2, b2, rel_tol, (rows * w, cfg.n_vocab))
        check(same, f"int{bits} {label}: argmax differs from the plain path by more than a tie")
        err = max(err, (a2 - b2).abs().max().item())
    return err


def teacher_logits(engine: WhisperEngine, cross: dict, prompt: list[int], sot: int,
                   tokens: list[int]) -> list[torch.Tensor]:
    """Logits [V] before each of `tokens`, teacher forced through the plain
    decode's calls (prompt padded to its bucket, one decode_step a token)."""
    cfg, dev = engine.cfg, engine.device
    prompt_arr, prompt_len = engine._pad_prompts([prompt])
    prompts, plen = engine._tensor(prompt_arr), engine._tensor(prompt_len)
    pad = prompt_arr.shape[1]
    with torch.inference_mode():
        self_kv = wmod.init_self_kv(cfg, 1, pad + len(tokens) + 1, device=dev)
        logits, _ = wmod.decode_prefill(engine.params, cfg, prompts, plen, self_kv, cross,
                                        sot_idx=engine._tensor(np.asarray([sot], np.int32)))
        out = [logits[0]]
        for i, tok in enumerate(tokens[:-1]):
            t = torch.tensor([tok], dtype=torch.int32, device=dev)
            out.append(wmod.decode_step(engine.params, cfg, t, plen + i, pad + i, plen, pad,
                                        self_kv, cross)[0])
    return out


def timestamp_rule_gap(engine: WhisperEngine, opts: TranscribeOptions, logits: torch.Tensor,
                       prev: list[int]) -> float:
    """|log-mass of the timestamps the decoder may emit after `prev` - the
    best text logit it may emit|: the margin of the rule that forces a
    timestamp (ops/decoding.py apply_logit_rules). After text, the
    timestamps it may emit are those above the last one. Where other rules
    alone decide (the first token must be a timestamp; after a timestamp
    the pairing rule suppresses text or timestamps), the margin decides
    nothing and is infinite."""
    tb = engine.spec.timestamp_begin
    if not prev or prev[-1] >= tb:
        return float("inf")
    allowed = ~engine.suppress_mask_for(opts)
    allowed[tb - 1] = False  # the no-timestamps token
    stamps = [t for t in prev if t >= tb]
    if stamps:
        allowed[tb:stamps[-1] + 1] = False
    ts_mass = torch.logsumexp(logits[tb:][allowed[tb:]], 0)
    return abs(ts_mass - logits[:tb][allowed[:tb]].max()).item()


def spec_reference(engine: WhisperEngine, draft: WhisperEngine, err: float) -> None:
    """One speculative greedy decode against the plain greedy decode of the
    same window. On the card the verify (K6) and the plain steps (K4) sum in
    other orders, so the tokens must agree up to a tie: at the first token
    that differs, the two candidates' plain logits (or, for the timestamp
    rule, the log-mass of the timestamps the rules allow and the best
    allowed text logit) lie within twice the verify's measured error."""
    spec = SpeculativeDecoder(engine, draft, k=SPEC_K)
    audio = np.zeros((1, 480000), np.float32)
    audio[0, :112000] = speech_like(7.0, 40)
    opts = TranscribeOptions(language="en", temperatures=(0.0,), max_new_tokens=MAX_NEW_TOKENS,
                             log_prob_threshold=None, no_speech_threshold=None,
                             compression_ratio_threshold=None)
    prompt, sot = engine.build_prompt(opts, language="en")
    enc, cross = engine.prepare(audio)
    res = spec.decode(cross, spec.cross_from_enc(enc), prompt, sot, opts)
    (plain,) = engine.decode_batch(cross, [prompt], [sot], opts, temperatures=[0.0])
    eot = engine.spec.eot
    s = [int(t) for t in res.tokens] + [eot]
    q = [int(t) for t in plain.tokens] + [eot]
    st = spec.stats
    log(f"reference: speculative decode {len(res.tokens)} tokens in {st['iterations']} rounds "
        f"(acceptance {spec.acceptance_rate():.6g}), plain decode {len(plain.tokens)} tokens")
    i = next((i for i, (a, b) in enumerate(zip(s, q)) if a != b), None)
    if i is None:
        check(s == q, "speculative and plain decodes differ in length only")
        log("reference: speculative tokens equal the plain decode's")
        return
    logits = teacher_logits(engine, cross, prompt, sot, q[: i + 1])[i].float()
    gap = abs(logits[s[i]] - logits[q[i]]).item()
    ts_gap = timestamp_rule_gap(engine, opts, logits, q[:i])
    log(f"reference: speculative and plain tokens first differ at {i} ({s[i]} vs {q[i]}): "
        f"plain-logit gap {gap:.6g}, timestamp-rule gap {ts_gap:.6g}, tie bound {2 * err:.6g}")
    check(min(gap, ts_gap) <= 2 * err,
          f"speculative decode differs from the plain decode at token {i} by more than a tie")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 10: fine-tuning, draft distillation, the distilled draft served
# ---------------------------------------------------------------------------

TRAIN_BATCH = 2
TRAIN_TOKENS = 48
TRAIN_STEPS = 3
DISTILL_CTX = 512
DISTILL_BATCH = 8  # the teacher's pseudo-labelling batch (its largest bucket <= 8)
DISTILL_ARGS = ("--layers", "2", "--enc_ctx", str(DISTILL_CTX), "--seq", "48", "--batch", "4",
                "--pool", "48", "--steps", "200")
DISTILL_STAGES = ("audio_pool", "pseudo_label", "precompute", "train")


def distill_phase(dev: torch.device) -> tuple[dict, WhisperEngine]:
    """(b) The distiller CLI at large-v3 on the seed's random teacher (the
    engine of phases 4-9): each stage's time and launches (the stages are
    wrapped where main looks them up), its KD losses and held-out
    agreements, and the written draft loaded through loader.load_engine.
    Returns the figures and the draft engine."""
    import shutil
    import tempfile

    from whisperlive_tpu_torch import loader
    from whisperlive_tpu_torch.cli import distill as distill_cli

    stages: dict = {}

    def staged(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize(dev)
            before, t0 = dict(_kernels.launches), time.monotonic()
            out = fn(*a, **kw)
            torch.cuda.synchronize(dev)
            stages[name] = {"s": time.monotonic() - t0,
                            "launches": {k: n - before[k] for k, n in _kernels.launches.items()}}
            if name == "train":
                stages[name]["result"] = out[1:]  # losses, agreement before, after
            return out
        return run

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_draft_")
    saved = {name: getattr(distill_cli, name) for name in DISTILL_STAGES}
    try:
        for name, fn in saved.items():
            setattr(distill_cli, name, staged(name, fn))
        t0 = time.monotonic()
        rc = distill_cli.main(["--model", MODEL, *DISTILL_ARGS, "--device", str(dev),
                               "--out", out_dir])
        total_s = time.monotonic() - t0
        check(rc == 0, f"cli.distill exited {rc}")
        t0 = time.monotonic()
        draft = loader.load_engine("distill-large-v3", out_dir, device=dev)
        load_s = time.monotonic() - t0
        ctx = loader.draft_distill_ctx(out_dir)
    finally:
        for name, fn in saved.items():
            setattr(distill_cli, name, fn)
        shutil.rmtree(out_dir, ignore_errors=True)

    for name in DISTILL_STAGES:
        log(f"distiller stage {name}: {stages[name]['s']:.6g} s, launches "
            f"{ {k: n for k, n in stages[name]['launches'].items() if n} }")
    rest_s = total_s - sum(stages[n]["s"] for n in DISTILL_STAGES)
    log(f"distiller: {total_s:.6g} s in cli.distill.main ({rest_s:.6g} s of it the teacher "
        f"engine's build and the draft's save), draft engine loaded in {load_s:.6g} s")
    check_path("distiller's pseudo-labelling", stages["pseudo_label"]["launches"], WINDOW_PATH)
    check_path("distiller's precompute", stages["precompute"]["launches"], ("fused_attention",),
               absent=[k for k in KERNELS if k != "fused_attention"])
    check_path("distiller's KD steps", stages["train"]["launches"], (), absent=KERNELS)
    losses, acc0, acc1 = stages["train"]["result"]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    log(f"distiller KD: {len(losses)} steps, loss {losses[0]:.6g} -> {losses[-1]:.6g} (mean of "
        f"the first 10 {first:.6g}, of the last 10 {last:.6g}); held-out teacher-forced "
        f"agreement {acc0:.6g} before, {acc1:.6g} after")
    check(bool(np.isfinite(losses).all()) and last < first, "the KD loss did not fall")
    check(acc1 > acc0, f"held-out agreement did not rise ({acc0} -> {acc1})")
    check(ctx == DISTILL_CTX, f"the draft records distill_enc_ctx {ctx}, not {DISTILL_CTX}")
    check(draft.cfg.n_text_layer == 2 and draft.decoder_int8, "the draft engine's shape")
    figures = {"stage_s": {n: stages[n]["s"] for n in DISTILL_STAGES}, "main_s": total_s,
               "draft_load_s": load_s, "steps": len(losses), "loss_first10": first,
               "loss_last10": last, "agreement_before": acc0, "agreement_after": acc1,
               "pseudo_label_launches": stages["pseudo_label"]["launches"]}
    return figures, draft


def finetune_phase(dev: torch.device) -> dict:
    """(a) make_train_step at large-v3 full width from the seed's random
    tree upcast to float32 master weights, bf16 compute: TRAIN_STEPS steps
    of B = TRAIN_BATCH mel [B,3000,128] from speech-like audio with
    TRAIN_TOKENS token rows (warmup 1: the first step runs at lr 0). The
    parameters are unchanged after step 1 and every leaf moved after step 2;
    K1 never launches (the training encoder's attention is plain), and K1
    called on inputs that require grad raises without launching; a
    save_checkpoint / load_checkpoint round trip is bit-equal, and one more
    step from the saved and from the restored state gives the same loss."""
    import shutil
    import tempfile

    from whisperlive_tpu_torch import training
    from whisperlive_tpu_torch.models.safetensors_io import flatten_tree
    from whisperlive_tpu_torch.ops import mel as mel_ops

    cfg = wmod.WHISPER_CONFIGS[MODEL].replace(dtype=torch.bfloat16)
    opt = training.make_optimizer(learning_rate=1e-5, warmup_steps=1, total_steps=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats(dev)
    state = training.init_train_state(cfg, opt, wmod.init_params(cfg, SEED, torch.bfloat16, dev),
                                      device=dev)
    n_params = sum(t.numel() for t in training.leaves(state.params))
    audio = np.stack([speech_like(30.0, 60 + i) for i in range(TRAIN_BATCH)])
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.n_vocab, (TRAIN_BATCH, TRAIN_TOKENS + 1)).astype(np.int32)).to(dev)
    batch = {"mel": mel_ops.log_mel_spectrogram(torch.from_numpy(audio).to(dev), cfg.n_mels),
             "tokens_in": tokens[:, :-1], "tokens_out": tokens[:, 1:],
             "loss_mask": torch.ones((TRAIN_BATCH, TRAIN_TOKENS), device=dev)}
    check(tuple(batch["mel"].shape) == (TRAIN_BATCH, 3000, cfg.n_mels), "the mel's shape")
    step = training.make_train_step(cfg, opt)
    start = {k: t.clone() for k, t in flatten_tree(state.params).items()}

    losses, step_s = [], []
    _kernels.reset_launches()
    for n in range(TRAIN_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        state, loss = step(state, batch)
        torch.cuda.synchronize(dev)
        step_s.append(time.monotonic() - t0)
        losses.append(float(loss))
        now = flatten_tree(state.params)
        if n == 0:
            check(all(torch.equal(t, start[k]) for k, t in now.items()),
                  "a parameter moved in the first step (learning rate 0)")
        elif n == 1:
            still = [k for k, t in now.items() if torch.equal(t, start[k])]
            check(not still, f"leaves unchanged after the second step: {still[:5]}")
    launches = dict(_kernels.launches)
    del start, now
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"fine-tune ({MODEL}, {n_params} float32 master parameters, bf16 compute, B = "
        f"{TRAIN_BATCH}, T = {TRAIN_TOKENS}): losses {losses}, step times {step_s} s, "
        f"max_memory_allocated {peak / 2**30:.6g} GiB, launches {launches}")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(launches["fused_attention"] == 0, "K1 launched inside a train step")
    q = torch.randn((1, 64, cfg.n_audio_head, 64), device=dev, dtype=torch.bfloat16)
    q.requires_grad_(True)
    try:
        with torch.enable_grad():
            attn_ops.fused_attention(q, q, q)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    log(f"K1 on CUDA inputs that require grad raises: {raised!r}")
    check(raised is not None and "no backward" in raised,
          "K1 returned a result for inputs that require grad")
    check(_kernels.launches["fused_attention"] == 0, "K1 launched on inputs that require grad")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.monotonic()
        training.save_checkpoint(tmp, state, cfg)
        save_s = time.monotonic() - t0
        size = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        # compared on the host (a mapping of the files), then restored onto
        # the card once this state is gone: one state on the card at a time
        mapped, cfg2 = training.load_checkpoint(tmp, "cpu")
        check(cfg2 == cfg.replace(dtype=torch.float32) and mapped.step == state.step
              and mapped.opt_state.count == state.opt_state.count, "restored config or step")
        for name, mine, theirs in (("params", state.params, mapped.params),
                                   ("mu", state.opt_state.mu, mapped.opt_state.mu),
                                   ("nu", state.opt_state.nu, mapped.opt_state.nu)):
            check_same_tree(f"training checkpoint {name}", mine, theirs)
        del mapped
        loss_saved = float(step(state, batch)[1])
        del state
        t0 = time.monotonic()
        restored, _ = training.load_checkpoint(tmp, dev)
        torch.cuda.synchronize(dev)
        load_s = time.monotonic() - t0
        check({t.device.type for t in training.leaves(restored.params)} == {"cuda"},
              "the restored state is off the card")
        loss_restored = float(step(restored, batch)[1])
        del restored
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"fine-tune checkpoint: {size / 2**30:.6g} GiB written in {save_s:.6g} s, loaded "
        f"onto the card in {load_s:.6g} s, bit-equal; step {TRAIN_STEPS + 1} loss from the "
        f"saved state {loss_saved!r}, from the restored one {loss_restored!r}")
    check(abs(loss_saved - loss_restored) <= 1e-5 * abs(loss_saved),
          "the resumed step's loss differs")
    return {"params": n_params, "losses": losses, "step_s": step_s,
            "max_memory_allocated_gib": peak / 2**30, "checkpoint_gib": size / 2**30,
            "save_s": save_s, "load_s": load_s, "resumed_loss": [loss_saved, loss_restored]}


# ---------------------------------------------------------------------------
# Phase 11: REST, live diarization and translation
# ---------------------------------------------------------------------------

REST_FILE_S = 35.0  # two seek windows: 30 s on the window route, the rest on the pool
REST_RAW_S = 12.0  # one window inside the pool's content cap
KNOWN_SPLIT_S = 30.0  # known-speaker files: the first voice fills the first seek window
KNOWN_ORDERS = (("alice", "bob"), ("bob", "alice"))
REST_FORMATS = ("json", "verbose_json", "srt", "vtt", "text")
# alirezamsh/small100 config.json: 12 encoder and 3 decoder layers at M2M100's widths
SMALL100 = dict(vocab_size=128112, d_model=1024, encoder_layers=12, decoder_layers=3,
                encoder_attention_heads=16, decoder_attention_heads=16, encoder_ffn_dim=4096,
                decoder_ffn_dim=4096, max_position_embeddings=1024, pad_token_id=1,
                bos_token_id=0, eos_token_id=2, decoder_start_token_id=2, scale_embedding=True,
                activation_function="relu", model_type="m2m100")
LIVE_SESSION_S = 16.0  # the translator shares the host with the pool: calls slow down
TRANSLATE_BUCKET = 64
TRANSLATE_REF_SOURCES = 4
TRANSLATE_REF_STEPS = 16


def wav_bytes(audio: np.ndarray) -> bytes:
    """16-bit mono 16 kHz WAV of `audio`, in memory."""
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def rest_request(backend, fields: dict, data: bytes, filename: str = "a.wav",
                 known: tuple = (), names: tuple = ()) -> dict:
    """One request through the REST core (rest.handle_transcription, what the
    aiohttp app wraps), with the launch counters reset just before and read
    after; the backend's route counts of its windows."""
    from whisperlive_tpu_torch.serving import rest

    chunks: list[bytes] = []

    async def write(chunk: bytes) -> None:
        chunks.append(chunk)

    routes = {"window": 0, "continuous": 0}
    pick = backends_mod.TorchBackend._pick_scheduler

    def counted(self, *a, **kw):
        sched = pick(self, *a, **kw)
        routes["window" if sched is self.scheduler else "continuous"] += 1
        return sched

    backend._pick_scheduler = counted.__get__(backend)
    _kernels.reset_launches()
    t0 = time.monotonic()
    try:
        status, ctype, body = asyncio.run(rest.handle_transcription(
            backend, fields, data, filename, list(known), list(names), write))
    finally:
        del backend._pick_scheduler
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = dict(_kernels.launches)
    check(status == 200, f"REST {fields}: status {status}: {body}")
    for name in ("fused_attention", "int8_matmul", "int8_matmul_t"):
        check(launches[name] > 0, f"REST {fields}: {name} not launched")
    check(routes["window"] == 0 or launches["cross_attention_int8"] > 0,
          f"REST {fields}: a window-route window without K4")
    check(routes["continuous"] == 0 or launches["cross_attention_int8_skip"] > 0,
          f"REST {fields}: a pool window without K5")
    check(sum(routes.values()) > 0, f"REST {fields}: no window reached a scheduler")
    log(f"REST {fields} ({len(data)} bytes): {seconds:.6g} s host time, routes {routes}, "
        f"launches {launches}")
    return dict(seconds=seconds, ctype=ctype, body=body, sse=b"".join(chunks).decode(),
                routes=routes, launches=launches)


def rest_phase(engine: WhisperEngine) -> dict:
    """(a) The REST endpoint's core on the continuous pool and the window
    scheduler: every response format and the SSE stream of one 35 s file,
    a raw f32 upload, known-speaker labels, and the auth and rate gate."""
    from whisperlive_tpu_torch.serving import rest

    cs = ContinuousScheduler(engine, n_slots=CONT_SLOTS, steps_per_chunk=8, cross_ctx=640,
                             enc_buckets=(512, 1500))
    window = BatchScheduler(engine, max_batch_size=BATCH, batch_window_ms=50)
    window.start()
    cs.start()
    backend = backends_mod.TorchBackend(window, model_name=MODEL, continuous_scheduler=cs)
    audio = speech_like(REST_FILE_S, 21)
    wav = wav_bytes(audio)
    out: dict = {}
    upload = speech_like(REST_RAW_S, 22).tobytes()
    try:
        out["verbose_json"] = rest_request(backend, {
            "response_format": "verbose_json", "language": "en",
            "timestamp_granularities": "word"}, wav)
        out["raw_f32"] = rest_request(backend, {"response_format": "verbose_json",
                                                "language": "en"}, upload, "upload.bin")
        # the other formats on the upload's one window
        for fmt in REST_FORMATS:
            if fmt != "verbose_json":
                out[fmt] = rest_request(backend, {"response_format": fmt, "language": "en"},
                                        upload, "upload.bin")
        out["stream"] = rest_request(backend, {"stream": "true", "language": "en"}, upload,
                                     "upload.bin")
        # both voices enrolled, alice first; one file opens with alice's voice
        # for the first seek window and ends with bob's, the other the reverse
        known = tuple((f"{name}.wav", wav_bytes(voice(6.0, 23 + i, **VOICES[name])))
                      for i, name in enumerate(VOICES))
        for first, second in KNOWN_ORDERS:
            two_voices = np.concatenate([voice(KNOWN_SPLIT_S, 31, **VOICES[first]),
                                         voice(REST_FILE_S - KNOWN_SPLIT_S, 32,
                                               **VOICES[second])])
            out[f"known_{first}_first"] = rest_request(
                backend, {"response_format": "verbose_json", "language": "en"},
                wav_bytes(two_voices), known=known, names=tuple(VOICES))
    finally:
        cs.stop()
        window.stop()

    verbose = json.loads(out["verbose_json"]["body"])
    segs = verbose["segments"]
    check(bool(segs) and verbose["duration"] == REST_FILE_S, "verbose_json: no segments")
    check(segs[-1]["end"] > 30.0, "verbose_json: the second seek window decoded nothing")
    check(all(s["tokens"] for s in segs), "verbose_json: a segment without tokens")
    n_words = check_offline_words("REST verbose_json", segs)
    raw = json.loads(out["raw_f32"]["body"])
    check(raw["duration"] == REST_RAW_S and bool(raw["segments"]), "raw f32 upload: no segments")
    events = out["stream"]["sse"].split("\n\n")
    check(events[-2:] == ["data: [DONE]", ""], f"SSE: does not end with [DONE]: {events[-3:]}")
    sse = [json.loads(e[len("data: "):]) for e in events[:-2]]
    check([(e["text"], e["start"], e["end"]) for e in sse]
          == [(s["text"], s["start"], s["end"]) for s in raw["segments"]],
          "SSE events differ from the verbose_json segments")
    check(json.loads(out["json"]["body"]) == {"text": raw["text"]},
          "json differs from the verbose_json text")
    for fmt in ("srt", "vtt", "text"):
        check((out[fmt]["ctype"], out[fmt]["body"]) == rest._format_response(
            raw["segments"], raw["language"], raw["duration"], fmt), f"{fmt} differs from "
              "the verbose_json segments formatted")
    # a segment that holds MIN_AUDIO_S of the file's audio (random weights also
    # place segments past the file's end) inside one voice's part carries that
    # voice's name; the first seek window lies inside the first part
    labels = {}
    for first, second in KNOWN_ORDERS:
        labelled = json.loads(out[f"known_{first}_first"]["body"])["segments"]
        inside = []
        for s in labelled:
            end = min(s["end"], REST_FILE_S)
            if end - s["start"] >= MIN_AUDIO_S and (end <= KNOWN_SPLIT_S
                                                    or s["start"] >= KNOWN_SPLIT_S):
                inside.append((s, first if end <= KNOWN_SPLIT_S else second))
        labels[f"{first}_first"] = [(s["start"], s["end"], s.get("speaker")) for s in labelled]
        check(any(name == first for _, name in inside)
              and all(s.get("speaker") == name for s, name in inside),
              f"known speakers, {first} first: (start, end, label) {labels[f'{first}_first']}")
    # the gate in front of every /v1/ request
    path = rest.ENDPOINT
    denied = rest.check_access(path, "Bearer wrong", "1.2.3.4", "k3y", rest.RateLimiter(0))
    check(denied is not None and denied[0] == 401, f"wrong key: {denied}")
    check(rest.check_access(path, "Bearer k3y", "1.2.3.4", "k3y", rest.RateLimiter(0)) is None,
          "right key refused")
    limiter = rest.RateLimiter(2)
    gates = [rest.check_access(path, "", "1.2.3.4", None, limiter) for _ in range(3)]
    check(gates[:2] == [None, None] and gates[2] is not None and gates[2][0] == 429,
          f"rate limit 2 rpm: {gates}")
    result = {
        "file_s": REST_FILE_S,
        "requests": {k: {"host_s": v["seconds"], "routes": v["routes"],
                         "launches": v["launches"]} for k, v in out.items()},
        "segments": len(segs), "words": n_words,
        "known_speaker_labels": labels,
    }
    log(f"REST: {len(segs)} segments, {n_words} words, labels "
        f"{result['known_speaker_labels']}; host s per request "
        + ", ".join(f"{k} {v['seconds']:.6g}" for k, v in out.items()))
    return result


def small100_state_dict(seed: int, dev: torch.device) -> dict[str, torch.Tensor]:
    """Random bf16 SMALL100 weights in HF M2M100ForConditionalGeneration's
    key layout, made on the card: projections N(0, 1/sqrt(fan_in)), biases
    N(0, 0.02), the shared embedding N(0, 0.5), layer norms at one and zero.
    (Projections at 4/sqrt(fan_in) make the 12 encoder layers chaotic: bf16
    and float32 then part by 68% of max|ref|.)"""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    d, f = SMALL100["d_model"], SMALL100["encoder_ffn_dim"]
    sd: dict[str, torch.Tensor] = {}

    def lin(name, d_out, d_in):
        sd[f"{name}.weight"] = (torch.randn(d_out, d_in, generator=g, device=dev)
                                / d_in ** 0.5).to(torch.bfloat16)
        sd[f"{name}.bias"] = (torch.randn(d_out, generator=g, device=dev) * 0.02
                              ).to(torch.bfloat16)

    def ln(name):
        sd[f"{name}.weight"] = torch.ones(d, dtype=torch.bfloat16, device=dev)
        sd[f"{name}.bias"] = torch.zeros(d, dtype=torch.bfloat16, device=dev)

    sd["model.shared.weight"] = (torch.randn(SMALL100["vocab_size"], d, generator=g, device=dev)
                                 * 0.5).to(torch.bfloat16)
    for side, n in (("encoder", SMALL100["encoder_layers"]),
                    ("decoder", SMALL100["decoder_layers"])):
        for i in range(n):
            pre = f"model.{side}.layers.{i}"
            attns = ("self_attn", "encoder_attn") if side == "decoder" else ("self_attn",)
            for attn in attns:
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    lin(f"{pre}.{attn}.{proj}", d, d)
                ln(f"{pre}.{attn}_layer_norm")
            lin(f"{pre}.fc1", f, d)
            lin(f"{pre}.fc2", d, f)
            ln(f"{pre}.final_layer_norm")
        ln(f"model.{side}.layer_norm")
    return sd


def write_small100_dir(path: str, dev: torch.device) -> None:
    """A SMALL100-shaped checkpoint dir: config.json, model.safetensors
    (random weights from SEED + 2) and a toy tokenizer whose vocab.json
    fills every id below the language tokens, and whose SentencePiece
    pieces spell VisibleTokenizer's words (" t1234")."""
    from whisperlive_tpu_torch import small100_tokenizer as spm
    from whisperlive_tpu_torch.models import safetensors_io

    u = spm.SPIECE_UNDERLINE
    chars = [u, "t"] + [str(i) for i in range(10)]
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(c, -2.0, 1) for c in chars] + [(u + "t", -0.5, 1)]
    spm.write_spm_model(os.path.join(path, "sentencepiece.bpe.model"), pieces)
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for p, _, kind in pieces:
        if kind == 1:
            vocab[p] = len(vocab)
    n_text = SMALL100["vocab_size"] - len(spm.FAIRSEQ_LANGUAGE_CODES) - 8
    while len(vocab) < n_text:
        vocab[f"{u}w{len(vocab)}"] = len(vocab)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "SMALL100Tokenizer"}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(SMALL100, f)
    safetensors_io.save_file(small100_state_dict(SEED + 2, dev),
                             os.path.join(path, "model.safetensors"))


def live_phase(engine: WhisperEngine, model_dir: str) -> dict:
    """(b) A diarized and a translated streaming session on the continuous
    backend, the translator loaded from `model_dir` on the card."""
    from whisperlive_tpu_torch.models import m2m100 as m2m
    from whisperlive_tpu_torch.translation import TorchTranslator

    t0 = time.monotonic()
    translator = TorchTranslator.shared(model_dir)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    leaves = []
    wmod.tree_map(leaves.append, translator.params)
    check(all(t.device.type == "cuda" and t.dtype == torch.bfloat16 for t in leaves),
          "translator parameters off the card or not bf16")
    n_params = sum(t.numel() for t in leaves)
    log(f"translator: SMALL100-shaped, {n_params} parameters, loaded in {load_s:.6g} s, beam "
        f"{translator.beam_size}, max_new {translator.max_new}")

    cs = ContinuousScheduler(engine, n_slots=CONT_SLOTS, steps_per_chunk=8, cross_ctx=640,
                             enc_buckets=(512, 1500))
    window = BatchScheduler(engine, max_batch_size=BATCH, batch_window_ms=50)
    window.start()
    cs.start()

    def translated_all(ws) -> bool:
        done = {(s["start"], s["end"]) for m in ws.sent for s in m.get("translated_segments", [])}
        committed = {(s["start"], s["end"]) for m in ws.sent for s in m.get("segments", [])
                     if s.get("completed")}
        return committed <= done

    try:
        backend = CountingBackend(window, model_name=MODEL, continuous_scheduler=cs)
        sessions = [
            dict(uid="live-diarized", language="en", audio=np.concatenate(
                [speech_like(LIVE_SESSION_S / 2, 25), 0.7 * speech_like(LIVE_SESSION_S / 2, 26)]),
                 extra={"enable_diarization": True, "max_speakers": 2}),
            dict(uid="live-translated", language="en", audio=speech_like(LIVE_SESSION_S, 27),
                 extra={"enable_translation": True, "target_language": "fr"},
                 settle=translated_all),
        ]
        sockets, wall = serve(backend, sessions, translation_model_dir=model_dir)
    finally:
        cs.stop()
        window.stop()
    launches = dict(_kernels.launches)
    check_calls(backend, [s["uid"] for s in sessions], 4)
    check_sockets(sockets)
    for name in CONTINUOUS_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched by the live sessions")

    completed = {}
    for m in sockets[0].sent:
        for s in m.get("segments", []):
            if s.get("completed"):
                completed[(s["start"], s["end"])] = s
    diarized = list(completed.values())
    heard = [s for s in diarized if float(s["end"]) - float(s["start"]) >= MIN_AUDIO_S]
    check(bool(heard), f"the diarized session committed no segment of {MIN_AUDIO_S} s: {diarized}")
    check(all("speaker" in s for s in heard),
          f"a committed segment without a speaker: {diarized}")

    sources = {}
    for m in sockets[1].sent:
        for s in m.get("segments", []):
            if s.get("completed"):
                sources[(s["start"], s["end"])] = s["text"]
    translated = [s for m in sockets[1].sent for s in m.get("translated_segments", [])]
    check(bool(translated), "the translated session received no translated_segments")
    check(set(sources) <= {(s["start"], s["end"]) for s in translated},
          "a committed segment was never translated")
    steps, seconds = [], []
    forward = m2m._cached_forward

    def counting_forward(*a, **kw):
        steps[-1] += 1
        return forward(*a, **kw)

    m2m._cached_forward = counting_forward
    try:
        for s in translated:
            steps.append(-1)  # the prefix pass is not a decode step
            t0 = time.monotonic()
            fresh = translator.translate(sources[(s["start"], s["end"])], "fr")
            torch.cuda.synchronize()
            seconds.append(time.monotonic() - t0)
            check(fresh == s["text"], f"translated text {s['text']!r} differs from a fresh "
                  f"translation {fresh!r} of {sources[(s['start'], s['end'])]!r}")
    finally:
        m2m._cached_forward = forward
    result = {"wall_s": wall, "translator_load_s": load_s, "translator_params": n_params,
              "diarized_segments": len(diarized), "labelled_segments": len(heard),
              "speakers": sorted({s["speaker"] for s in heard}),
              "translated_segments": len(translated),
              "translate_s_per_segment": statistics.median(seconds),
              "decode_steps_per_segment": statistics.median(steps),
              "launches": launches}
    log(f"live sessions: {wall:.6g} s wall; diarized {len(diarized)} segments, {len(heard)} "
        f"of {MIN_AUDIO_S} s or more, speakers "
        f"{result['speakers']}; {len(translated)} translated segments, translate "
        f"{seconds} s, decode steps {steps}; launches {launches}")
    return result


def translation_reference(model_dir: str, dev: torch.device, rel_tol: float = 5e-2,
                          logit_rel_tol: float = 5e-3) -> dict:
    """(c) The SMALL100-shaped model on the card in bf16 (the translator's)
    against the same weights in float32: encoder states within rel_tol and
    teacher-forced logits within logit_rel_tol of max|ref| (their sound
    readings: 2.4e-2 and 8.9e-4) for 4 sources at the 64-token bucket, and
    the free-running greedy tokens of the first 16 steps, equal up to a tie
    within twice the measured logit error."""
    from whisperlive_tpu_torch.models import m2m100 as m2m
    from whisperlive_tpu_torch.models import safetensors_io
    from whisperlive_tpu_torch.translation import TorchTranslator

    bf16 = TorchTranslator.shared(model_dir)
    cfg32 = bf16.cfg.replace(dtype=torch.float32)
    p32 = m2m.cast_params(m2m.params_from_state_dict(safetensors_io.load_dir(model_dir), cfg32),
                          torch.float32, dev)
    rng = np.random.default_rng(SEED + 3)
    n, t = TRANSLATE_REF_SOURCES, TRANSLATE_BUCKET
    src = np.full((n, t), cfg32.pad_token_id, np.int64)
    for i, length in enumerate((t, 40, 17, 5)):
        src[i, :length] = rng.integers(3, cfg32.vocab_size, length)
        src[i, length - 1] = cfg32.eos_token_id
    src = torch.from_numpy(src).to(dev)
    mask = src != cfg32.pad_token_id
    with torch.inference_mode():
        ref_tokens = m2m.generate_greedy(p32, cfg32, src, None, max_new=TRANSLATE_REF_STEPS)
        tgt = torch.cat([torch.full((n, 1), cfg32.eos_token_id, device=dev), ref_tokens], 1)
        enc = {}
        logits = {}
        for label, cfg, params in (("bf16", bf16.cfg, bf16.params), ("f32", cfg32, p32)):
            enc[label] = m2m.encode(params, cfg, src, mask)
            logits[label] = m2m.decode(params, cfg, tgt[:, :-1], enc[label], mask)
        bf16_tokens = m2m.generate_greedy(bf16.params, bf16.cfg, src, None,
                                          max_new=TRANSLATE_REF_STEPS)
    torch.cuda.synchronize()
    check(enc["bf16"].shape == (n, t, cfg32.d_model) and enc["bf16"].dtype == torch.bfloat16,
          f"encoder states {enc['bf16'].shape} {enc['bf16'].dtype}")
    e_bf, e_32 = enc["bf16"].float()[mask], enc["f32"][mask]
    err = (e_bf - e_32).abs().max().item()
    scale = e_32.abs().max().item()
    log(f"reference: SMALL100 encoder states max_abs_err={err:.6g} tol={rel_tol * scale:.6g}")
    check(bool(torch.isfinite(e_bf).all()) and err <= rel_tol * scale,
          "SMALL100 encoder states disagree")
    rows = n * TRANSLATE_REF_STEPS
    ties_only = compare_logits("SMALL100 teacher-forced logits",
                               logits["bf16"].reshape(rows, -1), logits["f32"].reshape(rows, -1),
                               logit_rel_tol, (rows, cfg32.vocab_size))
    check(ties_only, "SMALL100 greedy tokens differ beyond a tie")
    logit_err = (logits["bf16"] - logits["f32"]).abs().max().item()
    same = (bf16_tokens == ref_tokens).all(1).tolist()
    first_diff = [int((r != q).nonzero()[0]) if not ok else None
                  for r, q, ok in zip(bf16_tokens, ref_tokens, same)]
    log(f"reference: SMALL100 greedy {TRANSLATE_REF_STEPS} steps, bf16 equal to float32 on "
        f"{sum(same)}/{n} sources; first differing step {first_diff}")
    # up to its first differing step a source's bf16 run saw the float32
    # prefix, so the float32 logits there say whether the two picks tie
    for i, j in enumerate(first_diff):
        if j is not None:
            row = logits["f32"][i, j]
            gap = (row[ref_tokens[i, j]] - row[bf16_tokens[i, j]]).item()
            check(gap <= 2 * logit_err, f"SMALL100 greedy, source {i}: step {j} picks a token "
                  f"{gap:.6g} below float32's, beyond a tie ({2 * logit_err:.6g})")
    del p32
    return {"encoder_max_abs_err": err, "encoder_max_abs_ref": scale,
            "logits_max_abs_err": logit_err, "greedy_equal_sources": sum(same),
            "greedy_first_diff": first_diff}


def rest_of_serving_phase(engine: WhisperEngine, dev: torch.device) -> dict:
    """Phase 11: (a) REST, (b) live diarization and translation, (c) the
    translation model against float32."""
    import shutil
    import tempfile

    from whisperlive_tpu_torch.translation import TorchTranslator

    t_start = time.monotonic()
    result = {"rest": rest_phase(engine)}
    model_dir = tempfile.mkdtemp(prefix="chip_smoke_small100_")
    try:
        t0 = time.monotonic()
        write_small100_dir(model_dir, dev)
        result["small100_write_s"] = time.monotonic() - t0
        result["live"] = live_phase(engine, model_dir)
        result["translation_reference"] = translation_reference(model_dir, dev)
    finally:
        TorchTranslator._shared.pop(model_dir, None)
        shutil.rmtree(model_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    result["phase_s"] = time.monotonic() - t_start
    log(f"phase 11: {result['phase_s']:.6g} s")
    return result


# ---------------------------------------------------------------------------
# Phase 12: tensor and data parallelism
# ---------------------------------------------------------------------------

PAR_TP = 2
PAR_STEPS = 8  # teacher-forced decode steps after the prefill, (b)
# tokens a window in (b) and (e): a tp = 2 step takes ~0.3 s over gloo (16
# until the script's time limit cut it)
PAR_MAX_NEW = 8
# of max|ref|, as every bf16 logits comparison of this script: the tp = 2
# partial sums meet in another order (rounded to bf16 before the reduce),
# and on this card two bf16 orders of the tp = 1 engine (kernels against
# their plain versions) already part by ~1.6% of max|ref|
PAR_REL_TOL = 5e-2
PAR_DP_WINDOWS_S = (7.0, 9.0)  # (c): one window per data replica
PAR_TRAIN_LAYERS = 2  # (d): the fine-tune's depth, cut from 32 + 32 for the time limit
# (c): the data replicas' depth (encoder and decoder layers), cut from
# 32 + 32 to hold the script's time limit; widths stay MODEL's
PAR_DP_LAYERS = 8
PAR_TRAIN_REL_TOL = 1e-3
# a collective waits this long for the other rank before failing the phase
PAR_TIMEOUT_S = 300.0
# the ranks' device type ("cpu" only to rehearse the phase without a card)
PAR_DEVICE = "cuda"
# the module settings rank 1 takes from rank 0 (a rehearsal changes them)
PAR_SETTINGS = ("MODEL", "PAR_DEVICE", "PAR_STEPS", "PAR_TRAIN_LAYERS", "PAR_DP_LAYERS",
                "PAR_DP_WINDOWS_S",
                "CONT_SESSION_S", "MAX_NEW_TOKENS", "TRAIN_TOKENS", "CONT_SLOTS", "BATCH",
                "PAR_MAX_NEW", "PAR_SPEC_SLOTS", "DRAFT_MODEL")


def dp_config() -> wmod.WhisperConfig:
    """(c)'s configuration: MODEL at full width, PAR_DP_LAYERS encoder and
    PAR_DP_LAYERS decoder layers."""
    return wmod.WHISPER_CONFIGS[MODEL].replace(n_audio_layer=PAR_DP_LAYERS,
                                               n_text_layer=PAR_DP_LAYERS)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free_cache(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
# phase 5's pool geometry
PAR_POOL = dict(n_slots=CONT_SLOTS, steps_per_chunk=8, cross_ctx=640, enc_buckets=(512, 1500),
                prompt_pad=192, ring=128)
# the row-parallel reduces of models/whisper.py and their host seconds,
# counted by count_reduces
REDUCES = {"n": 0, "s": 0.0}


def count_reduces() -> None:
    """Count and time (host clock) every all-reduce of a row-parallel
    linear: a wrapper around parallel.mesh.reduce_from_model, which
    models/whisper.py looks up at each call. Over gloo a reduce of a card
    tensor copies it to the host, so its host time includes the wait for
    the kernels queued before it."""
    from whisperlive_tpu_torch.parallel import mesh as pmesh

    plain = pmesh.reduce_from_model

    def counted(x):
        REDUCES["n"] += 1
        t0 = time.perf_counter()
        out = plain(x)
        REDUCES["s"] += time.perf_counter() - t0
        return out

    pmesh.reduce_from_model = counted


def counting_engine_class():
    from whisperlive_tpu_torch.parallel.serve_multihost import MultihostContinuousEngine

    class CountingMultihostEngine(MultihostContinuousEngine):
        """The op-log engine, with each op kind's kernel launches, row
        reduces, calls and host seconds summed (on the leader and on the
        follower alike)."""

        def _count(self, kind, fn, *args, **kw):
            stats = self.op_stats.setdefault(kind, {"calls": 0, "s": 0.0, "reduces": 0,
                                                    "launches": dict.fromkeys(KERNELS, 0)})
            before, n0 = dict(_kernels.launches), REDUCES["n"]
            sync(self.eng.device)
            t0 = time.monotonic()
            out = fn(*args, **kw)
            sync(self.eng.device)
            stats["s"] += time.monotonic() - t0
            stats["calls"] += 1
            stats["reduces"] += REDUCES["n"] - n0
            for k in KERNELS:
                stats["launches"][k] += _kernels.launches[k] - before[k]
            return out

        def insert(self, *args, **kw):
            return self._count("insert", super().insert, *args, **kw)

        def step(self):
            return self._count("step", super().step)

    CountingMultihostEngine.op_stats = None
    return CountingMultihostEngine


def per_op(stats: dict, steps_per_chunk: int) -> dict:
    """Launches and reduces per decode step and per insert, and the host
    time of a step, from an engine's op_stats."""
    out = {}
    for kind, unit in (("step", steps_per_chunk), ("insert", 1)):
        st = stats.get(kind)
        if not st or not st["calls"]:
            continue
        n = st["calls"] * unit
        out[kind] = {"calls": st["calls"], "host_ms": st["s"] / n * 1e3,
                     "reduces": st["reduces"] / n,
                     "launches": {k: v / n for k, v in st["launches"].items() if v}}
    return out


def greedy_logits(engine: WhisperEngine, cross: dict, prompt: list[int], sot: int, steps: int,
                  forced: list[int] | None = None) -> tuple[list[torch.Tensor], list[int]]:
    """The prefill's and `steps` decode steps' logits [V] of item 0, each
    step fed the previous argmax (or `forced`'s token): (logits, tokens)."""
    cfg, dev = engine.cfg, engine.device
    prompt_arr, prompt_len = engine._pad_prompts([prompt])
    prompts, plen = engine._tensor(prompt_arr), engine._tensor(prompt_len)
    pad = prompt_arr.shape[1]
    tokens = []
    with torch.inference_mode():
        self_kv = wmod.init_self_kv(cfg, 1, pad + steps + 1, device=dev)
        logits, _ = wmod.decode_prefill(engine.params, cfg, prompts, plen, self_kv, cross,
                                        sot_idx=engine._tensor(np.asarray([sot], np.int32)))
        out = [logits[0].float()]
        for i in range(steps + 1):
            tokens.append(forced[i] if forced is not None else int(out[-1].argmax()))
            if i == steps:
                break
            t = torch.tensor([tokens[-1]], dtype=torch.int32, device=dev)
            out.append(wmod.decode_step(engine.params, cfg, t, plen + i, pad + i, plen, pad,
                                        self_kv, cross)[0].float())
    return out, tokens


def parallel_profile(cb, chunks: int = 2) -> dict:
    """torch.profiler over `chunks` step chunks of the leader's pool with
    three slots decoding: the device's busy share of the wall time (CUDA
    event time over wall), the collectives' device share (their
    device-host copies' CUDA time over wall) and their host share (the
    host time inside the row-parallel reduces over wall, which with gloo
    includes the wait for the kernels queued before each reduce)."""
    from torch.profiler import ProfilerActivity, profile

    prompt, sot = cb.eng.build_prompt(
        backends_mod.transcribe_options_from_session(SessionOptions(language="en")),
        language="en")
    windows = np.zeros((3, 480000), np.float32)
    for i in range(3):
        windows[i, :96000] = speech_like(6.0, 20 + i)
    cb.insert(windows, [prompt] * 3, [sot] * 3, [True] * 3, [0, 1, 2], [0.0] * 3, [True] * 3,
              [1.0] * 3, [cb.ring - 1] * 3, enc_ctx=512)
    cb.step()
    r0 = dict(REDUCES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(chunks):
            cb.step()
        wall = time.monotonic() - t0
    events = prof.key_averages()
    on_card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    n = chunks * cb.steps_per_chunk
    busy = device_us(on_card) / 1e6 / wall if on_card else None
    copies = device_us(on_card, re.compile("[Mm]emcpy")) / 1e6 / wall if on_card else None
    host = (REDUCES["s"] - r0["s"]) / wall
    out = {"steps": n, "wall_ms_per_step": wall / n * 1e3, "device_busy_share": busy,
           "collective_copy_device_share": copies, "collective_host_share": host,
           "reduces_per_step": (REDUCES["n"] - r0["n"]) / n}
    log(f"tp={PAR_TP} step profile (rank 0, {n} steps, 3 of {cb.n_slots} slots decoding): "
        f"wall {out['wall_ms_per_step']:.6g} ms a step under the profiler, "
        + ("device time not measured (no CUDA events)" if busy is None else
           f"device busy share {busy:.6g}, device-host copies' share {copies:.6g}")
        + f", host share inside the row-parallel reduces {host:.6g} "
        f"({out['reduces_per_step']:.6g} reduces a step)")
    return out


def parallel_tp_serving(rank: int, dev: torch.device, engine, ops_port: int) -> dict:
    """(b) tp = 2 at large-v3, 32 + 32 layers: each rank builds the engine
    from the seed's whole tree and keeps its heads; rank 0 serves phase 5's
    sessions through the op log and rank 1 replays it; then, on both ranks
    in step, the teacher-forced and greedy comparison with the tp = 1
    engine (rank 0's phase-4 engine, the same weights)."""
    from whisperlive_tpu_torch.parallel import multihost
    from whisperlive_tpu_torch.parallel import serve_multihost as smh

    import torch.distributed as dist

    cfg = wmod.WHISPER_CONFIGS[MODEL]
    sh = multihost.multihost_shardings(tp=PAR_TP)
    check(sh.tp == PAR_TP and sh.dp == 1, f"grid dp={sh.dp} x tp={sh.tp}")
    t0 = time.monotonic()
    params = wmod.init_params(cfg, SEED, torch.bfloat16, dev)
    eng2 = WhisperEngine(cfg, params, device=dev, batch_buckets=(1, 2, BATCH), decoder_int8=True,
                         cross_kv_bits=8,
                         tokenizer=VisibleTokenizer(TokenSpec(cfg.n_vocab, multilingual=True)),
                         shardings=sh)
    del params
    sync(dev)
    free_cache(dev)
    build_s = time.monotonic() - t0
    q = eng2.params["decoder"]["layers"]["attn"]["q"]
    check(tuple(q["w8"].shape) == (cfg.n_text_layer, cfg.n_text_state,
                                   cfg.n_text_state // PAR_TP), f"rank {rank}'s q slice")
    log(f"rank {rank}: tp={PAR_TP} engine (int8 decoder, int8 cross-KV, "
        f"{cfg.n_text_head // PAR_TP} heads a rank) built in {build_s:.6g} s")
    engine_cls = counting_engine_class()
    out = {"build_s": build_s}
    if rank == 0:
        leader = smh.OpLeader(ops_port, n_followers=1)
        cb = engine_cls(eng2, leader=leader, **PAR_POOL)
        cb.op_stats = {}
        cs = ContinuousScheduler(eng2, cb=cb)
        window = BatchScheduler(eng2, max_batch_size=BATCH)  # never started: not replayed
        cs.start()
        try:
            backend = CountingBackend(window, model_name=MODEL, continuous_scheduler=cs,
                                      continuous_only=True)
            sessions = [
                dict(uid="tp-en", language="en", audio=speech_like(CONT_SESSION_S, 5)),
                dict(uid="tp-detect", language=None, audio=speech_like(CONT_SESSION_S, 6),
                     use_vad=False),
                dict(uid="tp-late", language="en", audio=speech_like(CONT_SESSION_S - 2.0, 7),
                     delay_s=2.0),
            ]
            backends_mod.STREAMING_MAX_NEW_TOKENS = PAR_MAX_NEW
            sockets, wall = serve(backend, sessions)
        finally:
            backends_mod.STREAMING_MAX_NEW_TOKENS = MAX_NEW_TOKENS
            cs.stop()
        launches = dict(_kernels.launches)
        # a tp = 2 call over gloo on one card decodes a 48-token window in
        # 15-22 s: the call in flight at a session's end and the tail's call
        # make two a session, unless the first commits it all
        check_calls(backend, [s["uid"] for s in sessions], len(sessions))
        check_sockets(sockets)
        check_path(f"tp={PAR_TP} continuous path (rank 0)", launches, CONTINUOUS_PATH)
        ts = cs.tick_stats
        out.update(sessions_wall_s=wall, backend_calls=len(backend.calls), chunks=ts["ticks"],
                   steps=cb.gstep, step_host_ms=ts["step_s"] / max(cb.gstep, 1) * 1e3,
                   launches=launches)
        out["profile"] = parallel_profile(cb)
        serving_stats = per_op(cb.op_stats, cb.steps_per_chunk)
        out["op_log"] = dict(leader.stats, bytes_per_op=leader.stats["bytes"]
                             / max(leader.stats["ops"], 1))
        cb.stop_followers()
    else:
        cb = engine_cls(eng2, **PAR_POOL)
        cb.op_stats = {}
        chan = smh.OpFollower(("127.0.0.1", ops_port))
        out["replayed_ops"] = smh.run_follower(cb, chan)
        chan.close()
        serving_stats = per_op(cb.op_stats, cb.steps_per_chunk)
    # every rank's per-op figures (the profile window's ops included) on both
    gathered = [None, None]
    dist.all_gather_object(gathered, serving_stats)
    for r, st in enumerate(gathered if rank == 0 else ()):
        for kind, figures in st.items():
            log(f"rank {r} per {kind} (over {figures['calls']} {kind} ops): kernel launches "
                f"{figures['launches']}, row-parallel all-reduces {figures['reduces']:.6g}, "
                f"host time {figures['host_ms']:.6g} ms")
    out["per_rank"] = gathered
    step0 = gathered[0].get("step")
    check(step0 is not None and step0["reduces"] == 3 * cfg.n_text_layer,
          f"a tp={PAR_TP} decode step must all-reduce 3 x {cfg.n_text_layer} times")
    check(all(g.get("step", {}).get("launches") == step0["launches"] for g in gathered),
          "the ranks launched different kernels a step")

    # teacher-forced and greedy against the tp = 1 engine, both ranks in step
    opts = backends_mod.transcribe_options_from_session(SessionOptions(language="en"))
    prompt, sot = eng2.build_prompt(opts, language="en")
    audio = np.zeros((1, 480000), np.float32)
    audio[0, :128000] = speech_like(8.0, 40)
    ref = [None]
    if rank == 0:
        _, cross1 = engine.prepare(audio)
        ref_logits, ref_tokens = greedy_logits(engine, cross1, prompt, sot, PAR_STEPS)
        ref = [ref_tokens]
        # the card's bf16 noise between two orders at tp = 1: the plain path
        # teacher forced on the same tokens
        plain_logits = plain_run(lambda: greedy_logits(
            engine, engine.prepare(audio)[1], prompt, sot, PAR_STEPS, forced=ref_tokens)[0])
        floor = [(a - b).abs().max().item() for a, b in zip(plain_logits, ref_logits)]
    dist.broadcast_object_list(ref, src=0)
    _, cross2 = eng2.prepare(audio)
    forced_logits, _ = greedy_logits(eng2, cross2, prompt, sot, PAR_STEPS, forced=ref[0])
    free_logits, tokens2 = greedy_logits(eng2, cross2, prompt, sot, PAR_STEPS)
    if rank == 0:
        errs = []
        for i, (a, b) in enumerate(zip(forced_logits, ref_logits)):
            err, scale = (a - b).abs().max().item(), b.abs().max().item()
            errs.append(err)
            check(bool(torch.isfinite(a).all()) and a.shape == (cfg.n_vocab,),
                  f"tp={PAR_TP} logits at step {i}")
            check(err <= PAR_REL_TOL * scale, f"tp={PAR_TP} teacher-forced logits at step {i}: "
                  f"max_abs_err {err} over {PAR_REL_TOL} x max|ref| {scale}")
        first = next((i for i, (a, b) in enumerate(zip(tokens2, ref[0])) if a != b), None)
        gap = None
        if first is not None:
            b = ref_logits[first]
            gap = (b[ref[0][first]] - b[tokens2[first]]).item()
            check(gap <= 2 * max(errs), f"tp={PAR_TP} greedy tokens part at step {first} by a "
                  f"tp=1 logit gap {gap}, more than a tie (2 x {max(errs)})")
        top2 = [torch.topk(b, 2).values for b in ref_logits]
        margins = [(t[0] - t[1]).item() for t in top2]
        log(f"tp={PAR_TP} against tp=1 (prefill + {PAR_STEPS} steps): teacher-forced max_abs_err "
            f"per step {[round(e, 6) for e in errs]} (tol {PAR_REL_TOL} x max|ref| = "
            f"{PAR_REL_TOL * ref_logits[0].abs().max().item():.6g} at the prefill; tp=1's plain "
            f"path against its kernels on the same tokens {[round(e, 6) for e in floor]}); greedy "
            f"tokens {'equal' if first is None else f'part at step {first}, tp=1 gap {gap:.6g}'}"
            f"; tp=1 top-2 margins {[round(m, 4) for m in margins]}")
        out.update(teacher_forced_max_abs_err=errs, tp1_plain_max_abs_err=floor,
                   greedy_first_divergence=first,
                   greedy_gap=gap, top2_margins=margins)
    del cross2
    return out, eng2


# (e): the window route under tp = 2, on the op log
PAR_WINDOW_S = (8.0, 6.0)  # the greedy window batch (and each alone, (v) and (vi))
PAR_REST_S = 12.0  # the REST raw upload: one window
PAR_SPEC_SLOTS = 2  # the mixed mode's speculative pool
PAR_WINDOW_PARTS = {  # the kernels each part of (e) must launch on every rank
    "window": ("fused_attention", "int8_matmul", "int8_matmul_t", "cross_attention_int8"),
    "window.spec": ("cross_attention_int8_window",),
    "main": ("cross_attention_int8_skip",),
    "spec": ("cross_attention_int8_skip", "cross_attention_int8_skip_window"),
}


def op_part(target: str, op: str) -> str:
    """The part of (e) an op belongs to: its target, with the window
    engine's speculative calls apart."""
    return f"{target}.spec" if op.startswith("spec.") else target


def add_launches(counts: dict, part: str, before: dict) -> None:
    row = counts.setdefault(part, dict.fromkeys(KERNELS, 0))
    for k in KERNELS:
        row[k] += _kernels.launches[k] - before[k]


def counting_leader_class():
    import contextlib

    from whisperlive_tpu_torch.parallel import serve_multihost as smh

    class CountingLeader(smh.OpLeader):
        """The op log's leader, with each part's kernel launches summed
        while its ops run (under the dispatch lock, so only they launch)."""

        counts: dict = {}

        @contextlib.contextmanager
        def dispatch(self, target, op, payload=None):
            with super().dispatch(target, op, payload):
                before = dict(_kernels.launches)
                try:
                    yield
                finally:
                    add_launches(self.counts, op_part(target, op), before)

    return CountingLeader


def count_replays(targets: dict, counts: dict) -> None:
    """The follower's side of CountingLeader: each target's replays."""
    for name, target in targets.items():
        plain = target.replay

        def replay(op, payload, name=name, plain=plain):
            before = dict(_kernels.launches)
            try:
                plain(op, payload)
            finally:
                add_launches(counts, op_part(name, op), before)

        target.replay = replay


def tp1_logits(engine: WhisperEngine, audio: np.ndarray, options: TranscribeOptions,
               forced: list[int], enc_ctx: int | None = None) -> list[torch.Tensor]:
    """The tp = 1 engine's logits over the prefill and len(forced) - 1 steps
    fed `forced`, for a window (enc_ctx None: the window route's whole
    30 s encode; else the pool's encoder bucket)."""
    n = mel_ops.N_SAMPLES if enc_ctx is None else enc_ctx * 2 * mel_ops.HOP_LENGTH
    padded = np.zeros((1, n), np.float32)
    padded[0, :min(len(audio), n)] = audio[:n]
    with torch.inference_mode():
        _, cross = engine._prepare(engine._tensor(padded))
    prompt, sot = engine.build_prompt(options, language="en")
    return greedy_logits(engine, cross, prompt, sot, len(forced) - 1, forced=forced)[0]


def tie_rule(label: str, got, want, logits_fn, tie: float, eot: int,
             beam: bool = False) -> dict:
    """tp = 2's tokens equal tp = 1's, or part only at a tie: at the first
    divergence tp = 1's logit gap between its token and tp = 2's (teacher
    forced on tp = 1's tokens) is within `tie` (twice (b)'s largest
    teacher-forced error); for a beam, whose choice is not the argmax, the
    gap's size. Prints the tp = 1 top-2 margins along the stream."""
    got, want = [int(t) for t in got], [int(t) for t in want]
    check(len(got) > 0, f"{label}: tp=2 decoded no token")
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if first is None and len(got) != len(want):
        first = min(len(got), len(want))
    forced = want[:first] + [0] if first is not None else want + [0]
    logits = logits_fn(forced)
    margins = [(t[0] - t[1]).item() for t in (torch.topk(x, 2).values for x in logits)]
    gap = None
    if first is not None:
        b = logits[first]
        a_tok = want[first] if first < len(want) else eot
        g_tok = got[first] if first < len(got) else eot
        gap = (b[a_tok] - b[g_tok]).item()
        check((abs(gap) if beam else gap) <= tie, f"{label}: tp=2 tokens part from tp=1's at "
              f"{first} by a tp=1 logit gap {gap}, more than a tie ({tie})")
    log(f"{label}: {len(got)} tokens, "
        + ("equal to tp=1's" if first is None else f"part from tp=1's at {first}, gap {gap:.6g}")
        + f"; tp=1 top-2 margins {[round(m, 4) for m in margins]}")
    return {"tokens": len(got), "first_divergence": first, "gap": gap, "margins": margins}


def parallel_window_serving(rank: int, dev: torch.device, engine, eng2, ops_port: int,
                            tie: float) -> dict:
    """(e) The window route under tp = 2 on the op log, on (b)'s tp = 2
    engine: each rank also builds a 2-decoder-layer random draft sliced at
    tp = 2 (seed SEED + 1, as phase 6), the window engine with its
    SpeculativeDecoder, a plain pool and the mixed mode's speculative pool
    (the targets a one-host `--tp 2` server builds), in the same order.
    Rank 0 serves, every window PAR_MAX_NEW tokens: (i) two greedy windows
    as one batch on the window scheduler and one no_repeat_ngram request,
    which the backend routes there; (ii) a word-timestamps window; (iii) a
    REST raw upload through rest.handle_transcription on a window-only
    backend (`--no_continuous_batching`); (iv) a `--beam_mode refresh`
    beam-5 full re-decode while a continuous session runs on the pool;
    (v) a lone greedy request on the window-path SpeculativeDecoder; (vi)
    a full re-decode on the mixed pool. Rank 1 replays. Tokens against the
    tp = 1 engine of phases 4-11 by the tie rule; each rank's launches by
    part; the follower's replayed ops equal to the leader's published."""
    import functools
    import threading

    import torch.distributed as dist

    from whisperlive_tpu_torch.parallel import serve_multihost as smh

    t_start = time.monotonic()
    sh = eng2.shardings
    dcfg = wmod.WHISPER_CONFIGS[DRAFT_MODEL]
    dparams = wmod.init_params(dcfg, SEED + 1, torch.bfloat16, dev)
    draft2 = WhisperEngine(dcfg, dparams, device=dev, batch_buckets=(1,), decoder_int8=True,
                           cross_kv_bits=8, shardings=sh,
                           tokenizer=VisibleTokenizer(TokenSpec(dcfg.n_vocab, multilingual=True)))
    del dparams
    # the beamed decode's segments are a program of their own: every rank
    # sets them before the first op (the window engine's signature holds it)
    eng2.enable_beam_chunk(BEAM_CHUNK)
    spec_dec = SpeculativeDecoder(eng2, draft2, k=SPEC_K)
    leader = counting_leader_class()(ops_port, n_followers=1) if rank == 0 else None
    window = smh.MultihostWindowEngine(eng2, leader=leader, spec_decoder=spec_dec)

    def pool(name, **kw):
        return ContinuousScheduler(eng2, pool_factory=functools.partial(
            smh.MultihostContinuousEngine, leader=leader, name=name), **kw)

    main = pool("main", **PAR_POOL)
    mixed_pool = pool("spec", draft_engine=draft2, spec_k=SPEC_K, n_slots=PAR_SPEC_SLOTS,
                      steps_per_chunk=4, cross_ctx=640, enc_buckets=(512, 1500),
                      ring=(SPEC_K + 2) * (PAR_MAX_NEW + 2))
    targets = {"window": window, "main": main.cb, "spec": mixed_pool.cb}
    build_s = time.monotonic() - t_start
    out = {"build_s": build_s}
    counts: dict = {}
    if rank != 0:
        count_replays(targets, counts)
        chan = smh.OpFollower(("127.0.0.1", ops_port))
        out["replayed_ops"] = smh.run_follower(targets, chan)
        chan.close()
        out["handles"] = window.live_handles
    else:
        leader.counts = counts
        out.update(window_route_leader(engine, window, main, mixed_pool, spec_dec, tie))
        out["op_log"] = dict(leader.stats)
        out["handles"] = window.live_handles
        leader.stop()
    # every rank's launches by part, and the follower's op count, on both
    gathered = [None, None]
    dist.all_gather_object(gathered, {"counts": counts, "replayed_ops": out.get("replayed_ops"),
                                      "handles": out["handles"]})
    if rank == 0:
        for r, g in enumerate(gathered):
            for part, kernels in PAR_WINDOW_PARTS.items():
                got = g["counts"].get(part, {})
                log(f"rank {r} (e) {part} launches: "
                    f"{ {k: v for k, v in got.items() if v} }")
                for k in kernels:
                    check(got.get(k, 0) > 0, f"rank {r}: (e) {part} never launched {k}")
            check(g["handles"] == 0, f"rank {r}: (e) left {g['handles']} window handles")
        published = out["op_log"]["ops"] - 1  # less the hello (read before the stop)
        check(gathered[1]["replayed_ops"] == published,
              f"(e) the follower replayed {gathered[1]['replayed_ops']} ops, the leader "
              f"published {published}")
        out["per_rank_launches"] = [g["counts"] for g in gathered]
        out["phase_s"] = time.monotonic() - t_start
        log(f"(e) window route under tp={PAR_TP}: {published} ops replayed, op log "
            f"{out['op_log']}, {out['phase_s']:.6g} s")
    del window, main, mixed_pool, spec_dec, draft2
    free_cache(dev)
    return out


def window_route_leader(engine, window, main, mixed_pool, spec_dec, tie) -> dict:
    """Rank 0's side of (e): the six parts, each timed on the host clock,
    with its tokens held to tp = 1's."""
    import threading

    from whisperlive_tpu_torch.engine.scheduler import BatchRequest
    from whisperlive_tpu_torch.parallel import serve_multihost as smh

    out = {}
    eot = engine.spec.eot
    backends_mod.STREAMING_MAX_NEW_TOKENS = PAR_MAX_NEW
    greedy = TranscribeOptions(language="en", temperatures=(0.0,), log_prob_threshold=None,
                               no_speech_threshold=None, compression_ratio_threshold=None,
                               max_new_tokens=PAR_MAX_NEW)
    session = SessionOptions(language="en", use_vad=False)
    audios = [speech_like(s, 70 + i) for i, s in enumerate(PAR_WINDOW_S)]
    win = smh.MultihostBatchScheduler(window, max_batch_size=BATCH, batch_window_ms=200)
    win_spec = smh.MultihostBatchScheduler(window, max_batch_size=BATCH,
                                           spec_decoder=window.speculative)
    ref_win = BatchScheduler(engine, max_batch_size=BATCH, batch_window_ms=200)
    ref_pool = ContinuousScheduler(engine, **PAR_POOL)

    def batch_of(sched, opts, audios, start=False):
        futs = [sched.submit(BatchRequest(audio=a, options=opts, uid=f"e{i}"))
                for i, a in enumerate(audios)]
        if start:
            sched.start()
        return [f.result(timeout=PAR_TIMEOUT_S) for f in futs]

    def timed(name, fn):
        t0 = time.monotonic()
        r = fn()
        out.setdefault("host_s", {})[name] = time.monotonic() - t0
        return r

    def window_logits(audio, opts):
        return lambda forced: tp1_logits(engine, audio, opts, forced)

    try:
        main.start()
        ref_win.start()
        ref_pool.start()
        # (i) a greedy batch of two, and a no_repeat_ngram request
        got = timed("batch", lambda: batch_of(win, greedy, audios, start=True))
        want = batch_of(ref_win, greedy, audios)
        out["batch"] = [tie_rule(f"(e)(i) window batch item {i}", g.raw_tokens, w.raw_tokens,
                                 window_logits(a, greedy), tie, eot)
                        for i, (g, w, a) in enumerate(zip(got, want, audios))]

        class Ngram(CountingBackend):
            def _adjust_options(self, topts, chunk):
                return dataclasses.replace(topts, no_repeat_ngram_size=3)

        ngram, ref_ngram = Ngram(win, continuous_scheduler=main), Ngram(ref_win)
        nopts = dataclasses.replace(greedy, no_repeat_ngram_size=3)
        check(ngram._pick_scheduler(nopts, PAR_WINDOW_S[1]) is win,
              "(e)(i) no_repeat_ngram must route to the window scheduler")
        g = timed("ngram", lambda: asyncio.run(ngram.transcribe(
            audios[1], session, language="en", uid="ngram")))
        w = asyncio.run(ref_ngram.transcribe(audios[1], session, language="en", uid="ngram"))
        out["ngram"] = tie_rule("(e)(i) no_repeat_ngram window", g.raw_tokens, w.raw_tokens,
                                window_logits(audios[1], nopts), tie, eot)
        # (ii) word timestamps
        wopts = dataclasses.replace(greedy, word_timestamps=True)
        (g,) = timed("words", lambda: batch_of(win, wopts, audios[:1]))
        (w,) = batch_of(ref_win, wopts, audios[:1])
        words = [wd for s in g.segments for wd in (s.words or [])]
        check(len(words) > 0, "(e)(ii) the word-timestamps window produced no words")
        out["words"] = dict(tie_rule("(e)(ii) word-timestamps window", g.raw_tokens,
                                     w.raw_tokens, window_logits(audios[0], wopts), tie, eot),
                            n_words=len(words),
                            n_words_tp1=sum(len(s.words or []) for s in w.segments))
        # (iii) REST: a raw upload on a window-only backend
        upload = speech_like(PAR_REST_S, 75)
        fields = {"response_format": "verbose_json", "language": "en"}
        rest_backend, ref_rest = CountingBackend(win), CountingBackend(ref_win)
        r = timed("rest", lambda: rest_request(rest_backend, fields, wav_bytes(upload)))
        check(r["routes"] == {"window": 1, "continuous": 0}, f"(e)(iii) routes {r['routes']}")
        rest_request(ref_rest, fields, wav_bytes(upload))
        ropts = backends_mod.transcribe_options_from_session(session, "en")
        out["rest"] = dict(tie_rule(
            "(e)(iii) REST upload", rest_backend.calls[0]["result"].raw_tokens,
            ref_rest.calls[0]["result"].raw_tokens,
            window_logits(ref_rest.calls[0]["audio"], ropts), tie, eot), seconds=r["seconds"])
        # (iv) a hybrid-beam full re-decode beside a live continuous session
        hybrid = CountingBackend(win, continuous_scheduler=main, beam_size=BEAM,
                                 beam_mode="refresh")
        check(hybrid.hybrid_beam, "(e)(iv) the backend is not in hybrid beam mode")
        live: list = []

        def session_run():
            for i, a in enumerate(audios):
                req = BatchRequest(audio=a, options=greedy, uid=f"live{i}")
                t0 = time.monotonic()
                live.append((main.submit(req).result(timeout=PAR_TIMEOUT_S),
                             time.monotonic() - t0))

        th = threading.Thread(target=session_run)
        th.start()
        time.sleep(0.5)  # the session's first window is in the pool
        g = timed("hybrid_beam", lambda: asyncio.run(hybrid.transcribe(
            audios[0], session, language="en", uid="beam", window_anchor_s=0.0)))
        th.join(timeout=PAR_TIMEOUT_S)
        check(not th.is_alive() and len(live) == len(audios),
              "(e)(iv) the continuous session did not finish beside the beamed decode")
        check(hybrid.hybrid_stats["beamed_fulls"] == 1, f"(e)(iv) {hybrid.hybrid_stats}")
        bopts = backends_mod.transcribe_options_from_session(session, "en", beam_size=BEAM)
        (w,) = batch_of(ref_win, bopts, audios[:1])
        out["hybrid_beam"] = dict(tie_rule(
            "(e)(iv) beam-5 full re-decode", g.raw_tokens, w.raw_tokens,
            window_logits(audios[0], bopts), tie, eot, beam=True),
            live_windows=[len(r.raw_tokens) for r, _ in live],
            live_latency_s=[s for _, s in live])
        for i, (r, _) in enumerate(live):
            check(len(r.raw_tokens) > 0, f"(e)(iv) live window {i} decoded no token")
        # (v) a lone greedy request on the window-path SpeculativeDecoder
        win_spec.start()
        (g,) = timed("speculative", lambda: batch_of(win_spec, greedy, audios[:1]))
        check(spec_dec.stats["windows"] == 1, f"(e)(v) speculative stats {spec_dec.stats}")
        out["speculative"] = dict(tie_rule(
            "(e)(v) window-path speculation", g.raw_tokens, want[0].raw_tokens,
            window_logits(audios[0], greedy), tie, eot), stats=dict(spec_dec.stats))
        # (vi) a full re-decode on the mixed mode's speculative pool
        mixed = CountingBackend(win, spec_scheduler=mixed_pool)
        mixed_pool.start()
        g = timed("mixed", lambda: asyncio.run(mixed.transcribe(
            audios[1], session, language="en", uid="mixed")))
        check(mixed.spec_route_stats["spec_fulls"] == 1, f"(e)(vi) {mixed.spec_route_stats}")
        ref_mixed = CountingBackend(ref_win, continuous_scheduler=ref_pool)
        w = asyncio.run(ref_mixed.transcribe(audios[1], session, language="en", uid="mixed"))
        out["mixed"] = dict(tie_rule(
            "(e)(vi) mixed pool full re-decode", g.raw_tokens, w.raw_tokens,
            lambda forced: tp1_logits(engine, audios[1], greedy, forced, enc_ctx=512), tie, eot),
            rounds=dict(mixed_pool.spec_stats))
    finally:
        for sched in (win, win_spec, main, mixed_pool, ref_win, ref_pool):
            sched.stop()
    ts = main.tick_stats
    out["pool_step_host_ms"] = ts["step_s"] / max(main.cb.gstep, 1) * 1e3
    out["windows"] = {"greedy": 2 + 1 + 1 + 1 + 1, "beam": 1, "mixed": 1}
    log(f"(e) host seconds a request: { {k: round(v, 3) for k, v in out['host_s'].items()} }; "
        f"the pool's step {out['pool_step_host_ms']:.6g} ms")
    return out


def parallel_dp_serving(rank: int, dev: torch.device, ops_port: int) -> dict:
    """(c) dp = 2: two replicas of the whole engine of dp_config (one a
    rank) and 2 x 8 slots; one wave of two windows lands one in each replica
    (the scheduler spreads a wave over the replicas). The tokens must be
    exactly those of a tp = 1 pool on rank 0 on the same weights, each
    window inserted alone there (an insert of one window, as each replica
    sees it: the rows are independent)."""
    from whisperlive_tpu_torch.engine.scheduler import BatchRequest
    from whisperlive_tpu_torch.parallel import multihost
    from whisperlive_tpu_torch.parallel import serve_multihost as smh

    cfg = dp_config()
    sh = multihost.multihost_shardings(tp=1, dp=2)
    check(sh.dp == 2 and sh.tp == 1, "dp grid")
    params = wmod.init_params(cfg, SEED, torch.bfloat16, dev)
    engine_kw = dict(device=dev, batch_buckets=(1, 2, BATCH), decoder_int8=True,
                     cross_kv_bits=8, tokenizer=visible_tokenizer(cfg))
    eng = WhisperEngine(cfg, params, shardings=sh, **engine_kw)
    pool = dict(PAR_POOL, n_slots=2 * CONT_SLOTS)
    opts = TranscribeOptions(language="en", temperatures=(0.0,), log_prob_threshold=None,
                             no_speech_threshold=None, compression_ratio_threshold=None,
                             max_new_tokens=MAX_NEW_TOKENS)
    audios = [speech_like(s, 50 + i) for i, s in enumerate(PAR_DP_WINDOWS_S)]
    out = {}
    if rank == 0:
        leader = smh.OpLeader(ops_port, n_followers=1)
        cb = smh.MultihostContinuousEngine(eng, leader=leader, **pool)
        check(cb.dp_sharded and cb.local_slots == CONT_SLOTS, "the dp pool must shard its slots")
        seated = []
        insert = cb.insert

        def recorded(*args, **kw):
            seated.extend(args[4] if len(args) > 4 else kw["slot_ids"])
            return insert(*args, **kw)

        cb.insert = recorded
        cs = ContinuousScheduler(eng, cb=cb)
        futs = [cs.submit(BatchRequest(audio=a, options=opts, uid=f"dp{i}"))
                for i, a in enumerate(audios)]
        t0 = time.monotonic()
        cs.start()
        try:
            got = [tuple(f.result(timeout=300).raw_tokens) for f in futs]
        finally:
            cs.stop()
            cb.stop_followers()
        wall = time.monotonic() - t0
        replicas = sorted({cb.owner(s) for s in seated})
        check(replicas == [0, 1], f"the windows landed in replicas {replicas}, not both")
        ref_cs = ContinuousScheduler(WhisperEngine(cfg, params, **engine_kw), **PAR_POOL)
        ref_cs.start()
        try:
            want = [tuple(ref_cs.submit(BatchRequest(audio=a, options=opts, uid=f"ref{i}"))
                          .result(timeout=300).raw_tokens) for i, a in enumerate(audios)]
        finally:
            ref_cs.stop()
        check(all(len(t) > 0 for t in got), "a dp window decoded no token")
        check(got == want, f"dp=2 tokens differ from tp=1's: {got} vs {want}")
        log(f"dp=2 ({PAR_DP_LAYERS} + {PAR_DP_LAYERS} layers, 2 x {CONT_SLOTS} slots): windows "
            f"seated in slots {seated} "
            f"(replicas {replicas}), {sum(map(len, got))} tokens equal to the tp=1 pool's, "
            f"{wall:.6g} s wall, op log {leader.stats}")
        out.update(slots=seated, replicas=replicas, tokens=[len(t) for t in got], wall_s=wall,
                   op_log=dict(leader.stats))
    else:
        cb = smh.MultihostContinuousEngine(eng, **pool)
        chan = smh.OpFollower(("127.0.0.1", ops_port))
        out["replayed_ops"] = smh.run_follower(cb, chan)
        chan.close()
    del eng, cb, params
    free_cache(dev)
    return out


def parallel_finetune(rank: int, dev: torch.device) -> dict:
    """(d) One tp = 2 fine-tune step of phase 10's configuration (B =
    TRAIN_BATCH mel [B,3000,128], TRAIN_TOKENS tokens, bf16 compute,
    float32 master weights), the depth cut to PAR_TRAIN_LAYERS + PAR_TRAIN_LAYERS
    layers at full width: its loss within PAR_TRAIN_REL_TOL of tp = 1's on
    rank 0 (the same weights and batch)."""
    from whisperlive_tpu_torch import training
    from whisperlive_tpu_torch.ops import mel as mel_ops
    from whisperlive_tpu_torch.parallel import multihost

    import torch.distributed as dist

    cfg = wmod.WHISPER_CONFIGS[MODEL].replace(
        dtype=torch.bfloat16, n_audio_layer=PAR_TRAIN_LAYERS, n_text_layer=PAR_TRAIN_LAYERS)
    opt = training.make_optimizer(learning_rate=1e-5, warmup_steps=1, total_steps=TRAIN_STEPS)
    audio = np.stack([speech_like(30.0, 60 + i) for i in range(TRAIN_BATCH)])
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.n_vocab, (TRAIN_BATCH, TRAIN_TOKENS + 1)).astype(np.int32)).to(dev)
    batch = {"mel": mel_ops.log_mel_spectrogram(torch.from_numpy(audio).to(dev), cfg.n_mels),
             "tokens_in": tokens[:, :-1], "tokens_out": tokens[:, 1:],
             "loss_mask": torch.ones((TRAIN_BATCH, TRAIN_TOKENS), device=dev)}
    out = {}
    loss1 = [None]
    if rank == 0:
        state = training.init_train_state(cfg, opt, wmod.init_params(cfg, SEED, torch.bfloat16,
                                                                       dev), device=dev)
        t0 = time.monotonic()
        _, loss = training.make_train_step(cfg, opt)(state, batch)
        loss1 = [float(loss)]
        out["tp1_step_s"] = time.monotonic() - t0
        del state
        free_cache(dev)
    dist.broadcast_object_list(loss1, src=0)
    sh = multihost.multihost_shardings(tp=PAR_TP)
    state = training.init_train_state(cfg, opt, wmod.init_params(cfg, SEED, torch.bfloat16, dev),
                                      device=dev, shardings=sh)
    step = training.make_train_step(cfg, opt, shardings=sh)
    _kernels.reset_launches()
    sync(dev)
    t0 = time.monotonic()
    state, loss = step(state, batch)
    sync(dev)
    step_s = time.monotonic() - t0
    loss2 = float(loss)
    rel = abs(loss2 - loss1[0]) / abs(loss1[0])
    check(np.isfinite(loss2), f"rank {rank}: tp={PAR_TP} loss {loss2}")
    check(rel <= PAR_TRAIN_REL_TOL, f"rank {rank}: tp={PAR_TP} loss {loss2} vs tp=1 {loss1[0]}: "
          f"relative {rel} over {PAR_TRAIN_REL_TOL}")
    check(_kernels.launches["fused_attention"] == 0, "the training encoder launched K1")
    log(f"rank {rank}: tp={PAR_TP} fine-tune step ({PAR_TRAIN_LAYERS} + {PAR_TRAIN_LAYERS} layers, "
        f"full width): loss {loss2:.8g} vs tp=1 {loss1[0]:.8g} (relative {rel:.3g}), "
        f"step {step_s:.6g} s")
    out.update(loss_tp2=loss2, loss_tp1=loss1[0], rel=rel, tp2_step_s=step_s)
    del state
    free_cache(dev)
    return out


def parallel_phase(rank: int, coordinator: str, ops_ports: tuple[int, int, int],
                   engine: WhisperEngine | None = None) -> dict:
    """Phase 12 on one rank of a world of two on this card (rank 0 is this
    script's process with the tp = 1 engine of phases 4-11, rank 1 a
    spawned process), through the functions the server CLI calls:
    init_multihost, multihost_shardings, WhisperEngine(shardings=...),
    MultihostContinuousEngine over OpLeader / OpFollower and run_follower,
    with WL_OPS_SECRET set."""
    from whisperlive_tpu_torch.parallel import multihost

    import torch.distributed as dist

    t_start = time.monotonic()
    os.environ.setdefault("WL_OPS_SECRET", "chip-smoke-phase-12")
    check(multihost.init_multihost(coordinator, 1, 0, device=PAR_DEVICE, local_ranks=2,
                                   local_rank=rank, timeout_s=PAR_TIMEOUT_S), "init_multihost")
    dev = multihost.device()
    backend = multihost.backend()
    if rank == 0:
        print(f"parallel backend: {backend} ({torch.cuda.device_count()} card(s), 2 ranks "
              f"on {dev})", flush=True)
    check(backend == ("gloo" if dev.type != "cuda" or torch.cuda.device_count() < 2 else "nccl"),
          f"backend {backend} for 2 ranks on {torch.cuda.device_count()} card(s)")
    count_reduces()
    out = {"backend": backend, "world": dist.get_world_size()}
    try:
        out["tp_serving"], eng2 = parallel_tp_serving(rank, dev, engine, ops_ports[0])
        tie = [2 * max(out["tp_serving"]["teacher_forced_max_abs_err"]) if rank == 0 else None]
        dist.broadcast_object_list(tie, src=0)
        out["window_route"] = parallel_window_serving(rank, dev, engine, eng2, ops_ports[2],
                                                      tie[0])
        del eng2
        free_cache(dev)
        out["dp_serving"] = parallel_dp_serving(rank, dev, ops_ports[1])
        out["finetune"] = parallel_finetune(rank, dev)
        multihost.barrier("phase-12-end")
    finally:
        dist.destroy_process_group()
    out["phase_s"] = time.monotonic() - t_start
    return out


def parallel_rank_main(index: int, coordinator: str, ops_ports: tuple[int, int, int],
                       settings: dict) -> None:
    """Rank 1 of phase 12, in a process of its own (torch.multiprocessing,
    spawn), with rank 0's PAR_SETTINGS."""
    globals().update(settings)
    backends_mod._DISABLE_GATES = True  # as build_engine sets it on rank 0
    backends_mod.STREAMING_MAX_NEW_TOKENS = MAX_NEW_TOKENS
    if PAR_DEVICE == "cuda":
        _kernels.library()
    parallel_phase(index + 1, coordinator, ops_ports)


def run_parallel_phase(engine: WhisperEngine) -> dict:
    """Spawn rank 1, run rank 0 here, and join rank 1 (which must exit 0)."""
    import socket

    import torch.multiprocessing as mp

    ports = []
    for _ in range(4):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    coordinator = f"127.0.0.1:{ports[0]}"
    settings = {name: globals()[name] for name in PAR_SETTINGS}
    ctx = mp.start_processes(parallel_rank_main,
                             args=(coordinator, tuple(ports[1:]), settings),
                             nprocs=1, join=False, start_method="spawn")
    try:
        result = parallel_phase(0, coordinator, tuple(ports[1:]), engine)
        while not ctx.join(timeout=300):
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    check(all(p.exitcode == 0 for p in ctx.processes), "phase 12's rank 1 failed")
    log(f"phase 12: {result['phase_s']:.6g} s")
    return result


# ---------------------------------------------------------------------------
# Phase 13: the tooling (profiler, roofline, WER harness, trainers)
# ---------------------------------------------------------------------------

TOOL_DEVICE = "cuda"  # "cpu" rehearses the phase without a card
TOOL_SESSION_S = 3.0  # the profiled session: short, so its trace stays ~100 MB
TOOL_MAX_NEW = 8  # tokens a window in the phase's sessions: one chunk a call
K2_KERNEL = re.compile(r"\bint8_matmul_kernel")
PEAK_BUDGET_S = 30.0
PEAK_SLACK = 1.05  # a measured envelope may read at most this much above nominal
WER_CLIP_S = 3.0
TOOL_TRAIN_STEPS = 20
TOOL_TRAIN_BATCH = 8
TOOL_TRAIN_TOL = 1e-4  # numpy forward of the saved npz against the card's, of max|ref|
ENVELOPES = ("tflops", "int8_gbps", "int8_geps", "bf16_gbps", "bf16_geps", "int8_mm_gbps")


def continuous_backend(engine: WhisperEngine):
    """(CountingBackend, pool) over phase 5's pool configuration, not started."""
    cs = ContinuousScheduler(engine, n_slots=CONT_SLOTS, steps_per_chunk=8, cross_ctx=640,
                             enc_buckets=(512, 1500))
    window = BatchScheduler(engine, max_batch_size=BATCH, batch_window_ms=50)
    return CountingBackend(window, model_name=MODEL, continuous_scheduler=cs), cs


def profiled_session(engine: WhisperEngine, tmp: str) -> dict:
    """The server CLI's main with --profile_dir: its create_backend serves
    the int8 engine of phases 4-12 over phase 5's pool, its server one short
    session in-process (the card's machine has no websockets); the trace
    main's shutdown path writes must name K2 and K5, with K5's events equal
    to its launches, 32 a step."""
    from whisperlive_tpu_torch.cli import run_server
    from whisperlive_tpu_torch.utils import profiling

    backend, cs = continuous_backend(engine)
    trace_dir = os.path.join(tmp, "profile")
    seen = {}

    def create_backend(args):
        backend.scheduler.start()
        cs.start()
        return backend

    def run(server, backend, **kw):
        server.backend, server.backend_name = backend, kw["backend_name"]
        server.client_manager = ClientManager(max_clients=4, max_connection_time=600)
        seen["tracing"] = profiling._active is not None
        _kernels.reset_launches()
        seen["gstep"] = cs.cb.gstep
        seen["ws"] = asyncio.run(run_session(server, backend, uid="profiled", language="en",
                                             audio=speech_like(TOOL_SESSION_S, 30)))

    saved = (run_server.create_backend, TranscriptionServer.run,
             os.environ.get("OMP_NUM_THREADS"))
    run_server.create_backend, TranscriptionServer.run = create_backend, run
    t0 = time.monotonic()
    try:
        run_server.main(["--model", MODEL, "--device", TOOL_DEVICE, "--profile_dir", trace_dir,
                         "--continuous_slots", str(CONT_SLOTS), "--omp_num_threads",
                         str(torch.get_num_threads())])
    finally:
        run_server.create_backend, TranscriptionServer.run = saved[:2]
        if saved[2] is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = saved[2]
    wall = time.monotonic() - t0
    launches = dict(_kernels.launches)
    steps = cs.cb.gstep - seen["gstep"]
    check(seen["tracing"], "--profile_dir did not start the profiler before serving")
    check_calls(backend, ["profiled"], 1)
    check_sockets([seen["ws"]])
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    check(len(files) == 1, f"trace files after shutdown: {files}")
    path = os.path.join(trace_dir, files[0])
    t1 = time.monotonic()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    n_k2 = sum(1 for k in kernels if K2_KERNEL.search(k))
    n_k5 = sum(1 for k in kernels if cross_kernel("Int8Packed", 1).search(k))  # K4 too
    spans = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    out = {"wall_s": wall, "trace_mb": os.path.getsize(path) / 2**20,
           "trace_parse_s": time.monotonic() - t1, "events": len(events),
           "kernel_events": len(kernels), "steps": steps, "k2_events": n_k2,
           "k5_events": n_k5, "launches": launches, "spans": sorted(s for s in spans if s)}
    log(f"profiled session: {wall:.6g} s wall under the profiler, {steps} steps, trace "
        f"{out['trace_mb']:.6g} MiB of {len(events)} events ({len(kernels)} kernels; parsed "
        f"in {out['trace_parse_s']:.6g} s), K2 {n_k2} and K5 {n_k5} kernel events, launch "
        f"counters {launches}, spans {out['spans']}")
    check(n_k2 > 0 and n_k5 > 0, "the trace names no K2 or no K5 kernel")
    check(n_k2 == launches["int8_matmul"], f"K2: {n_k2} trace events, "
          f"{launches['int8_matmul']} launches")
    # K4 (the inserts' prefill) and K5 (the steps) are one kernel instantiation
    n_k4_k5 = launches["cross_attention_int8"] + launches["cross_attention_int8_skip"]
    check(n_k5 == n_k4_k5, f"K4/K5: {n_k5} trace events, {n_k4_k5} launches")
    check(steps > 0 and launches["cross_attention_int8_skip"] == steps * engine.cfg.n_text_layer,
          f"K5 must launch {engine.cfg.n_text_layer} times a step: "
          f"{launches['cross_attention_int8_skip']} over {steps} steps")
    check({"continuous.insert", "continuous.step", "continuous.harvest"} <= spans,
          "the scheduler's spans are missing from the trace")
    os.remove(path)
    return out


def envelopes_and_roofline(engine: WhisperEngine, step: dict) -> dict:
    """measure_effective_peaks at the continuous pool's cross-KV shape, each
    envelope against the nominal peaks, then phase 5's profiled step against
    its roof under the nominal and the measured peaks."""
    from whisperlive_tpu_torch.utils import roofline

    nominal_flops, nominal_bw = roofline.nominal_peaks(
        torch.cuda.get_device_name(0) if TOOL_DEVICE == "cuda" else "")
    _kernels.reset_launches()
    t0 = time.monotonic()
    peaks = roofline.measure_effective_peaks(
        TOOL_DEVICE, seconds_budget=PEAK_BUDGET_S,
        kv_shape=(CONT_SLOTS, engine.cfg.n_text_head,
                  640, engine.cfg.n_text_state // engine.cfg.n_text_head))
    probe_s = time.monotonic() - t0
    log(f"measured envelopes ({probe_s:.6g} s; nominal {nominal_flops / 1e12:.6g} TFLOP/s, "
        f"{nominal_bw / 1e9:.6g} GB/s): " + ", ".join(f"{k} {v:.6g}" for k, v in peaks.items()))
    check(set(peaks) == set(ENVELOPES), f"envelopes measured: {sorted(peaks)}")
    check(_kernels.launches["cross_attention_int8"] > 0 and _kernels.launches["int8_matmul"] > 0,
          "the probes did not launch K4 and K2")
    check(peaks["tflops"] * 1e12 <= PEAK_SLACK * nominal_flops,
          f"tflops {peaks['tflops']:.6g} above {PEAK_SLACK} x nominal")
    for key in ("int8_gbps", "bf16_gbps", "int8_mm_gbps"):
        check(peaks[key] * 1e9 <= PEAK_SLACK * nominal_bw,
              f"{key} {peaks[key]:.6g} above {PEAK_SLACK} x nominal")

    cfg = engine.cfg
    cost = roofline.continuous_step_cost(cfg, step["n_rows"], step["cache_len"],
                                         step["cross_pos"], cross_kv_bits=engine.cross_kv_bits,
                                         weight_bits=8)
    nominal = {"tflops": nominal_flops / 1e12, "int8_gbps": nominal_bw / 1e9,
               "bf16_gbps": nominal_bw / 1e9}
    roof_nominal_ms = roofline.step_time_roof(cost, nominal) * 1e3
    roof_measured_ms = roofline.step_time_roof(cost, peaks) * 1e3
    out = {"peaks": peaks, "probe_s": probe_s, "nominal_tflops": nominal_flops / 1e12,
           "nominal_gbps": nominal_bw / 1e9, "step": step, "step_flops": cost.flops,
           "step_bytes": cost.bytes, "roof_nominal_ms": roof_nominal_ms,
           "roof_measured_ms": roof_measured_ms}
    if step["device_ms"] is None:
        log("roofline of the continuous step: its device time was not measured")
        check(False, "phase 5's profile measured no device time")
        return out
    out["share_nominal"] = roof_nominal_ms / step["device_ms"]
    out["share_measured"] = roof_measured_ms / step["device_ms"]
    log(f"continuous step roofline ({step['n_rows']} rows, cache {step['cache_len']}, "
        f"{step['cross_pos']} cross positions; {cost.flops / 1e9:.6g} GFLOP, "
        f"{cost.bytes / 1e6:.6g} MB): roof {roof_nominal_ms:.6g} ms nominal, "
        f"{roof_measured_ms:.6g} ms measured, against {step['device_ms']:.6g} ms of device "
        f"time: share {out['share_nominal']:.6g} nominal, {out['share_measured']:.6g} measured")
    check(out["share_nominal"] <= 1.0, "the step beat its nominal roof")
    return out


def wer_harness(engine: WhisperEngine, tmp: str) -> dict:
    """cli.eval_wer.run_eval on the int8 engine over phase 5's pool: the
    port's server and client on a speech-like clip, in-process (loopback)."""
    from whisperlive_tpu_torch.audio.io import write_wav
    from whisperlive_tpu_torch.cli import eval_wer

    wav = os.path.join(tmp, "wer.wav")
    write_wav(wav, speech_like(WER_CLIP_S, 31))
    backend, cs = continuous_backend(engine)
    backend.scheduler.start()
    cs.start()
    t0 = time.monotonic()
    try:
        result = eval_wer.run_eval(audio=wav, ref_text=eval_wer.JFK_GROUND_TRUTH, model=MODEL,
                                   backend=backend, out_srt=os.path.join(tmp, "wer.srt"),
                                   transport="loopback")
    finally:
        cs.stop()
        backend.scheduler.stop()
    result["wall_s"] = time.monotonic() - t0
    log(f"WER harness (random weights, no threshold): {json.dumps(result)}")
    check_calls(backend, {c["uid"] for c in backend.calls}, 1)
    check(np.isfinite(result["wer"]) and result["ref_words"] > 0, "the harness gave no WER")
    return result


def trainer_check(arch: str, params: dict) -> float:
    """The numpy forward of the saved parameters against the card's forward
    on one held-out clip: max error over max|ref|."""
    from whisperlive_tpu_torch.audio import silero_vad, speaker_model, vad_model, wespeaker
    from whisperlive_tpu_torch.cli import train_speaker, train_vad

    rng = np.random.default_rng(SEED + 13)
    on_card = {k: torch.as_tensor(v, device=TOOL_DEVICE) for k, v in params.items()}
    if arch in ("gru", "silero"):
        sig, _ = train_vad.synth_speechlike(rng)
        if arch == "gru":
            ref = vad_model.LearnedVAD(params).update(sig)
            feats = vad_model.extract_features(sig)
            got, _ = vad_model.gru_forward_torch(
                on_card, torch.as_tensor(feats, device=TOOL_DEVICE)[None])
        else:
            ref = silero_vad.SileroShapedVAD(params).update(sig)
            feats, _ = silero_vad.features_for_windows(sig, np.zeros(silero_vad.CONTEXT,
                                                                     np.float32))
            got, _ = silero_vad.silero_forward_torch(
                on_card, torch.as_tensor(feats, device=TOOL_DEVICE)[None])
    else:
        sig = train_speaker.apply_channel(rng, train_speaker.synth_utterance(
            rng, train_speaker.make_profile(rng)))
        if arch == "mlp":
            ref = speaker_model.LearnedSpeakerEmbedder(params)(sig)
            feats = torch.as_tensor(speaker_model.extract_features(sig), device=TOOL_DEVICE)[None]
            got = speaker_model.embed_torch(on_card, feats, std_eps=0.0)
        else:
            ref = wespeaker.WeSpeakerEmbedder(params)(sig)
            feats = torch.as_tensor(wespeaker.fbank(sig), device=TOOL_DEVICE)[None]
            got, _ = wespeaker.embed_torch(on_card, feats, train=False)
    got = got[0].detach().float().cpu().numpy()
    check(got.shape == ref.shape and np.isfinite(got).all(), f"{arch}: card forward {got.shape}")
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def trainers_phase(tmp: str) -> dict:
    """cli.train_vad (gru, silero) and cli.train_speaker (mlp, resnet), each
    TOOL_TRAIN_STEPS steps on the card into a temporary npz (never the
    shipped weights)."""
    from whisperlive_tpu_torch.cli import train_speaker, train_vad

    out = {}
    for mod, arch in ((train_vad, "gru"), (train_vad, "silero"), (train_speaker, "mlp"),
                      (train_speaker, "resnet")):
        path = os.path.join(tmp, f"{arch}.npz")
        t0 = time.monotonic()
        result = mod.run(["--arch", arch, "--steps", str(TOOL_TRAIN_STEPS), "--batch",
                          str(TOOL_TRAIN_BATCH), "--seed", str(SEED), "--out", path,
                          "--device", TOOL_DEVICE])
        wall = time.monotonic() - t0
        losses = result["losses"]
        check(len(losses) == TOOL_TRAIN_STEPS and np.isfinite(losses).all(),
              f"{arch}: losses {losses}")
        with np.load(path) as data:
            saved = {k: data[k] for k in data.files}
        check(sorted(saved) == sorted(result["params"]), f"{arch}: saved keys")
        err = trainer_check(arch, saved)
        out[arch] = {"wall_s": wall, "first_loss": losses[0], "last_loss": losses[-1],
                     "forward_err": err}
        log(f"trainer {arch}: {TOOL_TRAIN_STEPS} steps of batch {TOOL_TRAIN_BATCH} (with "
            f"synthesis and held-out eval) {wall:.6g} s, loss {losses[0]:.6g} -> "
            f"{losses[-1]:.6g}; numpy forward of the saved npz against the card's "
            f"{err:.6g} of max|ref|")
        check(err <= TOOL_TRAIN_TOL, f"{arch}: numpy and card forwards part by {err:.6g}")
    return out


def tooling_phase(engine: WhisperEngine, continuous_step: dict) -> dict:
    import shutil
    import tempfile

    t_start = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tooling_")
    max_new = backends_mod.STREAMING_MAX_NEW_TOKENS
    backends_mod.STREAMING_MAX_NEW_TOKENS = TOOL_MAX_NEW
    try:
        out = {"profiled_session": profiled_session(engine, tmp),
               "roofline": envelopes_and_roofline(engine, continuous_step),
               "wer": wer_harness(engine, tmp),
               "trainers": trainers_phase(tmp)}
    finally:
        backends_mod.STREAMING_MAX_NEW_TOKENS = max_new
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.monotonic() - t_start
    log(f"phase 13: {out['phase_s']:.6g} s")
    return out


# ---------------------------------------------------------------------------
# Phase 14: the published configurations
# ---------------------------------------------------------------------------

# small: both server CLIs' default model; tiny.en: the narrowest width and
# English-only; base: K2's 8-chunk split; medium: the widest width below
# large; large-v3-turbo: 128 mels and a 4-layer decoder
CONFIGS = ("small", "tiny.en", "base", "medium", "large-v3-turbo")
DEFAULT_MODEL = "small"  # run_server's --model default
DEFAULT_SESSION_S = 8.0  # small's session through the server CLI's default start
CONFIG_SESSION_S = 3.0  # each other configuration's continuous session
# phase 14 times its kernel cases with 10 runs a figure, each behind a ~5 ms
# spin: enough for the host to queue a run of the widths' small kernels
CONFIG_TIMING = {"iters": 10, "spin_cycles": 10_000_000}
# steps of phase 14's profiled continuous chunk (a torch.profiler window's
# cost grows with its events)
PROFILE_STEPS = 2


def config_kernels(randn, int8, dev, name: str, cfg) -> dict:
    """K1-K5 at one configuration's shapes, each against its plain version
    with phase 3's tolerance, timed warm and (K2-K5) cold with phase 3's
    helpers, beside the library call phase 3 times: K1 at q/k/v
    [1,1500,H,64] and [4,1500,H,64]; K2 at the three decoder linears (d x d,
    d x 4d, 4d x d) at M = 1, 4 and 8; K3 at x [M, d] against the
    configuration's vocabulary at M = 1 and 8; K4 at [4,H,64] x
    [4,H,1500,128], unmasked and with lengths [1500,700,1,0]; K5 at
    [8,H,64] x [8,H,640,128] with mixed lengths and half the rows active.
    Returns {kernel: [case, ...]}, each case tagged with `name`."""
    h, hd, t_enc, d, v = (cfg.n_audio_head, cfg.head_dim, cfg.n_audio_ctx, cfg.n_text_state,
                          cfg.n_vocab)
    tag, timing = f" ({name})", CONFIG_TIMING
    out = {"fused_attention": [k1_case(randn, b, t_enc, h, hd, tag, timing) for b in (1, BATCH)],
           "int8_matmul": [k2_case(randn, int8, m, kk, n, tag, timing)
                           for kk, n in ((d, d), (d, 4 * d), (4 * d, d)) for m in (1, BATCH, 8)],
           "int8_matmul_t": []}
    copies = -(-COLD_BYTES // (v * d))
    w8s, s = [int8(v, d) for _ in range(copies)], randn(v, scale=0.01).abs()
    for m in (1, CONT_SLOTS):
        x = randn(m, d)
        r = compare("int8_matmul_t", f"x [{m},{d}] w8 [{v},{d}]{tag}",
                    lambda: qmm.int8_matmul_t(x, w8s[0], s),
                    lambda: qmm.int8_matmul_t_ref(x, w8s[0], s), 1e-5, timing=timing)
        r["library_ms"] = library_time("_weight_int8pack_mm",
                                       lambda: torch._weight_int8pack_mm(x, w8s[0], s), **timing)
        r.update(k3_bound(m, d, v))
        r["cold_ms"] = median_ms(rotating([lambda w=w: qmm.int8_matmul_t(x, w, s) for w in w8s]),
                                 iters=10, reps=10 * copies, spin_cycles=timing["spin_cycles"])
        log(f"int8_matmul_t{tag} x [{m},{d}]: cold {r['cold_ms'] * 1e3:.6g} us ({copies} "
            f"copies), bound {r['bound_ms'] * 1e3:.6g} us")
        out["int8_matmul_t"].append(r)
    del w8s
    out["cross_attention_int8"] = [k4_case(randn, int8, dev, BATCH, h, hd, t_enc, lens, tag,
                                           timing) for lens in (None, [t_enc, 700, 1, 0])]
    mixed = [640, 300, 1, 640, 512, 17, 640, 100]
    out["cross_attention_int8_skip"] = [k5_case(randn, int8, dev, h, hd, mixed,
                                                [i % 2 == 0 for i in range(CONT_SLOTS)], tag,
                                                timing)]
    for cases in out.values():
        for case in cases:
            case["config"] = name
    torch.cuda.empty_cache()
    return out


def launch_delta(before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in _kernels.launches.items()}


def check_launches(label: str, got: dict, want: dict) -> None:
    """`got` must launch exactly `want` ({kernel: count}) and nothing else."""
    log(f"{label} launches: {got}")
    wrong = {k: (n, want.get(k, 0)) for k, n in got.items() if n != want.get(k, 0)}
    check(not wrong, f"{label}: launches (got, want) {wrong}")


def encode_phase(engine: WhisperEngine) -> float:
    """Host time of one encode call at mel [BATCH, 3000, n_mels] (median of
    5 after a warm-up call); one call launches n_audio_layer K1 and no other
    kernel."""
    cfg, dev = engine.cfg, engine.device
    mel = torch.randn((BATCH, 2 * cfg.n_audio_ctx, cfg.n_mels),
                      generator=torch.Generator(device=dev).manual_seed(SEED + 2), device=dev)
    times = []
    with torch.inference_mode():
        for i in range(6):
            before = dict(_kernels.launches)
            t0 = time.perf_counter()
            enc = wmod.encode(engine.params, cfg, mel)
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                check_launches("encode", launch_delta(before),
                               {"fused_attention": cfg.n_audio_layer})
    check(enc.shape == (BATCH, cfg.n_audio_ctx, cfg.n_audio_state)
          and bool(torch.isfinite(enc).all()), f"encode: {tuple(enc.shape)}")
    return statistics.median(times[1:])


def window_batch_phase(engine: WhisperEngine) -> dict:
    """The window route's transcribe_batch of two speech-like clips (8 and
    5 s; the first's language given, the second's detected where the model
    is multilingual), decoding MAX_NEW_TOKENS tokens and then one: the full
    decode less the one-step one launches, a decode step, 8 x n_text_layer
    K2 (q, k, v, o, the cross q and o, fc1, fc2), one K3 and n_text_layer
    K4, and no other kernel. An English-only model never runs language
    detection."""
    cfg = engine.cfg
    audio = np.zeros((2, 480000), np.float32)
    for i, seconds in enumerate((8.0, 5.0)):
        audio[i, : int(16000 * seconds)] = speech_like(seconds, 70 + i)
    prompt, sot = engine.build_prompt(TranscribeOptions(language="en"), language="en")
    steps, detects = [], []
    step_fn, detect = wmod.decode_step, engine._detect

    def counted_step(*a, **kw):
        steps.append(1)
        return step_fn(*a, **kw)

    def run(max_new):
        opts = TranscribeOptions(language=None, temperatures=(0.0,), log_prob_threshold=None,
                                 no_speech_threshold=None, compression_ratio_threshold=None,
                                 max_new_tokens=max_new)
        steps.clear()
        before = dict(_kernels.launches)
        t0 = time.monotonic()
        results, langs, cross = engine.transcribe_batch(audio, [prompt, prompt], [sot, sot],
                                                        [True, False], opts)
        torch.cuda.synchronize()
        return results, langs, launch_delta(before), len(steps), time.monotonic() - t0

    wmod.decode_step = counted_step
    engine._detect = lambda cross: detects.append(1) or detect(cross)
    try:
        results, langs, full, n_full, seconds = run(MAX_NEW_TOKENS)
        _, _, one, n_one, _ = run(1)
    finally:
        wmod.decode_step = step_fn
        del engine._detect
    n = n_full - n_one
    check(n > 0 and n_one == 0, f"window decode steps: {n_full} and {n_one}")
    per_step = {k: full[k] - one[k] for k in full}
    L = cfg.n_text_layer
    check_launches(f"window route ({n} decode steps)", per_step,
                   {"int8_matmul": 8 * L * n, "int8_matmul_t": n, "cross_attention_int8": L * n})
    check(all(len(r.tokens) > 0 for r in results), "a window decoded no token")
    multilingual = engine.tokenizer.spec.multilingual
    check(bool(detects) == multilingual,
          f"language detection ran {len(detects)} times (multilingual: {multilingual})")
    check(multilingual or [lang for lang, _ in langs] == ["en", "en"], f"languages {langs}")
    log(f"window route: {seconds:.6g} s for {[len(r.tokens) for r in results]} tokens, "
        f"languages {langs}")
    return {"seconds": seconds, "tokens": [len(r.tokens) for r in results], "decode_steps": n,
            "launches_per_step": {k: c / n for k, c in per_step.items() if c}}


def continuous_step_phase(engine: WhisperEngine, cs: ContinuousScheduler, label: str) -> dict:
    """One continuous step: its device time (profile_pool, torch.profiler as
    phase 5 reads it, over one chunk of PROFILE_STEPS steps of a pool of the
    stopped pool `cs`'s geometry), then two chunks of `cs`'s pool on the
    host clock, each step launching n_text_layer K5, 8 x n_text_layer K2,
    one K3 and no other kernel."""
    cb, L = cs.cb, engine.cfg.n_text_layer
    profiled = ContinuousEngine(engine, n_slots=cb.n_slots, prompt_pad=cb.prompt_pad, ring=cb.ring,
                                steps_per_chunk=PROFILE_STEPS, cross_ctx=cb.cross_ctx,
                                enc_buckets=cb.enc_buckets)
    device_ms = profile_pool(f"{label} continuous step", profiled, 1, "step",
                             {"K5": cross_kernel("Int8Packed", 1)})
    del profiled
    seat_profile_slots(cb)
    chunks = 2
    before = dict(_kernels.launches)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(chunks):
        cb.step()
    torch.cuda.synchronize()
    n = chunks * cb.steps_per_chunk
    host_ms = (time.monotonic() - t0) / n * 1e3
    check_launches(f"{label} continuous step ({n} steps)", launch_delta(before),
                   {"cross_attention_int8_skip": L * n, "int8_matmul": 8 * L * n,
                    "int8_matmul_t": n})
    log(f"{label} continuous step: {host_ms:.6g} ms host, {device_ms} ms device")
    return {"host_ms": host_ms, "device_ms": device_ms}


def config_session(engine: WhisperEngine, name: str) -> tuple[dict, ContinuousScheduler]:
    """One CONFIG_SESSION_S streaming session (English) on phase 5's pool
    on `engine` (no warm-up: PyTorch compiles nothing): it reaches the pool
    and its segments the client, and each step launches n_text_layer K5.
    Returns (launches, the stopped pool)."""
    cs = ContinuousScheduler(engine, n_slots=CONT_SLOTS, steps_per_chunk=8, cross_ctx=640,
                             enc_buckets=(512, 1500))
    window = BatchScheduler(engine, max_batch_size=BATCH, batch_window_ms=50)
    window.start()
    cs.start()
    gstep = cs.cb.gstep
    try:
        backend = CountingBackend(window, model_name=name, continuous_scheduler=cs)
        sockets, wall = serve(backend, [dict(uid=f"{name}-en", language="en",
                                             audio=speech_like(CONFIG_SESSION_S, 80),
                                             extra={"model": name})])
    finally:
        cs.stop()
        window.stop()
    launches = dict(_kernels.launches)
    check_session(engine, backend, sockets, launches, cs.cb.gstep - gstep, f"{name}-en")
    return launches, cs


def check_session(engine, backend, sockets, launches, steps, uid) -> None:
    """A session `uid` that reached the backend and its pool: its segments
    reached the client, and each pool step launched n_text_layer K5."""
    label = f"session {uid}"
    check_calls(backend, [uid], 1)
    check_sockets(sockets)
    log(f"{label}: {len(backend.calls)} backend calls, {steps} steps, launches {launches}")
    check(steps > 0 and launches["cross_attention_int8_skip"] == steps * engine.cfg.n_text_layer,
          f"{label}: K5 must launch {engine.cfg.n_text_layer} times a step")


def default_server_session(dev: torch.device) -> tuple[WhisperEngine, dict, ContinuousScheduler]:
    """The user's default start: cli.run_server.main with no --model flag
    builds its engine (random weights from --seed 0, as init_params(cfg,
    SEED) draws them) and its schedulers; its server serves one
    DEFAULT_SESSION_S English session in-process (as phase 13 drives it: the
    card's machine has no websockets). The engine must be small's, the
    session must reach the continuous pool and its segments the client.
    Returns (the engine, the session's launches, its stopped pool)."""
    from whisperlive_tpu_torch import loader
    from whisperlive_tpu_torch.cli import run_server

    seen = {}
    resolve = loader.resolve_model

    def visible_resolve(*a, **kw):  # random weights: a tokenizer with visible words
        cfg, params, tok = resolve(*a, **kw)
        return cfg, params, tok or visible_tokenizer(cfg)

    def run(server, backend, **kw):
        seen["engine"], seen["pool"] = backend.scheduler.engine, backend.continuous_scheduler
        server.backend, server.backend_name = backend, kw["backend_name"]
        server.client_manager = ClientManager(max_clients=4, max_connection_time=600)
        _kernels.reset_launches()
        seen["gstep"] = seen["pool"].cb.gstep
        seen["ws"] = asyncio.run(run_session(
            server, backend, uid="default-en", language="en",
            audio=speech_like(DEFAULT_SESSION_S, 81), extra={"model": DEFAULT_MODEL}))
        seen["backend"] = backend

    saved = (loader.resolve_model, backends_mod.TorchBackend, TranscriptionServer.run,
             os.environ.get("OMP_NUM_THREADS"))
    loader.resolve_model, backends_mod.TorchBackend = visible_resolve, CountingBackend
    TranscriptionServer.run = run
    try:
        run_server.main(["--device", dev.type, "--continuous_slots", str(CONT_SLOTS),
                         "--batch_max_size", str(BATCH), "--omp_num_threads",
                         str(torch.get_num_threads())])
    finally:
        loader.resolve_model, backends_mod.TorchBackend, TranscriptionServer.run = saved[:3]
        if saved[3] is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = saved[3]
    engine, pool = seen["engine"], seen["pool"]
    launches = dict(_kernels.launches)
    check(engine.cfg.replace(dtype=torch.float32) == wmod.WHISPER_CONFIGS[DEFAULT_MODEL],
          f"the default start built {engine.cfg}, not {DEFAULT_MODEL}")
    check(engine.decoder_int8 and engine.cross_kv_bits == 8, "the default engine is not int8")
    check(pool is not None, "the default start built no continuous pool")
    check_session(engine, seen["backend"], [seen["ws"]], launches, pool.cb.gstep - seen["gstep"],
                  "default-en")
    return engine, launches, pool


def configuration_phase(dev: torch.device, name: str) -> tuple[dict, dict]:
    """One published configuration at full width and depth on random bf16
    weights from SEED: its kernels at its shapes (config_kernels), then its
    int8 engine (small's from the server CLI's default start) serving a
    continuous session, the window route's batch, an encode and continuous
    steps with their launches, and window_reference and
    continuous_reference against the plain path. Returns (the figures, the
    kernel cases)."""
    cfg = wmod.WHISPER_CONFIGS[name]
    lap = phase_clock()
    randn, int8 = random_makers(dev, SEED + 14)
    cases = config_kernels(randn, int8, dev, name, cfg)
    lap(f"{name}: kernels")
    if name == DEFAULT_MODEL:
        engine, session, pool = default_server_session(dev)
    else:
        engine = build_engine(dev, name, wmod.init_params(cfg, SEED, torch.bfloat16, dev),
                              (1, 2, BATCH))
        session, pool = config_session(engine, name)
    lap(f"{name}: engine and session")
    out = {"d_model": cfg.n_text_state, "heads": cfg.n_text_head,
           "layers": [cfg.n_audio_layer, cfg.n_text_layer], "n_mels": cfg.n_mels,
           "n_vocab": cfg.n_vocab, "multilingual": engine.tokenizer.spec.multilingual,
           "session_launches": session}
    out["window_route"] = window_batch_phase(engine)
    out["encode_ms"] = encode_phase(engine)
    lap(f"{name}: window route, encode")
    out["continuous_step"] = continuous_step_phase(engine, pool, name)
    lap(f"{name}: continuous step")
    out["max_err"] = {
        "window_reference": window_reference(engine),
        "continuous_reference": continuous_reference(engine),
        "kernels": {k: max(c["max_abs_err"] for c in v) for k, v in cases.items()}}
    del engine, pool
    free_cache(dev)
    out["seconds"] = lap(f"{name}: references")
    out["phase_s"] = sum(out["seconds"].values())
    log(f"configuration {name}: encode {out['encode_ms']:.6g} ms at mel "
        f"[{BATCH},{2 * cfg.n_audio_ctx},{cfg.n_mels}], continuous step "
        f"{out['continuous_step']}, errors {out['max_err']}, {out['phase_s']:.6g} s")
    return out, cases


def configurations_phase(dev: torch.device, measured: dict) -> dict:
    """Phase 14: every configuration of CONFIGS, one engine at a time; the
    kernel cases join their entries' other_shapes."""
    backends_mod._DISABLE_GATES = True  # random weights: first attempt passes
    backends_mod.STREAMING_MAX_NEW_TOKENS = MAX_NEW_TOKENS
    out = {}
    for name in CONFIGS:
        out[name], cases = configuration_phase(dev, name)
        for kernel, rows in cases.items():
            measured[kernel].setdefault("other_shapes", []).extend(rows)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card",
              file=sys.stderr)
        return 1
    t_start = time.monotonic()
    lap = phase_clock()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    _kernels.library()
    log(f"kernel build + load: {time.monotonic() - t0:.6g} s ({_kernels.library_path().name})")
    k1_ptxas, k2_ptxas = ptxas_usage("fused_attention"), ptxas_usage("int8_matmul")
    log(f"fused_attention.cu, nvcc -Xptxas -v: {k1_ptxas}")
    log(f"int8_matmul.cu, nvcc -Xptxas -v: {k2_ptxas}")
    cross_ptxas = ptxas_by_tq(ptxas_stderr("cross_attention"))
    serves = {"Int8Packed Tq=1": "K4 and K5", "Int4Halves Tq=1": "K7"}
    for key, usage in cross_ptxas.items():
        window = "K8" if key.startswith("Int4Halves") else "K6 and K5's window form"
        log(f"cross_attention.cu at {key} ({serves.get(key, window)}), nvcc -Xptxas -v: "
            f"{usage}")
    check(len(cross_ptxas) == len(CODECS) * 8, f"cross_attention.cu: ptxas reported "
          f"{sorted(cross_ptxas)}, not every codec at Tq = 1..8")
    spills = [key for key, usage in cross_ptxas.items()
              if any(int(n) for n in re.findall(r"(\d+) bytes spill", usage))]
    check(not spills, f"cross_attention.cu spills registers at {spills}")
    k3_ptxas = ptxas_usage("int8_matmul_t")
    log(f"int8_matmul_t.cu, nvcc -Xptxas -v: {k3_ptxas}")
    lap("phases 1-2 (build, ptxas)")

    from whisperlive_tpu_torch.device import resolve_device

    resolve_device(dev)  # the engine's numerics policy (TF32 off)
    measured = kernel_phase(dev)
    measured["fused_attention"]["ptxas"] = k1_ptxas
    measured["int8_matmul"]["ptxas"] = k2_ptxas
    measured["int8_matmul_t"]["ptxas"] = k3_ptxas
    for codec, single, windows in (
            ("Int8Packed", ("cross_attention_int8", "cross_attention_int8_skip"),
             ("cross_attention_int8_window", "cross_attention_int8_skip_window")),
            ("Int4Halves", ("cross_attention_int4",), ("cross_attention_int4_window",))):
        for name in single:
            measured[name]["ptxas"] = cross_ptxas[f"{codec} Tq=1"]
        for name in windows:
            measured[name]["ptxas"] = {k: u for k, u in cross_ptxas.items()
                                       if k.startswith(codec) and k != f"{codec} Tq=1"}
    # the int8 engine serves phases 4-6, an int4 engine built from the same
    # parameters the mixed route; each has a distil-large-v3 draft of its
    # cross-KV width (random weights from SEED + 1)
    params = wmod.init_params(wmod.WHISPER_CONFIGS[MODEL], SEED, torch.bfloat16, dev)
    engine = build_engine(dev, MODEL, params, (1, 2, BATCH))
    encoder = encoder_phase(engine, measured["fused_attention"])
    engine4 = build_engine(dev, MODEL, params, (1, 2, BATCH), cross_kv_bits=4)
    params = wmod.init_params(wmod.WHISPER_CONFIGS[DRAFT_MODEL], SEED + 1, torch.bfloat16, dev)
    draft = build_engine(dev, DRAFT_MODEL, params, (1,))
    draft4 = build_engine(dev, DRAFT_MODEL, params, (1,), cross_kv_bits=4)
    del params
    lap("phase 3 (kernels, encoder forward)")
    paths = {"window": window_phase(engine)}
    lap("phase 4 (window path)")
    paths["continuous"], continuous_step = continuous_phase(engine)
    lap("phase 5 (continuous path)")
    paths["spec_window"] = spec_window_phase(engine, draft)
    spec_random = spec_continuous_phase(engine, draft)
    paths.update({
        "spec_all": spec_random.pop("launches"),
        "mixed_int4": mixed_phase(engine4, draft4),
    })
    lap("phase 6 (speculative routes)")
    paths.update({
        "beam_window": beam_window_phase(engine),
        "beam_pool": beam_pool_phase(engine),
        "hybrid_beam": hybrid_phase(engine),
        "word_timestamps": word_ts_phase(engine),
    })
    lap("phase 7 (beam, word timestamps)")
    offline = offline_phase(engine)
    lap("phase 8 (offline path)")
    window_reference(engine)
    distill_reference(engine)
    offline_reference(engine)
    beam_reference(engine)
    beam_pool_reference(engine)
    continuous_reference(engine)
    continuous_reference(engine4)
    err8 = verify_reference(engine)
    verify_reference(engine4)
    spec_reference(engine, draft, err8)
    lap("phase 9 (references)")
    rest_of_serving = rest_of_serving_phase(engine, dev)
    lap("phase 11 (rest of serving)")
    # phase 12: tp = 2, dp = 2 and a tp = 2 fine-tune step over two ranks on
    # this card, held against the int8 engine of phases 4-11
    parallel = run_parallel_phase(engine)
    lap("phase 12 (parallelism)")
    # phase 13: the profiler behind --profile_dir, the roofline, the WER
    # harness and the trainers
    tooling = tooling_phase(engine, continuous_step)
    lap("phase 13 (tooling)")

    # phase 10: the distiller on the serving engine's own random teacher, its
    # draft on the `all` pool, then the fine-tune with the engines freed
    distilled, trained_draft = distill_phase(dev)
    spec_trained = spec_continuous_phase(engine, trained_draft,
                                         "continuous spec pool (all), distilled draft")
    spec_trained.pop("launches")
    log(f"distilled draft on the `all` pool: acceptance {spec_trained['acceptance']:.6g}, "
        f"committed tokens per window round {spec_trained['committed_per_window_round']:.6g}, "
        f"device time per pool verify round {spec_trained['device_ms_per_round']} ms; the "
        f"random draft of phase 6: {spec_random['acceptance']:.6g}, "
        f"{spec_random['committed_per_window_round']:.6g}, "
        f"{spec_random['device_ms_per_round']} ms")
    lap("phase 10 (b, c) (distiller, distilled draft served)")
    del engine, engine4, draft, draft4, trained_draft
    gc.collect()
    torch.cuda.empty_cache()
    finetune = finetune_phase(dev)
    lap("phase 10 (a) (fine-tune)")
    # phase 14: the published configurations, one engine at a time
    configurations = configurations_phase(dev, measured)
    phase_s = lap("phase 14 (configurations)")

    # each kernel's launches on the path it serves: the continuous path
    # (the server's default) for K1-K3 and K5, the window path for K4, and
    # the speculative route that runs each of K6, K5's window form, K7, K8
    served_by = dict.fromkeys(CONTINUOUS_PATH, "continuous")
    served_by.update(cross_attention_int8="window", cross_attention_int8_window="spec_window",
                     cross_attention_int8_skip_window="spec_all",
                     cross_attention_int4="mixed_int4", cross_attention_int4_window="mixed_int4")
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": paths[served_by[name]][name], **measured[name]}
               for name, (src, replaces) in KERNELS.items()]
    phase_s["total"] = time.monotonic() - t_start
    log(f"chip_smoke total: {phase_s['total']:.6g} s")
    print(json.dumps({"phase_s": phase_s}))
    print(json.dumps({"encoder_forward": encoder}))
    print(json.dumps({"offline": offline}))
    print(json.dumps({"training": {"finetune": finetune, "distill": distilled,
                                   "served_distilled_draft": spec_trained,
                                   "served_random_draft": spec_random}}))
    print(json.dumps({"rest_of_serving": rest_of_serving}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"tooling": tooling}))
    print(json.dumps({"configurations": configurations}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
