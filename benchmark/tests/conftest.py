"""CPU fixtures of the benchmark's tests: a tiny Whisper configuration with
the served precision, and small mixes of the cells' traffic kinds."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"d_model": 64, "decoder_attention_heads": 2, "decoder_ffn_dim": 256, "decoder_layers": 2,
        "encoder_attention_heads": 2, "encoder_ffn_dim": 256, "encoder_layers": 2,
        "max_source_positions": 1500, "max_target_positions": 448, "num_mel_bins": 80,
        "vocab_size": 51865,
        "serving": {"weight_dtype": "bfloat16", "compute_dtype": "bfloat16",
                    "decoder_weight_bits": 8, "scale_dtype": "bfloat16", "cross_kv_bits": 8},
        "reference": "benchmark/reference.py"}

# wide enough that a wrong token's logit lies as far below the best as at
# the cells' widths (the logits' spread grows with the square root of d)
WIDE = dict(TINY, d_model=512, decoder_attention_heads=8, encoder_attention_heads=8,
            decoder_ffn_dim=2048, encoder_ffn_dim=2048, decoder_layers=1, encoder_layers=1)

SMALL_STREAMS = {"streams": 8, "settle_s": 2.0, "pool": {"slots": 4, "steps_per_chunk": 8, "ring": 128,
                                        "prompt_pad": 192, "cross_ctx": 640, "enc_ctx": 512,
                                        "window_batch": 8, "window_batch_ms": 50},
                 "check": {"sample": 48}}
SMALL_FILES = {"files_per_call": 4, "duration_s": [30.0, 70.0], "max_new_tokens": 24,
               "check": {"sample": 12}}
CELLS = {"stream": ("large-v3.stream20", SMALL_STREAMS, 6.0),
         "files": ("large-v3-turbo.files16", SMALL_FILES, 8.0)}


@pytest.fixture
def tiny():
    return dict(TINY)
