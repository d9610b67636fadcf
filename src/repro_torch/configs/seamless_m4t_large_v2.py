"""seamless-m4t-large-v2 — enc-dec audio backbone [arXiv:2308.11596].

The assignment lists "24L"; the model card has 24 speech-encoder + 24
text-decoder layers, so we implement 24 enc + 24 dec (see DESIGN.md).
The mel-spectrogram/conformer frontend is a stub: ``input_specs`` provides
precomputed frame embeddings (B, seq/4, d_model).
"""

from .base import ArchConfig

FULL = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206,
    citation="arXiv:2308.11596",
)

SMOKE = ArchConfig(
    name="seamless-m4t-large-v2-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=256, n_heads=8, n_kv_heads=8,
    d_ff=512, vocab=512,
    citation="reduced variant of arXiv:2308.11596",
)
