"""granite-20b — llama-arch code model, MQA kv=1 [arXiv:2405.04324]."""

from .base import ArchConfig

FULL = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152,
    citation="arXiv:2405.04324",
)

SMOKE = ArchConfig(
    name="granite-20b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=1,
    d_ff=512, vocab=512,
    citation="reduced variant of arXiv:2405.04324",
)
