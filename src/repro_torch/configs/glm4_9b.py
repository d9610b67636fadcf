"""glm4-9b — RoPE, GQA kv=2 [hf:THUDM/glm-4-9b]."""

from .base import ArchConfig

FULL = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=151552,
    citation="hf:THUDM/glm-4-9b",
)

SMOKE = ArchConfig(
    name="glm4-9b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=448, vocab=512,
    citation="reduced variant of hf:THUDM/glm-4-9b",
)
