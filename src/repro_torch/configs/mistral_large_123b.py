"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407]."""

from .base import ArchConfig

FULL = ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=28672, vocab=32768,
    citation="hf:mistralai/Mistral-Large-Instruct-2407",
)

SMOKE = ArchConfig(
    name="mistral-large-123b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512,
    citation="reduced variant of hf:mistralai/Mistral-Large-Instruct-2407",
)
