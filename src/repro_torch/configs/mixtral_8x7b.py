"""mixtral-8x7b — MoE 8 experts top-2, native SWA 4096 [arXiv:2401.04088]."""

from .base import ArchConfig

FULL = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    n_experts=8, top_k=2, window=4096,
    citation="arXiv:2401.04088",
)

SMOKE = ArchConfig(
    name="mixtral-8x7b-smoke", family="moe",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512,
    n_experts=4, top_k=2, window=64, capacity_factor=4.0,
    citation="reduced variant of arXiv:2401.04088",
)
