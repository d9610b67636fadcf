"""llama4-maverick-400b-a17b — MoE 128 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

Llama-4 uses chunked attention for long context; our long_500k decode
uses the sliding-window KV-cache variant (DESIGN.md).
"""

from .base import ArchConfig

FULL = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    n_experts=128, top_k=1,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE = ArchConfig(
    name="llama4-maverick-400b-a17b-smoke", family="moe",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512,
    n_experts=4, top_k=1, capacity_factor=4.0,
    citation="reduced variant of hf:meta-llama/Llama-4-Scout-17B-16E",
)
