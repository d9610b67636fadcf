"""hymba-1.5b — parallel attention + Mamba heads [arXiv:2411.13676].

Every layer is windowed (the Hymba paper uses SWA on most layers; we
window all of them and note it in DESIGN.md), so long_500k decode is
O(window) on the attention branch and O(1) on the SSM branch.
"""

from .base import ArchConfig

FULL = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, ssm_state=16, window=2048,
    citation="arXiv:2411.13676",
)

SMOKE = ArchConfig(
    name="hymba-1.5b-smoke", family="hybrid",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab=512, ssm_state=16, window=64,
    citation="reduced variant of arXiv:2411.13676",
)
