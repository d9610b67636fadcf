"""rwkv6-3b "Finch" — attention-free, data-dependent decay
[arXiv:2404.05892].  O(1) recurrent state: runs long_500k natively."""

from .base import ArchConfig

FULL = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=8960, vocab=65536, head_dim=64, ssm_state=64,
    citation="arXiv:2404.05892",
)

SMOKE = ArchConfig(
    name="rwkv6-3b-smoke", family="ssm",
    n_layers=2, d_model=256, n_heads=0, n_kv_heads=0,
    d_ff=512, vocab=512, head_dim=64, ssm_state=64,
    citation="reduced variant of arXiv:2404.05892",
)
