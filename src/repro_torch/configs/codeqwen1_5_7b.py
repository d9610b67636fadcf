"""codeqwen1.5-7b — qwen1.5 arch, GQA kv=32 (MHA) [hf:Qwen/CodeQwen1.5-7B]."""

from .base import ArchConfig

FULL = ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab=92416,
    citation="hf:Qwen/CodeQwen1.5-7B",
)

SMOKE = ArchConfig(
    name="codeqwen1.5-7b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=8,
    d_ff=448, vocab=512,
    citation="reduced variant of hf:Qwen/CodeQwen1.5-7B",
)
