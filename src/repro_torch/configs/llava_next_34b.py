"""llava-next-34b — VLM, anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

The ViT/SigLIP vision encoder + projector is a stub: ``input_specs``
supplies 576 precomputed patch embeddings (one 24×24 anyres base tile)
spliced in front of the text tokens; the 60-layer language backbone that
consumes them is fully implemented.
"""

from .base import ArchConfig

FULL = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, n_prefix=576,
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

SMOKE = ArchConfig(
    name="llava-next-34b-smoke", family="vlm",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512, n_prefix=16,
    citation="reduced variant of hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
