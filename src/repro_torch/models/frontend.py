"""Stub modality frontends: the counterpart of the reference package's
``models/frontend.py``.

The audio (mel-spectrogram + conformer feature extractor) and vision
(ViT/SigLIP + projector) frontends are not implemented in either
package; these helpers produce *shape-correct* precomputed embeddings,
N(0, 1)·0.02, that the backbones consume: ``(B, n_prefix, d_model)``
patch embeddings for ``vlm`` and ``(B, seq_len // enc_seq_divisor,
d_model)`` frame embeddings for ``encdec``.

The reference draws them from ``jax.random.PRNGKey(seed)`` (patches) and
``PRNGKey(seed + 1)`` (frames); here a CPU ``torch.Generator`` seeded
the same way draws them, so the numbers differ from the reference's but
not between devices: a model on the card and one on the host see the
same embeddings.  They come back as host tensors, as
:func:`repro_torch.configs.make_inputs`' do, and the model moves them to
its device.  The ``*_spec`` twins give their shapes and types as
tensors on the meta device.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig

# llava-next anyres tiling: base 24×24 patch grid = 576 tokens per tile.
VLM_PATCHES = 576


def stub_normal(generator: torch.Generator, shape, dtype=torch.float32
                ) -> torch.Tensor:
    """The stubs' draw, N(0, 1)·0.02 from a CPU ``generator``: every
    patch or frame embedding of the package comes from here."""
    return (torch.randn(shape, generator=generator) * 0.02).to(dtype)


def _normal(shape, seed: int, dtype) -> torch.Tensor:
    return stub_normal(torch.Generator().manual_seed(seed), shape, dtype)


def patch_embeds(cfg: ArchConfig, batch: int, dtype=torch.float32,
                 seed: int = 0) -> torch.Tensor:
    """Vision stub: (B, n_prefix, d_model) patch embeddings."""
    return _normal((batch, cfg.n_prefix, cfg.d_model), seed, dtype)


def patch_embed_spec(cfg: ArchConfig, batch: int, dtype=torch.bfloat16
                     ) -> torch.Tensor:
    return torch.empty((batch, cfg.n_prefix, cfg.d_model), dtype=dtype,
                       device="meta")


def frame_embeds(cfg: ArchConfig, batch: int, seq_len: int,
                 dtype=torch.float32, seed: int = 0) -> torch.Tensor:
    """Audio stub: (B, seq_len // enc_seq_divisor, d_model) frames."""
    n = max(1, seq_len // cfg.enc_seq_divisor)
    return _normal((batch, n, cfg.d_model), seed + 1, dtype)


def frame_embed_spec(cfg: ArchConfig, batch: int, seq_len: int,
                     dtype=torch.bfloat16) -> torch.Tensor:
    n = max(1, seq_len // cfg.enc_seq_divisor)
    return torch.empty((batch, n, cfg.d_model), dtype=dtype, device="meta")
