"""Building blocks of the model zoo that the ported families need.

Counterparts of the reference package's ``models/layers.py``: the
parameter initialisers, RMSNorm and the embedding lookup.  Attention,
RoPE and the ring KV cache wait for the dense-family slice.

``jax.random`` keys become an explicit ``torch.Generator``: the draws
have the reference's distributions but not its numbers, so parity tests
carry the reference's weights across (:mod:`.bridge`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

Params = Dict[str, torch.Tensor]


def dense_init(generator: torch.Generator, shape: Sequence[int], dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1) · scale, with scale 1/sqrt(fan_in) by default (fan_in is
    the second-last axis), drawn in f32 on the generator's device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def init_embed(generator: torch.Generator, vocab: int, d_model: int,
               dtype) -> torch.Tensor:
    return dense_init(generator, (vocab, d_model), dtype, scale=0.02)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMSNorm computed in f32 and cast back to ``x``'s type."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(dt)


def embed(table: torch.Tensor, tokens) -> torch.Tensor:
    """Rows of ``table`` at ``tokens``, with ``jnp.take``'s semantics:
    an index in [-V, 0) counts from the end, and one outside [-V, V)
    gives a row of NaN (it never raises and never reads out of range)."""
    V = table.shape[0]
    idx = torch.as_tensor(tokens, device=table.device).long()
    idx = torch.where(idx < 0, idx + V, idx)
    ok = (idx >= 0) & (idx < V)
    rows = table[idx.clamp(0, V - 1)]
    return torch.where(ok[..., None], rows,
                       torch.full((), float("nan"), dtype=table.dtype,
                                  device=table.device))
