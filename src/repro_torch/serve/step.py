"""Serving step factories.

``prefill_step`` runs the prompt and emits the model's cache;
``decode_step`` advances one token against it.  The reference's factories
take a config and return functions of ``(params, ...)`` for ``jax.jit``;
here a :class:`~repro_torch.models.model.Model` holds its weights, so the
factories take the model.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..models.model import Model

PyTree = Any


def make_prefill_step(model: Model, seq_len: int
                      ) -> Callable[[Dict[str, Any]],
                                    Tuple[torch.Tensor, PyTree]]:
    """batch -> (last-token logits, cache sized for seq_len)."""
    def prefill_step(batch):
        return model.prefill(batch, seq_len=seq_len)

    return prefill_step


def make_decode_step(model: Model
                     ) -> Callable[[PyTree, torch.Tensor],
                                   Tuple[torch.Tensor, PyTree]]:
    """(cache, token (B,)) -> (logits (B, V), new cache)."""
    def decode_step(cache, token):
        return model.decode_step(cache, token)

    return decode_step
