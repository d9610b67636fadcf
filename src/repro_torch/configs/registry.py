"""Registry mapping ``--arch <id>`` to configs, plus input construction.

``make_inputs`` builds small concrete batches for smoke tests, drawing
tokens from the same ``np.random.default_rng(seed)`` stream as the
reference package's ``configs/registry.py``, so the tokens are
identical.  The vlm and encdec stub embeddings (N(0, 1)·0.02) come from
``jax.random.PRNGKey(seed)`` there and from a CPU ``torch.Generator``
seeded with ``seed`` here: the same distribution, not the same numbers.
``input_specs`` builds the same inputs' shapes and types as tensors on
the meta device (the dry-run's allocation-free stand-ins).
"""

from __future__ import annotations

import importlib
from typing import Dict

import numpy as np
import torch

from ..models.frontend import frame_embed_spec, patch_embed_spec, stub_normal
from .base import ArchConfig, InputShape

_MODULES: Dict[str, str] = {
    "mistral-large-123b": "mistral_large_123b",
    "glm4-9b": "glm4_9b",
    "mixtral-8x7b": "mixtral_8x7b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "hymba-1.5b": "hymba_1_5b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "granite-20b": "granite_20b",
    "rwkv6-3b": "rwkv6_3b",
    "llava-next-34b": "llava_next_34b",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(arch_id: str, smoke: bool = False) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.SMOKE if smoke else mod.FULL


def input_specs(cfg: ArchConfig, shape: InputShape, dtype=torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins for every model input: int32 ``token`` (B,)
    for decode; else ``tokens`` (B, S) (vlm: S - n_prefix text tokens
    beside (B, n_prefix, d_model) ``patch_embeds``; encdec: beside
    (B, S // enc_seq_divisor, d_model) ``enc_embeds``, both ``dtype``),
    and ``labels`` like ``tokens`` for train."""
    B, S = shape.global_batch, shape.seq_len

    def ints(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if shape.kind == "decode":
        return {"token": ints(B)}
    batch: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        batch["tokens"] = ints(B, S - cfg.n_prefix)
        batch["patch_embeds"] = patch_embed_spec(cfg, B, dtype)
    elif cfg.family == "encdec":
        batch["tokens"] = ints(B, S)
        batch["enc_embeds"] = frame_embed_spec(cfg, B, S, dtype)
    else:
        batch["tokens"] = ints(B, S)
    if shape.kind == "train":
        batch["labels"] = ints(*batch["tokens"].shape)
    return batch


def make_inputs(cfg: ArchConfig, *, batch: int, seq: int,
                kind: str = "train", dtype=torch.float32, seed: int = 0
                ) -> Dict[str, torch.Tensor]:
    """Small concrete batches (CPU tensors: int32 tokens, ``dtype``
    embeddings) for smoke tests and examples.  vlm: ``seq - n_prefix``
    text tokens behind ``n_prefix`` patch embeddings; encdec: ``seq``
    tokens and ``seq // enc_seq_divisor`` frame embeddings."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)

    def tokens(shape):
        return torch.from_numpy(
            rng.integers(0, cfg.vocab, size=shape).astype(np.int32))

    if kind == "decode":
        return {"token": tokens((batch,))}
    out: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        out["tokens"] = tokens((batch, max(1, seq - cfg.n_prefix)))
        out["patch_embeds"] = stub_normal(
            gen, (batch, cfg.n_prefix, cfg.d_model), dtype)
    elif cfg.family == "encdec":
        out["tokens"] = tokens((batch, seq))
        out["enc_embeds"] = stub_normal(
            gen, (batch, max(1, seq // cfg.enc_seq_divisor), cfg.d_model),
            dtype)
    else:
        out["tokens"] = tokens((batch, seq))
    if kind == "train":
        out["labels"] = tokens(tuple(out["tokens"].shape))
    return out
