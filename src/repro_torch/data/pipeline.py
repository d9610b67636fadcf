"""Synthetic token pipeline with a learnable structure: the counterpart of
the reference package's ``data/pipeline.py``.

Sequences follow a sticky-bigram Markov process (each token prefers a
fixed successor with probability ``stickiness``), so a language model can
actually reduce loss on it.  The tokens come from the same
``np.random.default_rng(seed)`` calls in the same order as the
reference's, so tokens and labels are bit-equal to its.  The vlm patch
and encdec frame embeddings (N(0, 1)·0.02) come from a CPU
``torch.Generator`` seeded with ``seed``, where the reference splits a
``jax.random`` key: the same shapes and distribution, not the same
numbers.  Batches are host tensors in :func:`repro_torch.configs.
make_inputs`' format; the model moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models.frontend import stub_normal


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int = 8
    seq: int = 128
    seed: int = 0
    stickiness: float = 0.9


def synthetic_batches(cfg: ArchConfig, data: DataConfig
                      ) -> Iterator[Dict[str, torch.Tensor]]:
    rng = np.random.default_rng(data.seed)
    succ = rng.integers(0, cfg.vocab, size=cfg.vocab)   # bigram table
    gen = torch.Generator().manual_seed(data.seed)

    s_text = data.seq - (cfg.n_prefix if cfg.family == "vlm" else 0)
    s_text = max(2, s_text)
    while True:
        toks = np.empty((data.batch, s_text + 1), np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=data.batch)
        for t in range(1, s_text + 1):
            follow = rng.random(data.batch) < data.stickiness
            rand = rng.integers(0, cfg.vocab, size=data.batch)
            toks[:, t] = np.where(follow, succ[toks[:, t - 1]], rand)
        batch = {
            "tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)),
        }
        if cfg.family == "vlm":
            batch["patch_embeds"] = stub_normal(
                gen, (data.batch, cfg.n_prefix, cfg.d_model))
        if cfg.family == "encdec":
            batch["enc_embeds"] = stub_normal(
                gen, (data.batch, max(1, s_text // cfg.enc_seq_divisor),
                      cfg.d_model))
        yield batch
