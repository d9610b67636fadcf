"""Token-level cross-entropy with a numerically stable log-softmax: the
counterpart of the reference package's ``train/loss.py``.

Written in plain torch rather than ``F.cross_entropy``, which returns
NaN when every label is ignored where the reference returns 0.
"""

from __future__ import annotations

import torch

from ..sharding.context import shard_ways


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -1) -> torch.Tensor:
    """Mean CE over non-ignored positions.

    logits: (B, S, V) (any float dtype); labels: (B, S) int.  f32
    ``logsumexp - gold``, the gold logit gathered at ``max(labels, 0)``,
    averaged over ``max(count of labels != ignore_id, 1)``."""
    logits = logits.to(torch.float32)
    labels = torch.as_tensor(labels, device=logits.device)
    lse = torch.logsumexp(logits, dim=-1)
    idx = labels.clamp(min=0).long()
    if shard_ways(logits, -1) > 1:
        # Vocab-parallel: DTensor's gather over a sharded dim leaves a
        # masked partial sum that the select after it cannot reduce;
        # summing the logits at the label's one-hot position reduces as
        # an ordinary partial sum.
        hit = idx[..., None] == torch.arange(logits.shape[-1],
                                             device=logits.device)
        gold = torch.sum(logits * hit, dim=-1)
    else:
        gold = torch.gather(logits, -1, idx[..., None])[..., 0]
    nll = lse - gold
    mask = (labels != ignore_id).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
