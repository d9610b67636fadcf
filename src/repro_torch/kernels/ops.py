"""Public entry points of the node-scoring kernels.

Same API as the reference package's ``kernels/ops.py``: ``node_scores``,
``node_scores_and_slots``, ``gang_slot_prefilter``, ``gang_slot_topk``
and ``best_node``.  Inputs are 1-D torch tensors (numpy arrays are taken
as CPU tensors); there is no padding to tiles.

Backend selection:

* ``backend="kernel"`` — the CUDA kernel for CUDA tensors, its plain
  torch version for CPU tensors (:mod:`.node_score`);
* ``backend="ref"``    — the plain torch version on the tensors' device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.scoring import ScoreWeights
from ..device import NEG_INF
from . import node_score as _ns
from .ref import node_scores_ref, node_scores_slots_ref

BACKENDS = ("kernel", "ref")


def _columns(free, used, mask, group_load, topo_pref):
    """The kernel's column dtypes, on ``free``'s device (no copy and no
    launch for columns that already have them)."""
    free = torch.as_tensor(free)
    dev = free.device
    mask = torch.as_tensor(mask, device=dev)
    if mask.dtype != torch.bool:
        mask = mask != 0
    return (free.to(torch.int32).contiguous(),
            torch.as_tensor(used, device=dev).to(torch.int32).contiguous(),
            mask.contiguous(),
            torch.as_tensor(group_load, device=dev).to(
                torch.float32).contiguous(),
            torch.as_tensor(topo_pref, device=dev).to(
                torch.float32).contiguous())


def _kw(request, gpus_per_node, weights, w_used, w_fit, w_group, w_topo):
    if weights is not None:
        w_used, w_fit = weights.used, weights.fit
        w_group, w_topo = weights.group, weights.topo
    return dict(request=int(request), gpus_per_node=int(gpus_per_node),
                w_used=w_used, w_fit=w_fit, w_group=w_group, w_topo=w_topo)


def node_scores(free, used, mask, group_load, topo_pref, *, request: int,
                gpus_per_node: int,
                weights: Optional[ScoreWeights] = None,
                w_used: float = 0.0, w_fit: float = 0.0,
                w_group: float = 0.0, w_topo: float = 0.0,
                backend: str = "kernel") -> torch.Tensor:
    """Fused filter+score over an n-node table; returns (n,) f32 scores
    with ``NEG_INF`` at invalid nodes."""
    kw = _kw(request, gpus_per_node, weights, w_used, w_fit, w_group, w_topo)
    cols = _columns(free, used, mask, group_load, topo_pref)
    if backend == "kernel":
        return _ns.node_scores(*cols, **kw)
    if backend == "ref":
        return node_scores_ref(*cols, **kw)
    raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")


def node_scores_and_slots(free, used, mask, group_load, topo_pref, *,
                          request: int, gpus_per_node: int,
                          weights: Optional[ScoreWeights] = None,
                          w_used: float = 0.0, w_fit: float = 0.0,
                          w_group: float = 0.0, w_topo: float = 0.0,
                          backend: str = "kernel"):
    """Fused (scores, pod_slots) pass for batched gang placement.

    One sweep over the node table yields both the per-node score and the
    number of pod slots ``floor(free / request)`` each node contributes
    (0 where invalid), feeding the whole-gang top-k slot selection in
    :func:`repro_torch.core.scoring.select_gang_slots`.
    """
    kw = _kw(request, gpus_per_node, weights, w_used, w_fit, w_group, w_topo)
    cols = _columns(free, used, mask, group_load, topo_pref)
    if backend == "kernel":
        return _ns.node_scores_slots(*cols, **kw)
    if backend == "ref":
        return node_scores_slots_ref(*cols, **kw)
    raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")


def gang_slot_prefilter(scores, slots, n_pods: int,
                        device: Optional[torch.device] = None
                        ) -> np.ndarray:
    """Top-``n_pods`` candidate-node prefilter, on ``device`` (default:
    the device of ``scores``).

    Set-equivalent to the numpy ``argpartition`` prefilter in
    ``repro_torch.core.scoring``: among nodes with at least one pod
    slot, the ``n_pods`` best by (slot-0 score desc, index asc).
    ``torch.topk`` documents no tie order, so this sorts stably over
    ascending indices, which puts the lower index first among equal
    scores (the reference's ``lax.top_k`` rule).  Returns ascending
    int64 node indices.
    """
    scores = torch.as_tensor(scores, device=device)
    has = torch.as_tensor(slots, device=scores.device) > 0
    cand_total = int(has.sum())
    if cand_total <= n_pods:
        return torch.nonzero(has).flatten().cpu().numpy().astype(np.int64)
    masked = torch.where(has, scores, torch.tensor(
        NEG_INF, dtype=scores.dtype, device=scores.device))
    idx = torch.sort(masked, descending=True, stable=True).indices[:n_pods]
    idx = idx[has[idx]]
    return np.sort(idx.cpu().numpy().astype(np.int64))


def gang_slot_topk(free, used, mask, group_load, topo_pref, *,
                   request: int, gpus_per_node: int,
                   weights: ScoreWeights, n_pods: int,
                   fit_weight: float = 0.0, colocate_bonus: float = 0.0,
                   backend: str = "kernel"):
    """Fully fused gang placement: one (scores, slots) kernel sweep, the
    top-k candidate prefilter, and the shared exact-f64 chain epilogue
    from ``repro_torch.core.scoring`` — exact-match vs the heap loop
    whenever the slot chains are nondecreasing.

    Returns the pod→node index list, or ``None`` when the gang does not
    fit.  Raises ``ValueError`` if the weight signs violate the
    nondecreasing-chain precondition (callers should route such jobs to
    the heap engine instead).
    """
    from ..core.scoring import chains_nondecreasing, emit_slot_chains

    if not chains_nondecreasing(fit_weight, colocate_bonus):
        raise ValueError(
            "gang_slot_topk requires nondecreasing slot chains "
            "(colocate_bonus >= 0 and colocate_bonus + fit_weight >= 0)")
    scores, slots = node_scores_and_slots(
        free, used, mask, group_load, topo_pref, request=request,
        gpus_per_node=gpus_per_node, weights=weights, backend=backend)
    if int(slots.sum()) < n_pods:
        return None
    cand = gang_slot_prefilter(scores, slots, n_pods)
    return emit_slot_chains(cand, scores.cpu().numpy(),
                            torch.as_tensor(free).cpu().numpy(),
                            slots.cpu().numpy(), request, n_pods,
                            fit_weight, colocate_bonus)


def best_node(free, used, mask, group_load, topo_pref, *, request: int,
              gpus_per_node: int, weights: ScoreWeights,
              backend: str = "kernel") -> int:
    """Argmax helper (first index among equal maxima, as ``np.argmax``);
    returns -1 when no node is valid."""
    scores = node_scores(free, used, mask, group_load, topo_pref,
                         request=request, gpus_per_node=gpus_per_node,
                         weights=weights, backend=backend).cpu().numpy()
    idx = int(np.argmax(scores))
    if float(scores[idx]) <= NEG_INF:
        return -1
    return idx
