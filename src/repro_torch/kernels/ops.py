"""Public entry points of the port's kernels.

Same API as the reference package's ``kernels/ops.py``: ``node_scores``,
``node_scores_and_slots``, ``gang_slot_prefilter``, ``gang_slot_topk``,
``best_node`` and ``wkv6``.  Node-table inputs are 1-D torch tensors
(numpy arrays are taken as CPU tensors); there is no padding to tiles.

Backend selection:

* ``backend="kernel"`` — the CUDA kernel for CUDA tensors, its plain
  torch version for CPU tensors (:mod:`.node_score`, :mod:`.wkv6`);
* ``backend="ref"``    — the plain torch version on the tensors' device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.scoring import ScoreWeights
from ..device import NEG_INF
from . import node_score as _ns
from . import wkv6 as _wkv
from .ref import node_scores_ref, node_scores_slots_ref, wkv6_ref

BACKENDS = ("kernel", "ref")


_COLUMN_DTYPES = (torch.int32, torch.int32, torch.bool, torch.float32,
                  torch.float32)


def _columns(free, used, mask, group_load, topo_pref):
    """The kernel's column dtypes, on ``free``'s device (no copy and no
    launch for columns that already have them)."""
    cols = (free, used, mask, group_load, topo_pref)
    if all(isinstance(t, torch.Tensor) and t.dtype == dt and t.is_contiguous()
           for t, dt in zip(cols, _COLUMN_DTYPES)) and all(
               t.device == free.device for t in cols[1:]):
        return cols
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
                backend: str = "kernel",
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused filter+score over an n-node table; returns (n,) f32 scores
    with ``NEG_INF`` at invalid nodes, written into ``out`` (a contiguous
    (n,) f32 tensor on the columns' device) when it is given."""
    kw = _kw(request, gpus_per_node, weights, w_used, w_fit, w_group, w_topo)
    cols = _columns(free, used, mask, group_load, topo_pref)
    if backend == "kernel":
        return _ns.node_scores(*cols, out=out, **kw)
    if backend == "ref":
        return _ns.fill(node_scores_ref(*cols, **kw), out)
    raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")


def node_scores_and_slots(free, used, mask, group_load, topo_pref, *,
                          request: int, gpus_per_node: int,
                          weights: Optional[ScoreWeights] = None,
                          w_used: float = 0.0, w_fit: float = 0.0,
                          w_group: float = 0.0, w_topo: float = 0.0,
                          backend: str = "kernel", out=None):
    """Fused (scores, pod_slots) pass for batched gang placement.

    One sweep over the node table yields both the per-node score and the
    number of pod slots ``floor(free / request)`` each node contributes
    (0 where invalid), feeding the whole-gang top-k slot selection in
    :func:`repro_torch.core.scoring.select_gang_slots`.  ``out``, if
    given, is a (scores f32, slots int32) pair of contiguous (n,) tensors
    on the columns' device, filled and returned.
    """
    kw = _kw(request, gpus_per_node, weights, w_used, w_fit, w_group, w_topo)
    cols = _columns(free, used, mask, group_load, topo_pref)
    if backend == "kernel":
        return _ns.node_scores_slots(*cols, out=out, **kw)
    if backend == "ref":
        return _ns.fill_pair(*node_scores_slots_ref(*cols, **kw), out)
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


def wkv6(r, k, v, w, u, s0, *, backend: str = "kernel"):
    """RWKV-6 WKV recurrence over a full sequence.

    r, k, v, w: (B, T, H, n) f32 or bf16; u: (H, n); s0: (B, H, n, n).
    Returns (o (B, T, H, n) f32, S_T (B, H, n, n) f32).  u and s0 are
    taken in f32 and the streams contiguous (no copy where they are).

    ``backend="kernel"`` has no backward: with gradients on and an input
    that requires them it raises, on every device, rather than return an
    output cut from the graph.  Differentiate through ``"ref"``."""
    if backend == "kernel" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, s0)):
        raise RuntimeError(
            "wkv6 backend='kernel' has no backward; use backend='ref' "
            "(time_mix 'scan') to differentiate")
    r, k, v, w = (t.contiguous() for t in (r, k, v, w))
    u = u.to(torch.float32).contiguous()
    s0 = s0.to(torch.float32).contiguous()
    if backend == "kernel":
        return _wkv.wkv6(r, k, v, w, u, s0)
    if backend == "ref":
        return wkv6_ref(r, k, v, w, u, s0)
    raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
