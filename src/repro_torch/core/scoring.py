"""Node filter+score pass shared by RSCH, the plain torch version and the
CUDA kernel, plus the batched gang-placement slot selection built on top
of it.

For every candidate node the scheduler computes one fused score

    score[i] = valid[i] ? ( w_used  * used[i]/G
                          + w_fit   * exact_fit[i]
                          + w_group * group_load[i]
                          + w_topo  * topo_pref[i] )
             : NEG_INF

where ``valid[i] = mask[i] & (free[i] >= request)``.  Sign conventions on
the weight vector select the strategy:

* **Binpack / E-Binpack** (§3.3.3): ``w_used > 0`` packs busy nodes first,
  ``w_fit`` rewards exact fits (leaves no fragment behind), ``w_group > 0``
  consolidates into already-busy NodeNetGroups (LeafGroup-level E-Binpack),
  ``w_topo > 0`` pulls pods of one job toward its anchor group.
* **Spread / E-Spread** (§3.3.4): ``w_used < 0`` prefers idle nodes.

This module holds the *numpy* implementation (the host A/B path);
``repro_torch.kernels.ref`` is the plain torch version and
``repro_torch.kernels.node_score`` the CUDA kernel.  All three evaluate
in numpy's f32 order and agree bit for bit (``tests/test_torch_kernels.py``).
:func:`compute_node_scores` and :func:`compute_node_scores_and_slots`
are the host-to-device seam RSCH calls, so it can switch backends via
config.

**Batched gang placement** (§3.4 search-space reduction): instead of
re-running the full score pass once per pod, a gang job is placed with
ONE fused pass.  Each valid node is expanded into
``floor(free / gpus_per_pod)`` pod *slots*; the value of node ``i``'s
``p``-th slot reproduces what the sequential per-pod rescoring loop
would have seen at the step that consumed it:

    slot(i, p) = base[i] + colocate_bonus * p
               + w_fit * [free[i] - p*request == request]

(the co-location bonus and the moving exact-fit term are the only parts
of the score that depend on earlier pods of the same job — ``used``,
``group_load`` and ``topo_pref`` are snapshot-static).  A lazy-greedy
heap pop over these per-node slot chains is an *exact* emulation of the
sequential argmax loop, including its lowest-index tie-breaking, at
O(n + pods·log n) instead of O(pods·n).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Iterable, List, Optional

import numpy as np

NEG_INF = float(np.finfo(np.float32).min)


@dataclasses.dataclass(frozen=True)
class ScoreWeights:
    used: float = 0.0
    fit: float = 0.0
    group: float = 0.0
    topo: float = 0.0

    def as_array(self) -> np.ndarray:
        return np.asarray([self.used, self.fit, self.group, self.topo],
                          dtype=np.float32)


def combine_weights(weights: "Iterable[ScoreWeights]") -> ScoreWeights:
    """Sum per-term weights contributed by a Score plugin chain into the
    single weight vector of the fused filter+score pass."""
    used = fit = group = topo = 0.0
    for w in weights:
        used += w.used
        fit += w.fit
        group += w.group
        topo += w.topo
    return ScoreWeights(used=used, fit=fit, group=group, topo=topo)


BINPACK = ScoreWeights(used=1.0, fit=0.5, group=0.0, topo=0.0)
E_BINPACK = ScoreWeights(used=1.0, fit=0.5, group=0.75, topo=1.5)
SPREAD = ScoreWeights(used=-1.0, fit=0.0, group=0.0, topo=0.0)
E_SPREAD = ScoreWeights(used=-1.0, fit=0.0, group=-0.25, topo=0.0)


def node_scores_np(free: np.ndarray, used: np.ndarray, mask: np.ndarray,
                   group_load: np.ndarray, topo_pref: np.ndarray,
                   request: int, gpus_per_node: int,
                   weights: ScoreWeights) -> np.ndarray:
    """Reference numpy implementation; the CUDA kernel and the plain
    torch version evaluate in this same f32 order."""
    free = free.astype(np.float32)
    used = used.astype(np.float32)
    valid = mask & (free >= float(request))
    used_norm = used / float(gpus_per_node)
    exact_fit = (free == float(request)).astype(np.float32)
    score = (weights.used * used_norm
             + weights.fit * exact_fit
             + weights.group * group_load.astype(np.float32)
             + weights.topo * topo_pref.astype(np.float32))
    return np.where(valid, score, NEG_INF).astype(np.float32)


def compute_node_scores(free: np.ndarray, used: np.ndarray,
                        mask: np.ndarray, group_load: np.ndarray,
                        topo_pref: np.ndarray, request: int,
                        gpus_per_node: int, weights: ScoreWeights,
                        backend: str = "np",
                        device: Optional[str] = None) -> np.ndarray:
    """One API over the numpy reference and the torch/CUDA kernels.

    ``backend`` is ``"np"`` (default — host numpy), ``"ref"`` (plain
    torch on ``device``) or ``"kernel"`` (the CUDA kernel on a CUDA
    device, its plain version on ``device="cpu"``).  ``device=None``
    means CUDA.  All return the same (n,) f32 host score vector with
    ``NEG_INF`` at invalid nodes.
    """
    if backend == "np":
        return node_scores_np(free, used, mask, group_load, topo_pref,
                              request, gpus_per_node, weights)
    from ..kernels.ops import node_scores  # deferred: keep np path torch-free
    args = _upload(free, used, mask, group_load, topo_pref, device)
    return node_scores(*args, request=request, gpus_per_node=gpus_per_node,
                       weights=weights, backend=backend).cpu().numpy()


def compute_node_scores_and_slots(free: np.ndarray, used: np.ndarray,
                                  mask: np.ndarray, group_load: np.ndarray,
                                  topo_pref: np.ndarray, request: int,
                                  gpus_per_node: int, weights: ScoreWeights,
                                  backend: str = "kernel",
                                  device: Optional[str] = None):
    """Fused (scores, pod_slots) pass of the batched gang path on the
    device: uploads the five node-table columns, runs one kernel, copies
    both outputs back.  Returns host ``(f32 scores, int64 slots)``."""
    from ..kernels.ops import node_scores_and_slots  # deferred
    args = _upload(free, used, mask, group_load, topo_pref, device)
    s, sl = node_scores_and_slots(
        *args, request=request, gpus_per_node=gpus_per_node,
        weights=weights, backend=backend)
    return s.cpu().numpy(), sl.cpu().numpy().astype(np.int64)


def _upload(free, used, mask, group_load, topo_pref, device):
    """Host node-table columns -> contiguous copies in the kernel's
    dtypes on ``device`` (``None`` = CUDA)."""
    import torch

    from ..device import resolve_device
    dev = resolve_device(device)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(dev)
        for a, dt in ((free, np.int32), (used, np.int32), (mask, np.bool_),
                      (group_load, np.float32), (topo_pref, np.float32)))


def pod_slots_np(free: np.ndarray, scores: np.ndarray,
                 request: int) -> np.ndarray:
    """Capacity expansion: pod slots contributed by each scored node."""
    valid = scores > NEG_INF
    return np.where(valid, free // request, 0).astype(np.int64)


def _prefilter_np(scores: np.ndarray, slots: np.ndarray,
                  n_pods: int) -> np.ndarray:
    """Restrict slot selection to the top-``n_pods`` candidate nodes.

    At most ``n_pods`` distinct nodes are ever popped, and a node's
    FIRST pop happens at its slot-0 value — which must then be ≥ the
    static slot-0 value of every never-popped node.  So the selection
    can be restricted to the top-``n_pods`` candidates by (slot-0 value
    desc, index asc); everything below that line is unreachable.
    ``argpartition`` keeps this O(n).  Returns candidate node indices in
    ascending order.
    """
    cand = np.nonzero(slots > 0)[0]
    if len(cand) > n_pods:
        vals = scores[cand]
        part = np.argpartition(-vals, n_pods - 1)[:n_pods]
        thresh = vals[part].min()
        above = np.nonzero(vals > thresh)[0]
        ties = np.nonzero(vals == thresh)[0][:n_pods - len(above)]
        cand = cand[np.sort(np.concatenate([above, ties]))]
    return cand


def chains_nondecreasing(fit_weight: float, colocate_bonus: float) -> bool:
    """True when every node's slot-value chain is nondecreasing in the
    slot index — the precondition for the vectorized top-k engine.

    ``slot(i, p) = base[i] + colocate_bonus·p (+ fit_weight at the last
    slot when free is an exact multiple of request)``, so consecutive
    deltas are ``colocate_bonus`` everywhere except into the final
    exact-fit slot, where the delta is ``colocate_bonus + fit_weight``.
    Builtin profiles satisfy both (bonus 2.0, fit ≥ 0); plugins may
    contribute negative weights, in which case the heap engine is used.
    """
    return colocate_bonus >= 0.0 and colocate_bonus + fit_weight >= 0.0


def emit_slot_chains(cand: np.ndarray, scores: np.ndarray,
                     free: np.ndarray, slots: np.ndarray, request: int,
                     n_pods: int, fit_weight: float,
                     colocate_bonus: float) -> List[int]:
    """Exact f64 epilogue shared by the numpy and kernel top-k paths.

    With nondecreasing chains (:func:`chains_nondecreasing`) the lazy
    heap provably emits each popped node's ENTIRE chain consecutively:
    once node ``c`` wins a pop, its next slot value is ≥ its slot-0
    value, which in turn beats (strictly, or by the lower-index tie
    rule) every never-popped node's slot-0 value.  Heap order therefore
    collapses to: sort candidates by (slot-0 value desc, index asc),
    concatenate full chains, truncate at ``n_pods``.

    Float exactness: slot-0 values replicate the heap's arithmetic
    bit-for-bit — f64 base with the exact-fit weight subtracted and
    re-added (NOT algebraically simplified, since ``(x − w) + w ≠ x``
    in floats).  ``np.argsort(kind="stable")`` over an ascending
    candidate array preserves the heap's lowest-index tie-breaking.
    """
    cand = np.sort(np.asarray(cand, dtype=np.int64))
    sfree = free[cand].astype(np.int64)
    base = scores[cand].astype(np.float64)
    exact0 = sfree == request
    base = np.where(exact0, base - fit_weight, base)
    s0 = np.where(exact0, base + fit_weight, base)
    order = np.argsort(-s0, kind="stable")
    counts = np.asarray(slots, dtype=np.int64)[cand][order]
    return np.repeat(cand[order], counts)[:n_pods].tolist()


def select_gang_slots(scores: np.ndarray, free: np.ndarray, request: int,
                      n_pods: int, *, fit_weight: float = 0.0,
                      colocate_bonus: float = 0.0,
                      slots: Optional[np.ndarray] = None,
                      engine: str = "heap",
                      device: Optional[str] = None
                      ) -> Optional[List[int]]:
    """Capacity-aware top-k slot selection for a whole gang at once.

    ``scores`` is the fused filter+score output for the *snapshot* free
    counts (slot 0 of every node).  Returns the node index for each pod
    in placement order, or ``None`` when fewer than ``n_pods`` slots
    exist.

    ``engine`` selects the implementation — all exact-identical:

    * ``"heap"`` — the lazy-greedy heap pop (the A/B oracle).  One
      entry per node, so each pop is the argmax the sequential loop
      would have taken (ties break toward the lower node index,
      matching ``np.argmax``).
    * ``"topk"`` — vectorized sort + chain emission
      (:func:`emit_slot_chains`), O(k log k) after an O(n) prefilter
      with no Python loop.
    * ``"topk_kernel"`` — same epilogue behind a torch top-k prefilter
      on ``device`` (``repro_torch.kernels.ops.gang_slot_prefilter``).

    The vectorized engines require nondecreasing slot chains; when
    plugin weights violate that (:func:`chains_nondecreasing`), they
    fall back to the heap automatically.
    """
    free = np.asarray(free)
    if slots is None:
        slots = pod_slots_np(free, scores, request)
    if int(slots.sum()) < n_pods:
        return None
    if engine != "heap" and chains_nondecreasing(fit_weight,
                                                 colocate_bonus):
        if engine == "topk_kernel":
            from ..kernels.ops import gang_slot_prefilter  # deferred
            from ..device import resolve_device
            cand = gang_slot_prefilter(scores, slots, n_pods,
                                       device=resolve_device(device))
        else:
            cand = _prefilter_np(scores, slots, n_pods)
        return emit_slot_chains(cand, scores, free, slots, request,
                                n_pods, fit_weight, colocate_bonus)
    cand = _prefilter_np(scores, slots, n_pods)
    # Per-node slot chains.  base strips the slot-0 exact-fit term so it
    # can be re-added at whichever slot the fit actually moves to.
    sfree = free[cand].astype(np.int64)
    base = scores[cand].astype(np.float64)
    base = np.where(sfree == request, base - fit_weight, base)
    exact_slot = np.where(sfree % request == 0, sfree // request - 1, -1)
    cslots = slots[cand]

    def slot_value(c: int, p: int) -> float:
        v = base[c] + colocate_bonus * p
        if p == exact_slot[c]:
            v += fit_weight
        return v

    heap = list(zip((-np.where(sfree == request, base + fit_weight, base)
                     ).tolist(), cand.tolist(), range(len(cand))))
    heapq.heapify(heap)
    placed = [0] * len(cand)
    order: List[int] = []
    while len(order) < n_pods:
        _, i, c = heapq.heappop(heap)
        order.append(i)
        placed[c] += 1
        if placed[c] < cslots[c]:
            heapq.heappush(heap, (-slot_value(c, placed[c]), i, c))
    return order
