"""Plain PyTorch versions of the fused node filter+score pass.

Semantics match :func:`repro_torch.core.scoring.node_scores_np` bit for
bit: f32 throughout, weights rounded once to f32, ``used / g`` (a true
division, not a multiply by ``1/g``), and numpy's evaluation order
``((w_u·(used/g) + w_f·fit) + w_g·gload) + w_t·topo``.  Each operand that
is not a node column is a 0-d tensor on the columns' device: CUDA
divides by a *CPU scalar* as a multiply by its reciprocal, which would
break bit-equality at g = 6.  Each op is its own launch, so nothing is
contracted into an FMA.  These run on CPU or CUDA tensors; the CUDA
kernel in :mod:`repro_torch.kernels.node_score` is held against them.
"""

from __future__ import annotations

import torch

from ..device import NEG_INF


def node_scores_ref(free: torch.Tensor, used: torch.Tensor,
                    mask: torch.Tensor, group_load: torch.Tensor,
                    topo_pref: torch.Tensor, *, request: int,
                    gpus_per_node: int, w_used: float, w_fit: float,
                    w_group: float, w_topo: float) -> torch.Tensor:
    """Score every node, ``NEG_INF`` where invalid.

    Args:
      free:       (n,) int — healthy free devices per node.
      used:       (n,) int — healthy allocated devices per node.
      mask:       (n,) bool/int — node is in the candidate pool.
      group_load: (n,) f32 — load fraction of the node's NodeNetGroup,
                  pre-gathered to node axis.
      topo_pref:  (n,) f32 — anchor-group preference for this job.
    """
    dev = free.device

    def f32(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=dev)

    free_f = free.to(torch.float32)
    used_f = used.to(torch.float32)
    req = f32(float(request))
    valid = (mask != 0) & (free_f >= req)
    exact = (free_f == req).to(torch.float32)
    score = f32(w_used) * (used_f / f32(float(gpus_per_node)))
    score = score + f32(w_fit) * exact
    score = score + f32(w_group) * group_load.to(torch.float32)
    score = score + f32(w_topo) * topo_pref.to(torch.float32)
    return torch.where(valid, score, f32(NEG_INF))


def node_scores_slots_ref(free: torch.Tensor, used: torch.Tensor,
                          mask: torch.Tensor, group_load: torch.Tensor,
                          topo_pref: torch.Tensor, *, request: int,
                          gpus_per_node: int, w_used: float, w_fit: float,
                          w_group: float, w_topo: float):
    """Fused (scores, pod_slots): slots = ``free // request`` where
    valid, else 0 (int32)."""
    scores = node_scores_ref(free, used, mask, group_load, topo_pref,
                             request=request, gpus_per_node=gpus_per_node,
                             w_used=w_used, w_fit=w_fit, w_group=w_group,
                             w_topo=w_topo)
    free_i = free.to(torch.int32)
    valid = (mask != 0) & (free_i >= request)
    slots = torch.where(valid, torch.div(free_i, request,
                                         rounding_mode="floor"),
                        torch.zeros_like(free_i))
    return scores, slots.to(torch.int32)
