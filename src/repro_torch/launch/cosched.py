"""Kant placement -> training-performance bridge (beyond-paper feature):
the counterpart of the reference package's ``launch/cosched.py``.

The paper's JTTED metric (§4.5) uses *deviation ratios* as a proxy for
training time, arguing that placements spanning more NodeNetGroups pay
more communication.  Because our framework also owns the workloads, we
close the loop: a Kant :class:`Placement` is translated into

1. a device mesh shape for the job (data × model over its GPUs), and
2. a **placement-aware roofline**: the job's collective term is scaled by
   the effective bisection bandwidth of its placement — intra-group
   traffic runs at full ICI rate; the fraction of ring traffic that
   crosses NodeNetGroup boundaries runs at the (slower) inter-group rate.

``estimated_step_time(terms, quality)`` shows E-Binpack's placements
are measurably better *in the performance model*, not just in the
deviation-ratio proxy.

``ICI_BW`` is the H100's NVLink rate (:mod:`.mesh`).  Only
:func:`effective_collective_bw` moves with it: ``estimated_step_time``
scales the collective term by ``ICI_BW / effective_collective_bw``, a
ratio in which the constant cancels (up to rounding).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.job import Placement
from ..core.topology import ClusterTopology
from .mesh import ICI_BW

# Inter-group (leaf-crossing) links run at a fraction of intra-group ICI;
# 4x oversubscription at the leaf->spine uplink is typical for AI fabrics.
INTER_GROUP_BW_FRACTION = 0.25


@dataclasses.dataclass(frozen=True)
class PlacementQuality:
    n_nodes: int
    n_groups: int
    node_dev: float          # actual / optimal nodes
    group_dev: float         # actual / optimal groups
    cross_group_fraction: float


def placement_quality(placement: Placement, topo: ClusterTopology,
                      n_gpus: int) -> PlacementQuality:
    nodes = placement.distinct_nodes()
    groups = {int(topo.leaf_id[n]) for n in nodes}
    opt_nodes = topo.optimal_node_num(n_gpus)
    opt_groups = topo.optimal_group_num(n_gpus)
    # Fraction of ring-allreduce hops that cross a group boundary when
    # nodes are ordered topologically: (#groups - 1) boundaries over
    # (#nodes) hops, doubled for the bidirectional ring.
    cross = (len(groups) - 1) / max(1, len(nodes))
    return PlacementQuality(
        n_nodes=len(nodes), n_groups=len(groups),
        node_dev=len(nodes) / max(1, opt_nodes),
        group_dev=len(groups) / max(1, opt_groups),
        cross_group_fraction=cross,
    )


def effective_collective_bw(quality: PlacementQuality) -> float:
    """Bandwidth-weighted harmonic mix of intra/inter-group hops."""
    f = quality.cross_group_fraction
    return 1.0 / ((1.0 - f) / ICI_BW
                  + f / (ICI_BW * INTER_GROUP_BW_FRACTION))


def estimated_step_time(terms: Dict[str, float],
                        quality: PlacementQuality) -> float:
    """Roofline step-time estimate for a placed job.

    ``terms`` are the per-device roofline seconds from the dry-run
    (compute/memory/collective at full ICI).  The collective term is
    rescaled by the placement's effective bandwidth; the step time is the
    max of the three (perfect-overlap model).
    """
    coll_bytes = terms["collective"] * ICI_BW
    coll = coll_bytes / effective_collective_bw(quality)
    return max(terms["compute"], terms["memory"], coll)


def job_mesh_shape(n_gpus: int, model_parallel: int = 8
                   ) -> Tuple[int, int]:
    """(data, model) mesh factorization for a job's GPU count."""
    model = model_parallel
    while model > 1 and (n_gpus % model or model > n_gpus):
        model //= 2
    model = max(1, model)
    return (n_gpus // model, model)
