"""Built-in ClusterSelect plugins (federation routing policies).

Each plugin contributes a feasibility mask and/or an additive score over
the member axis of the :class:`~repro_torch.core.federation.summary.
FederationSummary` — never a walk of member node arrays (the O(members)
routing contract).  They register in the shared framework registry, so
config-driven assemblies can mix them with out-of-tree policies.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..framework.api import ClusterSelectPlugin
from ..framework.registry import register
from ..job import Job
from .summary import FederationSummary


@register
class QuotaFitSelect(ClusterSelectPlugin):
    """Member-quota-aware routing: a member whose own
    :class:`~repro_torch.core.quota.QuotaManager` would reject the tenant
    statically is infeasible (the job would sit in that member's queue
    forever, §3.2.1); among admitting members, prefer the one with the
    most remaining tenant headroom."""

    name = "QuotaFitSelect"

    def __init__(self, weight: float = 1.0) -> None:
        self.weight = weight

    def feasible(self, job: Job, summary: FederationSummary
                 ) -> Optional[np.ndarray]:
        return np.asarray([m.quota.can_admit(job)
                           for m in summary.members], dtype=bool)

    def score(self, job: Job, summary: FederationSummary
              ) -> Optional[np.ndarray]:
        head = np.asarray([
            m.quota.tenant_quota(job.tenant, job.gpu_type)
            - m.quota.tenant_used(job.tenant, job.gpu_type)
            for m in summary.members], dtype=float)
        denom = max(1.0, float(job.n_gpus))
        return self.weight * np.clip(head / denom, 0.0, 4.0)


@register
class LeastLoadedSelect(ClusterSelectPlugin):
    """Utilization balancing: prefer the member with the highest free
    fraction in the job's GPU-type pool."""

    name = "LeastLoadedSelect"

    def __init__(self, weight: float = 1.0) -> None:
        self.weight = weight

    def score(self, job: Job, summary: FederationSummary
              ) -> Optional[np.ndarray]:
        return self.weight * summary.free_fraction(job.gpu_type)


@register
class GfrAwareSelect(ClusterSelectPlugin):
    """Fragmentation-aware routing (global GFR/starvation trade-off):
    sub-node jobs are steered TOWARD fragmented members — they fill the
    partial nodes — while multi-node gangs are steered AWAY, keeping
    defragmented members available for large-gang placements."""

    name = "GfrAwareSelect"

    def __init__(self, weight: float = 1.0) -> None:
        self.weight = weight

    def score(self, job: Job, summary: FederationSummary
              ) -> Optional[np.ndarray]:
        c = summary.col(job.gpu_type)
        small = (job.n_pods == 1 and c is not None
                 and bool((job.gpus_per_pod
                           < summary.max_node_cap[:, c]).any()))
        sign = 1.0 if small else -1.0
        return self.weight * sign * summary.frag


@register
class LocalityAffinitySelect(ClusterSelectPlugin):
    """Data-locality / region affinity: members in the job's home region
    earn a bonus; jobs without a region are indifferent.  Soft by design
    — spillover can still move a job cross-region, paying the GSCH's
    locality penalty on the forward."""

    name = "LocalityAffinitySelect"

    def __init__(self, weight: float = 1.0) -> None:
        self.weight = weight

    def score(self, job: Job, summary: FederationSummary
              ) -> Optional[np.ndarray]:
        if job.region is None:
            return None
        local = np.asarray([r == job.region for r in summary.regions],
                           dtype=float)
        return self.weight * local


@register
class CapabilityCostSelect(ClusterSelectPlugin):
    """ECCOS-style capability/cost coordination: route to the cheapest
    member whose pool meets the job's capability floor.  ``capability``
    defaults to 1.0 for pools without a declared score, so untagged
    members stay routable."""

    name = "CapabilityCostSelect"

    def __init__(self, cost_weight: float = 1.0,
                 capability_weight: float = 0.5,
                 min_capability: float = 0.0) -> None:
        self.cost_weight = cost_weight
        self.capability_weight = capability_weight
        self.min_capability = min_capability

    def feasible(self, job: Job, summary: FederationSummary
                 ) -> Optional[np.ndarray]:
        if self.min_capability <= 0.0:
            return None
        c = summary.col(job.gpu_type)
        if c is None:
            return None
        return summary.capability[:, c] >= self.min_capability

    def score(self, job: Job, summary: FederationSummary
              ) -> Optional[np.ndarray]:
        c = summary.col(job.gpu_type)
        if c is None:
            return None
        return (self.capability_weight * summary.capability[:, c]
                - self.cost_weight * summary.cost[:, c])
