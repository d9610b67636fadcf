"""Beyond-paper example plugins proving the framework's extensibility.

Each of these lands as a ~50-line Score plugin instead of a scheduler
fork; both are exercised end-to-end in ``examples/custom_plugins.py``
and compared in ``benchmarks/plugin_bench.py``.

* :class:`GfrAwareScore` — multi-objective fragmentation-aware scoring
  in the spirit of "Reducing Fragmentation and Starvation in GPU
  Clusters through Dynamic Multi-Objective Scheduling": score nodes by
  the GFR delta (§4.3) their selection would cause.
* :class:`TenantSoftAffinity` — tenant-semantic soft affinity /
  anti-affinity in the spirit of "Cluster Workload Allocation: Semantic
  Soft Affinity": pull a tenant's pods toward NodeNetGroups it already
  occupies, optionally away from groups occupied by other tenants.
* :class:`SemanticSoftAffinity` — the NLP-affinity generalization of
  the same idea: group affinity graded by token-overlap similarity of
  job *descriptions* (``Job.metadata``), so "llama70b sft ads" pulls
  toward "llama70b dpo ads" even across tenants.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..job import Job
from ..snapshot import Snapshot
from ..topology import ClusterTopology  # noqa: F401 — constructor params
from .api import SchedulingContext, ScorePlugin
from .registry import register


@register
class GfrAwareScore(ScorePlugin):
    """Snapshot-static GFR-delta term (§4.3 fragmentation rate).

    A node is *fragmented* when it is neither fully idle nor fully
    occupied.  Placing one pod of ``gpus_per_pod`` GPUs:

    * on a fragmented node it exactly fills -> heals it (GFR -1): bonus;
    * on an idle node it does not fill   -> fragments it (GFR +1): malus;
    * anywhere else the fragmented-node count is unchanged: neutral.

    With a ``topology`` the same delta also steers Level-1 NodeNetGroup
    preselection (``group_score``): groups holding heal-able nodes
    outrank groups of untouched idle nodes — without this, a spread
    pass preselects the emptiest group and never sees the fragmented
    ones (the multi-objective spread-vs-fragmentation trade-off).
    """

    name = "GfrAwareScore"

    def __init__(self, weight: float = 1.0,
                 topology: Optional[ClusterTopology] = None) -> None:
        self.weight = weight
        self.topology = topology

    def _node_delta(self, job: Job, snap: Snapshot) -> np.ndarray:
        free = snap.free_gpus
        used = snap.used_gpus
        fills = free == job.gpus_per_pod
        heals = fills & (used > 0)                 # fragmented -> full
        fragments = (used == 0) & ~fills           # idle -> fragmented
        return (heals.astype(np.float32)
                - fragments.astype(np.float32))

    def score(self, job: Job, snap: Snapshot, pool: np.ndarray,
              ctx: Optional[SchedulingContext]) -> np.ndarray:
        return self.weight * self._node_delta(job, snap)

    def group_score(self, job: Job, snap: Snapshot, pool: np.ndarray,
                    ctx: Optional[SchedulingContext]
                    ) -> Optional[np.ndarray]:
        if self.topology is None:
            return None
        topo = self.topology
        # Pool-masked: an out-of-pool (unhealthy / wrong-type / other
        # zone) healable node must not earn its group the top rank —
        # preselection would pin the job to a group it cannot use.
        delta = np.where(pool, self._node_delta(job, snap), 0.0)
        return self.weight * np.bincount(topo.leaf_id, weights=delta,
                                         minlength=topo.n_leaf_groups)


@register
class TenantSoftAffinity(ScorePlugin):
    """Tenant-semantic soft (anti-)affinity over NodeNetGroups.

    ``weight`` rewards LeafGroups already running pods of the job's
    tenant (keeps a tenant's traffic inside few groups);
    ``anti_weight`` penalizes groups running *other* tenants (soft
    isolation).  Soft: the terms bias group preselection
    (``group_score``) and node ranking (``score``), they never filter —
    a full cluster still schedules.

    Tenant occupancy is read from ``ctx.running`` (the QSCH running
    set); with no context the term vanishes.
    """

    name = "TenantSoftAffinity"

    def __init__(self, topology: ClusterTopology, weight: float = 1.0,
                 anti_weight: float = 0.0) -> None:
        self.topology = topology
        self.weight = weight
        self.anti_weight = anti_weight

    def _per_group(self, job: Job,
                   ctx: Optional[SchedulingContext]
                   ) -> Optional[np.ndarray]:
        running = getattr(ctx, "running", None)
        if not running:
            return None
        # One schedule call invokes this from group_score and score, per
        # pass; the occupancy scan is O(running pods) python, so reuse
        # the last result.  Occupancy is fully determined by the running
        # membership (placements of running jobs never mutate) and the
        # requesting tenant, so the key is exact — no id()-reuse or
        # same-length-different-members staleness.
        key = (job.tenant, tuple(running.keys()))
        cached = getattr(self, "_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        topo = self.topology
        own = np.zeros(topo.n_leaf_groups, dtype=np.float32)
        other = np.zeros(topo.n_leaf_groups, dtype=np.float32)
        for j in running.values():
            if j.placement is None:
                continue
            target = own if j.tenant == job.tenant else other
            for node in j.placement.nodes:
                target[int(topo.leaf_id[node])] = 1.0
        per_group = self.weight * own - self.anti_weight * other
        self._cache = (key, per_group)
        return per_group

    def group_score(self, job: Job, snap: Snapshot, pool: np.ndarray,
                    ctx: Optional[SchedulingContext]
                    ) -> Optional[np.ndarray]:
        return self._per_group(job, ctx)

    def score(self, job: Job, snap: Snapshot, pool: np.ndarray,
              ctx: Optional[SchedulingContext]) -> Optional[np.ndarray]:
        per_group = self._per_group(job, ctx)
        if per_group is None:
            return None
        return per_group[self.topology.leaf_id]


def _tokens(job: Job) -> frozenset:
    """Lower-cased token set of a job's description.  Jobs without
    ``metadata`` fall back to the tenant name, so the plugin degrades
    to tenant affinity on undescribed workloads."""
    text = job.metadata if job.metadata else job.tenant
    return frozenset(text.lower().split())


def token_similarity(a: frozenset, b: frozenset) -> float:
    """Jaccard similarity of two token sets (0.0 when either is empty)."""
    if not a or not b:
        return 0.0
    return len(a & b) / len(a | b)


@register
class SemanticSoftAffinity(ScorePlugin):
    """Semantic (NLP) soft affinity over NodeNetGroups.

    Generalizes :class:`TenantSoftAffinity` from the binary
    own-tenant/other-tenant split to a *graded* similarity: each
    LeafGroup is scored by the maximum Jaccard token overlap between
    the requesting job's description (:attr:`~repro_torch.core.job.Job.
    metadata`, falling back to the tenant name) and the descriptions of
    the jobs already running there.  Workloads that talk about the same
    model/dataset/framework consolidate into the same network groups —
    across tenant boundaries — while unrelated work feels no pull.

    ``anti_weight`` optionally pushes away from groups whose resident
    similarity is *below* ``anti_threshold`` (soft isolation of
    unrelated workloads).  Like its parent it is purely a Score plugin:
    it biases preselection and ranking, never filters.
    """

    name = "SemanticSoftAffinity"

    def __init__(self, topology: ClusterTopology, weight: float = 1.0,
                 anti_weight: float = 0.0,
                 anti_threshold: float = 0.1) -> None:
        self.topology = topology
        self.weight = weight
        self.anti_weight = anti_weight
        self.anti_threshold = anti_threshold

    def _per_group(self, job: Job,
                   ctx: Optional[SchedulingContext]
                   ) -> Optional[np.ndarray]:
        running = getattr(ctx, "running", None)
        if not running:
            return None
        # Same exact-key memoization as TenantSoftAffinity: occupancy
        # and similarities are fully determined by the running
        # membership and the requesting job's token set.
        tokens = _tokens(job)
        key = (tokens, tuple(running.keys()))
        cached = getattr(self, "_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        topo = self.topology
        best = np.zeros(topo.n_leaf_groups, dtype=np.float32)
        occupied = np.zeros(topo.n_leaf_groups, dtype=bool)
        for j in running.values():
            if j.placement is None:
                continue
            sim = token_similarity(tokens, _tokens(j))
            for node in j.placement.nodes:
                g = int(topo.leaf_id[node])
                occupied[g] = True
                if sim > best[g]:
                    best[g] = sim
        per_group = self.weight * best
        if self.anti_weight:
            unrelated = occupied & (best < self.anti_threshold)
            per_group = per_group - self.anti_weight * \
                unrelated.astype(np.float32)
        self._cache = (key, per_group)
        return per_group

    def group_score(self, job: Job, snap: Snapshot, pool: np.ndarray,
                    ctx: Optional[SchedulingContext]
                    ) -> Optional[np.ndarray]:
        return self._per_group(job, ctx)

    def score(self, job: Job, snap: Snapshot, pool: np.ndarray,
              ctx: Optional[SchedulingContext]) -> Optional[np.ndarray]:
        per_group = self._per_group(job, ctx)
        if per_group is None:
            return None
        return per_group[self.topology.leaf_id]
