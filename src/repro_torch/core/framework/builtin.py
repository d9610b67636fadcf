"""The paper's scheduler behaviors, shipped as built-in plugins.

Everything QSCH/RSCH did before the framework refactor is expressed
here: queue ordering, two-tier admission, node-pool filtering, the four
strategy weight-sets (Binpack / E-Binpack / Spread / E-Spread decomposed
into BinpackScore/SpreadScore + GroupConsolidation + TopoAnchor),
same-node co-location, quota reservation, the three preemption policies
and the three Table-1 queue policies.  ``default_profiles()`` assembles
them into the train / inference / best-effort profiles that are
placement-identical to the legacy ``Strategy``/``QueuePolicy`` enums.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..job import Job, JobKind, JobState, Placement
from ..scoring import ScoreWeights
from ..snapshot import Snapshot
from .api import (AdmitPlugin, CycleContext, FilterPlugin, PermitPlugin,
                  PlacementPass, PlanFn, PostBindPlugin, PreemptPlugin,
                  ProfileSet, QueuePolicyPlugin, QueueSortPlugin,
                  ReservePlugin, SchedulingProfile, ScorePlugin,
                  single_pass_plan)
from .registry import register


# ----------------------------------------------------------------------
# QueueSort
# ----------------------------------------------------------------------
@register
class DefaultQueueSort(QueueSortPlugin):
    """§3.2.2 ordering: priority desc, submit time, size, uid."""

    name = "DefaultQueueSort"

    def key(self, job: Job) -> Tuple:
        return job.order_key()


# ----------------------------------------------------------------------
# Admit
# ----------------------------------------------------------------------
@register
class QuotaAdmit(AdmitPlugin):
    """Static quota admission (§3.2.1): tenant quota, borrow-aware."""

    name = "QuotaAdmit"
    stage = "static"

    def admit(self, job: Job, ctx: CycleContext) -> bool:
        return ctx.quota.can_admit(job)


@register
class DynamicFeasibility(AdmitPlugin):
    """Dynamic resource admission (§3.2.1): enough free healthy GPUs in
    the job's node pool on the working snapshot."""

    name = "DynamicFeasibility"
    stage = "dynamic"

    def admit(self, job: Job, ctx: CycleContext) -> bool:
        return ctx.rsch.feasible(job, ctx.snap)


# ----------------------------------------------------------------------
# Filter
# ----------------------------------------------------------------------
@register
class GpuTypeFilter(FilterPlugin):
    """GPU-Type-based node pool membership (§3.4.1)."""

    name = "GpuTypeFilter"

    def mask(self, job: Job, snap: Snapshot,
             zone: Optional[str]) -> np.ndarray:
        return snap.gpu_type == job.gpu_type


@register
class HealthFilter(FilterPlugin):
    """Only schedulable (healthy) nodes."""

    name = "HealthFilter"

    def mask(self, job: Job, snap: Snapshot,
             zone: Optional[str]) -> np.ndarray:
        return snap.node_healthy

#: When a pass's filter chain is exactly this pair, the engine resolves
#: it through the snapshot's cached ``candidate_pool`` mask instead of
#: two O(n) boolean passes per schedule call (§3.4.1 fast path).
DEFAULT_FILTERS: Tuple[FilterPlugin, ...] = (GpuTypeFilter(),
                                             HealthFilter())


# ----------------------------------------------------------------------
# Score
# ----------------------------------------------------------------------
class WeightSetScore(ScorePlugin):
    """Snapshot-static weights folded into the fused filter+score pass."""

    def __init__(self, weights: ScoreWeights) -> None:
        self.weights = weights

    def fused_weights(self, job: Job) -> ScoreWeights:
        return self.weights


@register
class BinpackScore(WeightSetScore):
    """Node-level binpack (§3.3.3): pack busy nodes, reward exact fits."""

    name = "BinpackScore"

    def __init__(self, used: float = 1.0, fit: float = 0.5) -> None:
        super().__init__(ScoreWeights(used=used, fit=fit))


@register
class SpreadScore(WeightSetScore):
    """Spread (§3.3.4): prefer idle nodes."""

    name = "SpreadScore"

    def __init__(self, used: float = -1.0) -> None:
        super().__init__(ScoreWeights(used=used))


@register
class GroupConsolidation(WeightSetScore):
    """LeafGroup-level load term (§3.3.3): positive weight consolidates
    into busy NodeNetGroups (E-Binpack), negative spreads (E-Spread)."""

    name = "GroupConsolidation"

    def __init__(self, weight: float = 0.75) -> None:
        super().__init__(ScoreWeights(group=weight))


@register
class TopoAnchor(WeightSetScore):
    """Anchor-group preference (§3.3.5): pulls pods of one job toward
    its best-ranked NodeNetGroups (fewest groups, same spine)."""

    name = "TopoAnchor"

    def __init__(self, weight: float = 1.5) -> None:
        super().__init__(ScoreWeights(topo=weight))


@register
class ColocateBonus(ScorePlugin):
    """Pod-dependent same-node co-location bonus (node-level E-Binpack,
    §3.3.3): each pod of the job already on a node makes that node more
    attractive for the next pod.  Folded into the batched slot chains."""

    name = "ColocateBonus"
    pod_dependent = True

    def __init__(self, bonus: float = 2.0) -> None:
        self.bonus = bonus

    def per_pod_bonus(self, job: Job) -> float:
        return self.bonus


# ----------------------------------------------------------------------
# Reserve
# ----------------------------------------------------------------------
@register
class QuotaReserve(ReservePlugin):
    """Transactional quota charge for the gang commit (§3.2.1/§3.3.2)."""

    name = "QuotaReserve"

    def reserve(self, job: Job, placement: Placement,
                ctx: CycleContext) -> bool:
        ctx.quota.charge(job)
        return True

    def unreserve(self, job: Job, placement: Placement,
                  ctx: CycleContext) -> None:
        ctx.quota.refund(job)


# ----------------------------------------------------------------------
# Preempt (§3.2.3) — three policies, one conservative engine
# ----------------------------------------------------------------------
@register
class PriorityPreempt(PreemptPlugin):
    """Priority preemption: strictly-lower-priority preemptible work in
    the blocked job's node pool."""

    name = "PriorityPreempt"

    def victims(self, job: Job, ctx: CycleContext) -> List[Job]:
        return [j for j in ctx.running.values()
                if j.priority < job.priority and j.preemptible
                and j.gpu_type == job.gpu_type]


@register
class QuotaReclaimPreempt(PreemptPlugin):
    """Quota-reclamation preemption: shared-mode borrowers whose loan
    blocks the owner's own quota."""

    name = "QuotaReclaimPreempt"

    def victims(self, job: Job, ctx: CycleContext) -> List[Job]:
        return ctx.quota.reclaim_candidates(
            job.tenant, job.gpu_type, list(ctx.running.values()))


@register
class BackfillHeadTimeout(PreemptPlugin):
    """Backfill preemption: a head blocked past its timeout evicts
    backfilled jobs (newest first) — but only when the dry-run shows the
    head can actually become schedulable (conservative policy)."""

    name = "BackfillHeadTimeout"

    def victims(self, head: Job, ctx: CycleContext) -> List[Job]:
        v = [j for j in ctx.running.values()
             if j.backfilled and j.preemptible
             and j.gpu_type == head.gpu_type]
        v.sort(key=lambda j: -(j.start_time or 0.0))
        return v

    def execute(self, head: Job, ctx: CycleContext) -> None:
        if not ctx.sched.structurally_placeable(head, ctx):
            return  # no eviction set can ever make the head fit
        victims = self.victims(head, ctx)
        pool_free = ctx.state.pool_free(head.gpu_type)
        reclaimable = sum(v.n_gpus for v in victims)
        if pool_free + reclaimable < head.n_gpus:
            return  # preemption cannot help; don't thrash
        budget = ctx.sched.config.max_preemptions_per_cycle
        for victim in victims:
            if budget <= 0:
                break
            if ctx.sched.dynamic_admit(head, ctx) and \
                    ctx.rsch.schedule(head, ctx.snap,
                                      ctx).placement is not None:
                return
            ctx.sched.preempt_job(victim, ctx)
            budget -= 1


# ----------------------------------------------------------------------
# QueuePolicy (Table 1)
# ----------------------------------------------------------------------
@register
class StrictFIFOPolicy(QueuePolicyPlugin):
    """Strict FIFO: one blocked head blocks everyone."""

    name = "StrictFIFO"
    strict_head = True

    def run_cycle(self, queue: List[Job], ctx: CycleContext) -> None:
        for job in queue:
            if not ctx.sched.try_place(job, ctx):
                ctx.result.blocked_head = job
                return


@register
class BestEffortFIFOPolicy(QueuePolicyPlugin):
    """Best-Effort FIFO: skip unschedulable jobs.  Deliberately leaves
    ``blocked_head`` unset -> no preemption assist, which is what
    starves large jobs in the paper's Fig 4."""

    name = "BestEffortFIFO"

    def run_cycle(self, queue: List[Job], ctx: CycleContext) -> None:
        for job in queue:
            ctx.sched.try_place(job, ctx)


@register
class BackfillPolicy(QueuePolicyPlugin):
    """Backfill: smaller jobs run behind a blocked head; after
    ``head_timeout`` seconds the head preempts them (via the
    BackfillHeadTimeout Preempt plugin)."""

    name = "Backfill"

    def __init__(self, head_timeout: float = 1800.0,
                 preempt: Optional[PreemptPlugin] = None) -> None:
        self.head_timeout = head_timeout
        self.preempt = preempt or BackfillHeadTimeout()

    def run_cycle(self, queue: List[Job], ctx: CycleContext) -> None:
        sched = ctx.sched
        head = queue[0]
        if sched.try_place(head, ctx):
            sched.head_blocked_since.pop(head.uid, None)
        else:
            blocked_since = sched.head_blocked_since.setdefault(
                head.uid, ctx.now)
            if ctx.now - blocked_since >= self.head_timeout:
                # Stamp the eviction source so preempt_job's audit
                # record names this plugin and its beneficiary.
                sched._preempt_source = (self.preempt.name, head.uid)
                try:
                    self.preempt.execute(head, ctx)
                finally:
                    sched._preempt_source = None
                if sched.try_place(head, ctx):
                    sched.head_blocked_since.pop(head.uid, None)
                else:
                    ctx.result.blocked_head = head
            else:
                ctx.result.blocked_head = head
        # Backfill pass: later jobs may use idle resources now.
        for job in queue[1:]:
            if job.state is not JobState.PENDING:
                continue
            sched.try_place(job, ctx,
                            backfilled=ctx.result.blocked_head is not None)


# ----------------------------------------------------------------------
# Pass/plan/profile builders
# ----------------------------------------------------------------------
def binpack_pass(zone: Optional[str] = None) -> PlacementPass:
    """Plain node-level Binpack (§3.3.3)."""
    return PlacementPass(scorers=(BinpackScore(),), zone=zone)


def spread_pass(zone: Optional[str] = None) -> PlacementPass:
    """Plain Spread (§3.3.4)."""
    return PlacementPass(scorers=(SpreadScore(),), spread=True, zone=zone)


def ebinpack_pass(colocate: float = 0.0, zone: Optional[str] = None,
                  extra_scorers: Sequence[ScorePlugin] = ()
                  ) -> PlacementPass:
    """E-Binpack (§3.3.3): node binpack + group consolidation + anchor
    preference, optionally with the same-node co-location bonus."""
    scorers: Tuple[ScorePlugin, ...] = (
        BinpackScore(), GroupConsolidation(0.75), TopoAnchor(1.5))
    if colocate:
        scorers += (ColocateBonus(colocate),)
    return PlacementPass(scorers=scorers + tuple(extra_scorers),
                         enhanced=True, zone=zone)


def espread_zone_pass(extra_scorers: Sequence[ScorePlugin] = ()
                      ) -> PlacementPass:
    """E-Spread inside the inference dedicated zone (§3.3.4)."""
    scorers: Tuple[ScorePlugin, ...] = (SpreadScore(),
                                        GroupConsolidation(-0.25))
    return PlacementPass(scorers=scorers + tuple(extra_scorers),
                         spread=True, enhanced=True, zone="zone")


def espread_plan(small_pod_gpus: int = 8, colocate: float = 0.0,
                 extra_scorers: Sequence[ScorePlugin] = ()) -> PlanFn:
    """The §3.3.4 E-Spread dance as an ordered pass plan:

    * small inference pods go to the dedicated zone, remaining replicas
      E-Binpack in the general pool;
    * everything else E-Binpacks in the general pool first (keeping the
      zone for small replicas), falling back to the whole pool;
    * with no zone configured, E-Binpack over the whole pool.
    """
    zone_p = espread_zone_pass(extra_scorers)
    general_zone = ebinpack_pass(colocate, zone="general",
                                 extra_scorers=extra_scorers)
    general = ebinpack_pass(colocate, zone=None,
                            extra_scorers=extra_scorers)

    def plan(job: Job, snap: Snapshot) -> Sequence[PlacementPass]:
        has_zone = bool(snap.inference_zone.any())
        if (job.kind is JobKind.INFER
                and job.gpus_per_pod < small_pod_gpus and has_zone):
            return (zone_p, general_zone)
        if has_zone:
            return (general_zone, general)
        return (general,)

    return plan


def make_profile(name: str, plan: PlanFn, *,
                 queue_sort: Optional[QueueSortPlugin] = None,
                 admit: Optional[Sequence[AdmitPlugin]] = None,
                 filters: Optional[Sequence[FilterPlugin]] = None,
                 reserve: Optional[Sequence[ReservePlugin]] = None,
                 permit: Sequence[PermitPlugin] = (),
                 post_bind: Sequence[PostBindPlugin] = (),
                 preempt: Optional[Sequence[PreemptPlugin]] = None
                 ) -> SchedulingProfile:
    """A profile with the paper's default chains wherever not given."""
    return SchedulingProfile(
        name=name,
        plan=plan,
        queue_sort=queue_sort or DefaultQueueSort(),
        admit=tuple(admit) if admit is not None
        else (QuotaAdmit(), DynamicFeasibility()),
        filters=tuple(filters) if filters is not None else DEFAULT_FILTERS,
        reserve=tuple(reserve) if reserve is not None else (QuotaReserve(),),
        permit=tuple(permit),
        post_bind=tuple(post_bind),
        preempt=tuple(preempt) if preempt is not None
        else (PriorityPreempt(), QuotaReclaimPreempt()),
    )


def default_profiles(colocate: float = 2.0, small_pod_gpus: int = 8
                     ) -> ProfileSet:
    """Kant's defaults: E-Binpack training, E-Spread inference, and a
    best-effort (debug) profile that places like training."""
    return ProfileSet(
        train=make_profile(
            "train-e-binpack", single_pass_plan(ebinpack_pass(colocate))),
        inference=make_profile(
            "inference-e-spread", espread_plan(small_pod_gpus)),
        best_effort=make_profile(
            "best-effort-e-binpack",
            single_pass_plan(ebinpack_pass(colocate))),
    )
