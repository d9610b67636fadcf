"""QSCH — the Queue-based Scheduler (paper §3.2), as a thin cycle
orchestrator over the framework's plugin chains.

QSCH owns everything that happens to a job *before* RSCH places it, but
every policy decision is a plugin (see :mod:`repro_torch.core.framework`):

* per-tenant queues ordered by the **QueueSort** plugin (§3.2.2);
* two-tier admission via **Admit** plugins: static quota admission then
  dynamic resource admission (§3.2.1);
* the cycle body is a **QueuePolicy** plugin (Table 1): Strict FIFO,
  Best-Effort FIFO, Backfill (with head-timeout preemption via the
  BackfillHeadTimeout Preempt plugin);
* preemption control (§3.2.3) runs the profile's **Preempt** chain
  (priority, quota-reclamation) through one conservative engine: a
  preemption fires only when the dry-run accounting shows it actually
  unblocks the beneficiary;
* the gang commit is transactional via **Reserve/Permit** plugins
  (quota charge with rollback), followed by the **PostBind** chain;
* requeueing (§3.2.4): placement failures and preemptions return the
  job to its tenant queue instead of deadlocking the pipeline.

Snapshot discipline (§3.4.3): one ``snapshotter.take`` per cycle.  Every
mid-cycle mutation (placement commit, preemption release) is mirrored
onto the working snapshot via :meth:`Snapshot.apply_placement` /
:meth:`Snapshot.apply_release` deltas instead of re-copying the cluster,
which is what made large-gang cycles O(placements × nodes).

``QSCHConfig(policy=...)`` remains as a deprecation shim mapping the
legacy :class:`QueuePolicy` enum onto the built-in QueuePolicy plugins;
pass ``queue_policy=`` for direct plugin control.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

from .cluster import ClusterState
from .framework.api import CycleContext, CycleResult, obs_phase, obs_span
from .framework.builtin import (BackfillHeadTimeout, BackfillPolicy,
                                BestEffortFIFOPolicy, StrictFIFOPolicy)
from .job import Job, JobState
from .quota import QuotaManager
from .rsch import RSCH
from .snapshot import FullSnapshotter, IncrementalSnapshotter

__all__ = ["QSCH", "QSCHConfig", "QueuePolicy", "CycleResult"]


class QueuePolicy(enum.Enum):
    """Legacy queue-policy names (shim over the QueuePolicy plugins)."""

    STRICT_FIFO = "strict-fifo"
    BEST_EFFORT_FIFO = "best-effort-fifo"
    BACKFILL = "backfill"


@dataclasses.dataclass
class QSCHConfig:
    policy: QueuePolicy = QueuePolicy.BACKFILL
    # Backfill: head job older than this (seconds of queue wait while
    # blocked) may preempt backfilled jobs (Table 1).
    backfill_head_timeout: float = 1800.0
    # Priority/quota-reclamation preemption (§3.2.3): enabled but
    # conservative.  Gates the profile's Preempt chain.
    priority_preemption: bool = True
    # Upper bound on preemptions per cycle — keeps cascades in check
    # ("conservative preemption policy", §3.2.3).
    max_preemptions_per_cycle: int = 64


def _policy_from_config(config: QSCHConfig):
    if config.policy is QueuePolicy.STRICT_FIFO:
        return StrictFIFOPolicy()
    if config.policy is QueuePolicy.BEST_EFFORT_FIFO:
        return BestEffortFIFOPolicy()
    return BackfillPolicy(head_timeout=config.backfill_head_timeout,
                          preempt=BackfillHeadTimeout())


class QSCH:
    def __init__(self, quota: QuotaManager, rsch: RSCH,
                 config: Optional[QSCHConfig] = None,
                 incremental_snapshots: bool = True,
                 queue_policy=None, elastic=None) -> None:
        self.quota = quota
        self.rsch = rsch
        self.config = config or QSCHConfig()
        self.queue_policy = queue_policy or _policy_from_config(self.config)
        # Elastic-training manager (repro_torch.core.elastic), or None for the
        # classic rigid-gang scheduler.  Jobs without an ElasticSpec are
        # never touched either way (byte-identity gate in
        # benchmarks/elastic_bench.py).
        self.elastic = elastic
        self.snapshotter = (IncrementalSnapshotter()
                            if incremental_snapshots else FullSnapshotter())
        # Optional cycle pipeline (repro_torch.core.pipeline): speculative
        # snapshot+score of the next cycle's head job.  None = classic
        # strictly-sequential cycles (byte-identical default).
        self.pipeline = None
        # Tenant queues (§3.2.2): submission order is kept per tenant; the
        # global pass merges by the QueueSort plugin's key.
        self.queues: Dict[str, List[Job]] = {}
        self.running: Dict[int, Job] = {}
        # Head-of-line blocking bookkeeping for Backfill.
        self.head_blocked_since: Dict[int, float] = {}
        # The cycle's working snapshot, held only while ``cycle`` runs —
        # the target of mid-cycle health syncs (see ``sync_health``).
        self._working_snap = None
        # Optional telemetry facade (repro_torch.obs): cycle spans, placement
        # decisions, preemption rationale.  None = zero-cost detached.
        self.obs = None
        # (plugin name, beneficiary uid) while a Preempt plugin's
        # evictions run — preempt_job stamps it into the audit record.
        self._preempt_source: Optional[tuple] = None

    # ------------------------------------------------------------------
    # Profiles
    # ------------------------------------------------------------------
    def profile_for(self, job: Job):
        return self.rsch.profiles.for_job(job)

    def enable_pipeline(self):
        """Turn on optimistic cycle pipelining (§3.4 latency hiding —
        see :mod:`repro_torch.core.pipeline`).  Requires the incremental
        snapshotter: speculation refreshes the retained buffer in place,
        which a full snapshotter does not keep."""
        from .pipeline import CyclePipeline
        if not isinstance(self.snapshotter, IncrementalSnapshotter):
            raise ValueError(
                "pipelined cycles require incremental snapshots")
        self.pipeline = CyclePipeline(self)
        return self.pipeline

    # ------------------------------------------------------------------
    # Queue management
    # ------------------------------------------------------------------
    def submit(self, job: Job) -> None:
        job.state = JobState.PENDING
        self.queues.setdefault(job.tenant, []).append(job)

    def requeue(self, job: Job) -> None:
        """§3.2.4: failed/preempted workloads restart the pipeline."""
        job.requeue_count += 1
        job.state = JobState.PENDING
        job.placement = None
        job.backfilled = False
        self.queues.setdefault(job.tenant, []).append(job)

    def pending_jobs(self) -> List[Job]:
        out: List[Job] = []
        for q in self.queues.values():
            out.extend(j for j in q if j.state is JobState.PENDING)
        out.sort(key=self.rsch.profiles.queue_sort.key)
        return out

    def queue_depth(self) -> int:
        """Pending-job count.  Plain sum over the tenant queues — this
        runs every simulator tick via metrics sampling, so it must not
        pay the full ``pending_jobs()`` merge-and-sort."""
        return sum(1 for q in self.queues.values()
                   for j in q if j.state is JobState.PENDING)

    def _remove_from_queue(self, job: Job) -> None:
        q = self.queues.get(job.tenant, [])
        if job in q:
            q.remove(job)

    # ------------------------------------------------------------------
    # Admission (§3.2.1): the profile's Admit chains
    # ------------------------------------------------------------------
    def static_admit(self, job: Job, ctx: CycleContext) -> bool:
        return all(p.admit(job, ctx)
                   for p in self.profile_for(job).admit_chain("static"))

    def dynamic_admit(self, job: Job, ctx: CycleContext) -> bool:
        return all(p.admit(job, ctx)
                   for p in self.profile_for(job).admit_chain("dynamic"))

    # ------------------------------------------------------------------
    # One scheduling cycle
    # ------------------------------------------------------------------
    def cycle(self, state: ClusterState, now: float) -> CycleResult:
        obs = self.obs
        if obs is not None:
            obs.cycle_begin(now)
        result = CycleResult()
        if self.pipeline is not None:
            self.pipeline.begin_cycle(state)
        with obs_phase(obs, "snapshot"):
            snap = self.snapshotter.take(state)
        self._working_snap = snap
        result.snapshot_version = snap.version
        ctx = CycleContext(running=self.running, quota=self.quota,
                           sched=self, rsch=self.rsch, state=state,
                           snap=snap, now=now, result=result)
        try:
            with obs_phase(obs, "queue-sort"):
                candidates = self.pending_jobs()
                # Jobs failing static quota stay in the tenant queue and
                # never enter the global pass (§3.2.2).
                global_queue = []
                for job in candidates:
                    if self.static_admit(job, ctx):
                        global_queue.append(job)
                    else:
                        result.admit_rejected += 1
            if global_queue:
                self.queue_policy.run_cycle(global_queue, ctx)

                # Preempt chain (§3.2.3): if the highest-priority pending
                # job is still blocked, conservatively evict work that
                # provably unblocks it (priority, then quota reclamation).
                if (self.config.priority_preemption and result.blocked_head
                        is not None):
                    with obs_phase(obs, "preempt"):
                        self._run_preempt_chain(result.blocked_head, ctx)
            # Elastic grow pass: running shrunk gangs may reshape toward
            # their ideal plan at a checkpoint boundary — runs even with
            # an empty queue (freed capacity is what triggers growth).
            if self.elastic is not None:
                with obs_phase(obs, "elastic"):
                    self.elastic.grow_pass(ctx)
            return result
        finally:
            if self.pipeline is not None:
                self.pipeline.end_cycle(state, now)
            self._working_snap = None
            if obs is not None:
                obs.cycle_end(result, ctx)

    def sync_health(self, state: ClusterState, nodes) -> None:
        """Mirror an external health/drain mutation onto the scheduler's
        snapshot view.  Two staleness windows exist:

        * *mid-cycle*: the working snapshot took its copy before the
          mutation — refresh its rows and drop the delta-invariant
          caches (pool masks, healthy-capacity counts), or this cycle's
          later binds can land on a dead/draining node;
        * *between cycles* with incremental snapshots: the retained
          buffer is refreshed from ``state.dirty_nodes`` at the next
          ``take`` — nothing to do here.
        """
        if self._working_snap is not None:
            self._working_snap.apply_health(state, nodes)

    # ------------------------------------------------------------------
    # Placement attempt: admission -> RSCH -> Reserve/Permit -> bind
    # ------------------------------------------------------------------
    def try_place(self, job: Job, ctx: CycleContext,
                  backfilled: bool = False) -> bool:
        result = ctx.result
        obs = self.obs
        # Elastic plan selection runs FIRST: admission, quota and
        # placement below all see the shape this attempt actually binds.
        if self.elastic is not None and job.elastic is not None:
            self.elastic.select_shape(job, ctx)
        # Re-check static quota: earlier placements in this cycle may have
        # consumed it since the global-queue filter ran (§3.2.1).
        with obs_span(obs, "admit"):
            static_ok = self.static_admit(job, ctx)
            dynamic_ok = static_ok and self.dynamic_admit(job, ctx)
        if not static_ok:
            result.admit_rejected += 1
            if obs is not None:
                obs.emit_reject(job, None, ctx, "static-admit")
            return False
        if not dynamic_ok:
            result.infeasible += 1
            if obs is not None:
                obs.emit_reject(job, None, ctx, "dynamic-admit")
            return False
        job.state = JobState.ADMITTED
        job.admit_time = ctx.now
        sched = self.rsch.schedule(job, ctx.snap, ctx)
        if sched.placement is None:
            # Dynamic admission passed but placement failed (fragmentation
            # or topology): requeue mechanism (§3.2.4).
            self._remove_from_queue(job)
            self.requeue(job)
            result.requeues += 1
            if obs is not None:
                obs.emit_reject(job, sched, ctx,
                                sched.reason or "no-placement")
            return False
        profile = self.profile_for(job)
        # Reserve/Permit (§3.3.2 transactional gang commit): every
        # successful Reserve is rolled back if a later plugin fails.
        with obs_phase(obs, "reserve-permit"):
            reserved = []
            ok = True
            for plugin in profile.reserve:
                if plugin.reserve(job, sched.placement, ctx):
                    reserved.append(plugin)
                else:
                    ok = False
                    break
            if ok:
                for plugin in profile.permit:
                    if not plugin.permit(job, sched.placement, ctx):
                        ok = False
                        break
            if not ok:
                for plugin in reversed(reserved):
                    plugin.unreserve(job, sched.placement, ctx)
                self._remove_from_queue(job)
                self.requeue(job)
                result.requeues += 1
        if not ok:
            if obs is not None:
                obs.emit_reject(job, sched, ctx, "reserve-permit")
            return False
        with obs_phase(obs, "bind"):
            ctx.state.allocate(job, sched.placement)
            # Mirror the commit onto the working snapshot (§3.4.3): later
            # placements this cycle see it without re-taking the cluster.
            ctx.snap.apply_placement(sched.placement)
            job.placement = sched.placement
            job.state = JobState.RUNNING
            job.start_time = ctx.now
            job.backfilled = backfilled
            self._remove_from_queue(job)
            self.running[job.uid] = job
            result.scheduled.append(job)
            for plugin in profile.post_bind:
                plugin.post_bind(job, sched.placement, ctx)
        if obs is not None:
            obs.emit_bind(job, sched, ctx)
        return True

    # -- lifecycle callbacks from the simulator --------------------------
    def on_complete(self, job: Job, state: ClusterState, now: float) -> None:
        if job.uid in self.running:
            state.release(job.uid)
            self.quota.refund(job)
            del self.running[job.uid]
        job.state = JobState.COMPLETED
        job.end_time = now

    def on_interrupted(self, job: Job, state: ClusterState, now: float,
                       remaining: float) -> None:
        """Requeue-on-failure (§3.2.4 applied to the dynamics
        subsystem): a job killed by a node/GPU failure or drain eviction
        releases its devices, refunds quota, and re-enters its tenant
        queue with ``remaining`` seconds of work (computed by the
        recovery model from its checkpoint state)."""
        if job.uid in self.running:
            state.release(job.uid)
            self.quota.refund(job)
            del self.running[job.uid]
        job.state = JobState.INTERRUPTED
        job.interrupt_count += 1
        job.attempt += 1
        job.duration = max(0.0, float(remaining))
        job.end_time = None
        self.requeue(job)

    def preempt_job(self, job: Job, ctx: CycleContext) -> None:
        """Evict one running job and requeue it (used by the preemption
        engine and the Preempt plugins)."""
        released = ctx.state.release(job.uid)
        ctx.snap.apply_release(released)
        self.quota.refund(job)
        del self.running[job.uid]
        job.state = JobState.PREEMPTED
        job.preempt_count += 1
        job.end_time = None
        ctx.result.preempted.append(job)
        self.requeue(job)
        ctx.result.requeues += 1
        if self.obs is not None:
            self.obs.emit_preempt(job, ctx, self._preempt_source)

    # -- conservative preemption engine (§3.2.3) --------------------------
    def structurally_placeable(self, job: Job, ctx: CycleContext) -> bool:
        """Could the job fit even on an EMPTY pool?  Guards the
        preemption engine: the free+reclaimable dry-run is blind to
        per-node granularity, so a pod larger than any node's healthy
        capacity (or a gang wider than the pool's total slots) would
        trigger a futile eviction storm every cycle — victims die, the
        beneficiary stays blocked, repeat."""
        pool = ctx.snap.candidate_pool(int(job.gpu_type))
        slots = ctx.snap.healthy_per_node() // job.gpus_per_pod
        return int(slots[pool].sum()) >= job.n_pods

    def _run_preempt_chain(self, job: Job, ctx: CycleContext) -> None:
        """First Preempt plugin with victims wins; evictions only happen
        when the dry-run shows they can make ``job`` feasible.  A plugin
        without victims gets its ``execute`` hook instead (execute-only
        plugins own their whole flow, including placement)."""
        if not self.structurally_placeable(job, ctx):
            return
        victims: List[Job] = []
        for plugin in self.profile_for(job).preempt:
            victims = plugin.victims(job, ctx)
            if victims:
                break
            self._preempt_source = (plugin.name, job.uid)
            try:
                plugin.execute(job, ctx)
            finally:
                self._preempt_source = None
            if job.state is JobState.RUNNING:
                return
        if not victims:
            return
        pool_free = ctx.state.pool_free(job.gpu_type)
        reclaimable = sum(v.n_gpus for v in victims)
        if pool_free + reclaimable < job.n_gpus:
            return
        victims.sort(key=lambda j: (j.priority, -(j.start_time or 0.0)))
        budget = self.config.max_preemptions_per_cycle
        self._preempt_source = (plugin.name, job.uid)
        try:
            for victim in victims:
                if budget <= 0:
                    break
                if self.dynamic_admit(job, ctx):
                    break
                self.preempt_job(victim, ctx)
                budget -= 1
        finally:
            self._preempt_source = None
        if self.dynamic_admit(job, ctx):
            self.try_place(job, ctx)
