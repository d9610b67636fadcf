"""ElasticManager: executes ElasticPolicy decisions through QSCH.

The manager is the subsystem's only actor — the policy plugin advises,
the manager drives the standard scheduler paths so quota charges,
snapshot deltas, stale-END guards and metrics accounting stay where
they already live:

* **shrink / plan selection** — ``QSCH.try_place`` calls
  :meth:`ElasticManager.select_shape` before admission: the policy
  picks a plan against the working snapshot, the job's shape is
  rewritten to it, and the attempt's wall ``duration`` is recomputed
  from the checkpoint state at the plan's relative throughput.  Quota
  is then charged for the shape that actually binds.
* **grow** — once per cycle (after the queue policy and preempt chain)
  :meth:`grow_pass` scans running shrunk jobs.  At a checkpoint
  boundary, if the policy names a better-fitting plan, the job is
  **voluntarily checkpoint-interrupted**: the PR-3 recovery model
  (:class:`~repro_torch.core.dynamics.recovery.CheckpointModel`) charges the
  reshape as restart overhead + (boundary-slack-bounded) lost work,
  ``QSCH.on_interrupted`` requeues it, and the next placement attempt
  re-selects — now with the freed devices visible in the snapshot.

With no elastic jobs in the trace (or no manager attached) every hook
is a no-op and the scheduler is byte-identical to the rigid path
(gated by ``benchmarks/elastic_bench.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..dynamics.recovery import CheckpointModel
from ..framework.api import CycleContext, ElasticPolicyPlugin
from ..job import Job, JobKind, JobState
from .policy import GreedyElastic

__all__ = ["ElasticConfig", "ElasticManager"]


@dataclasses.dataclass
class ElasticConfig:
    """Knobs of the shrink/grow machinery.

    ``recovery`` is the checkpoint model reshapes are costed with; when
    left ``None`` the manager adopts the dynamics engine's model at
    attach time (one source of truth for interval/overhead), falling
    back to the default :class:`CheckpointModel` on static runs.
    """

    policy: ElasticPolicyPlugin = dataclasses.field(
        default_factory=GreedyElastic)
    recovery: Optional[CheckpointModel] = None
    # A grow may fire within this many wall seconds after a checkpoint
    # boundary — the lost-work bound of a voluntary reshape.
    grow_boundary_slack_s: float = 90.0
    # Reshape budget per cycle: growing is never urgent, and unbounded
    # simultaneous reshapes would stampede the freed capacity.
    max_grows_per_cycle: int = 4


class ElasticManager:
    def __init__(self, config: Optional[ElasticConfig] = None) -> None:
        self.config = config or ElasticConfig()
        self.metrics = None          # bound by the Simulator
        self.reshapes = 0            # grow reshapes executed

    # ------------------------------------------------------------------
    # Wiring (Simulator)
    # ------------------------------------------------------------------
    def bind_metrics(self, metrics) -> None:
        self.metrics = metrics

    def stats(self) -> Dict[str, int]:
        """Counters for the telemetry registry's pull collector."""
        return {"reshapes": self.reshapes}

    def adopt_recovery(self, model: CheckpointModel) -> None:
        """Share the dynamics engine's checkpoint model unless the
        config pinned its own."""
        if self.config.recovery is None:
            self.config.recovery = model

    @property
    def recovery(self) -> CheckpointModel:
        if self.config.recovery is None:
            self.config.recovery = CheckpointModel()
        return self.config.recovery

    # ------------------------------------------------------------------
    # Placement-time plan selection (QSCH.try_place)
    # ------------------------------------------------------------------
    def select_shape(self, job: Job, ctx: CycleContext) -> None:
        """Adopt the policy's plan for this placement attempt and
        recompute the attempt's wall duration from the job's checkpoint
        state at the plan's relative throughput."""
        if job.elastic is None or job.state is JobState.RUNNING:
            return
        plan = self.config.policy.select_plan(job, ctx.snap, ctx)
        if plan is None:
            plan = job.elastic.ideal()
        if (job.n_pods, job.gpus_per_pod) != plan.shape \
                or job.active_plan is not plan:
            job.apply_plan(plan)
        rate = job.work_rate
        remaining_work = max(
            0.0, job.original_duration - job.checkpointed_progress)
        wall = remaining_work / rate if rate > 0 else remaining_work
        job.duration = self.recovery.attempt_overhead(job) + wall

    # ------------------------------------------------------------------
    # Grow pass (end of QSCH.cycle)
    # ------------------------------------------------------------------
    def at_checkpoint_boundary(self, job: Job, now: float) -> bool:
        """Within ``grow_boundary_slack_s`` wall seconds past a
        checkpoint boundary of the current attempt (attempt start
        counts: nothing to lose yet)."""
        model = self.recovery
        if job.run_time is None or now < job.run_time:
            return True                       # still binding: no progress
        progress = max(0.0, (now - job.run_time)
                       - model.attempt_overhead(job))
        return (progress % model.interval_s) \
            <= self.config.grow_boundary_slack_s

    def grow_pass(self, ctx: CycleContext) -> int:
        """Reshape up to ``max_grows_per_cycle`` running shrunk jobs
        whose policy names a better plan.  Returns the reshape count."""
        if self.recovery.mode != "checkpoint":
            # Scratch recovery would redo the whole job on a voluntary
            # reshape — never worth it.
            return 0
        sched = ctx.sched
        candidates: List[Job] = [
            j for j in sched.running.values()
            if j.elastic is not None and j.active_plan is not None
            and j.kind is JobKind.TRAIN
            and j.active_plan.throughput < j.elastic.ideal().throughput]
        candidates.sort(key=lambda j: j.uid)   # determinism
        grown = 0
        for job in candidates:
            if grown >= self.config.max_grows_per_cycle:
                break
            if not self.at_checkpoint_boundary(job, ctx.now):
                continue
            target = self.config.policy.want_grow(
                job, ctx.snap, ctx, self.recovery.restart_overhead_s)
            if target is None \
                    or target.throughput <= job.active_plan.throughput:
                continue
            self.reshape(job, ctx, target)
            grown += 1
        return grown

    def reshape(self, job: Job, ctx: CycleContext, target) -> None:
        """Voluntary checkpoint-interrupt so the next placement attempt
        can run ``job`` at ``target``.  Cost accounting is exactly the
        failure path's — restart overhead plus work since the last
        checkpoint — but flagged as a reshape in metrics (no MTTR
        sample, tracked against the reshape-overhead budget)."""
        remaining, lost, overhead = self.recovery.on_interrupt(
            job, ctx.now)
        if self.metrics is not None:
            self.metrics.on_job_interrupted(job, ctx.now, lost, overhead,
                                            reshape=True)
        placement = job.placement
        ctx.sched.on_interrupted(job, ctx.state, ctx.now, remaining)
        if placement is not None:
            # Mirror the release onto the working snapshot, like
            # preempt_job: later decisions this cycle see the freed
            # devices.
            ctx.snap.apply_release(placement)
        job.reshape_count += 1
        self.reshapes += 1
        # Adopt the target shape now so quota admission sees it; the
        # next placement attempt's select_shape may still re-pick if
        # the capacity moved underneath us.
        job.apply_plan(target)
