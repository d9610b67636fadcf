"""Built-in ElasticPolicy: greedy shrink, payback-gated grow.

``GreedyElastic`` implements the two decisions of the
:class:`~repro_torch.core.framework.api.ElasticPolicyPlugin` contract:

* **shrink** (``select_plan``): at every placement attempt, take the
  highest-throughput plan that *fits the working snapshot right now*.
  If the ideal plan fits, the job runs rigid; if only a smaller plan
  fits, the gang starts immediately in the fragmented capacity instead
  of queueing.  Plans below ``min_rate`` of the ideal throughput are
  never selected — running a 128-GPU job at 1/16th speed mostly wastes
  the checkpoint overhead of getting it there.
* **grow** (``want_grow``): for a running shrunk job at a checkpoint
  boundary, find the best plan that would fit the free capacity *plus
  the job's own devices*, and reshape only if the wall-time saved on
  the remaining work exceeds ``grow_payback`` times the reshape cost
  (restart overhead; work since the last checkpoint is bounded by the
  boundary slack).  Conservative by design: a reshape that cannot pay
  for itself is a pure goodput loss.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..framework.api import CycleContext, ElasticPolicyPlugin
from ..framework.registry import register
from ..job import Job
from ..snapshot import Snapshot
from .spec import ParallelismPlan

__all__ = ["GreedyElastic"]


@register
class GreedyElastic(ElasticPolicyPlugin):
    """Largest-fitting-plan shrink + payback-gated grow (see module
    docstring)."""

    name = "GreedyElastic"

    def __init__(self, min_rate: float = 0.25,
                 grow_payback: float = 2.0) -> None:
        if not 0.0 <= min_rate <= 1.0:
            raise ValueError("min_rate must be in [0, 1]")
        if grow_payback < 0.0:
            raise ValueError("grow_payback must be non-negative")
        self.min_rate = float(min_rate)
        self.grow_payback = float(grow_payback)

    # ------------------------------------------------------------------
    def _fits(self, job: Job, plan: ParallelismPlan, snap: Snapshot,
              ctx: Optional[CycleContext]) -> bool:
        rsch = ctx.rsch if ctx is not None else None
        if rsch is not None:
            # Honors the job profile's full Filter chain, same as
            # dynamic admission.
            return rsch.feasible_shape(job, snap, plan.n_pods,
                                       plan.gpus_per_pod)
        pool = snap.candidate_pool(int(job.gpu_type))
        slots = np.where(pool & (snap.free_gpus >= plan.gpus_per_pod),
                         snap.free_gpus // plan.gpus_per_pod, 0)
        return int(slots.sum()) >= plan.n_pods

    def select_plan(self, job: Job, snap: Snapshot,
                    ctx: Optional[CycleContext]
                    ) -> Optional[ParallelismPlan]:
        spec = job.elastic
        ideal = spec.ideal()
        floor = self.min_rate * ideal.throughput
        for plan in spec.by_throughput():     # best first
            if plan is not ideal and plan.throughput < floor:
                break                          # everything after is slower
            if self._fits(job, plan, snap, ctx):
                return plan
        return ideal                           # nothing fits: behave rigid

    # ------------------------------------------------------------------
    def want_grow(self, job: Job, snap: Snapshot,
                  ctx: Optional[CycleContext], reshape_cost_s: float
                  ) -> Optional[ParallelismPlan]:
        spec, cur = job.elastic, job.active_plan
        if spec is None or cur is None:
            return None
        ideal = spec.ideal()
        # Capacity view for the hypothetical reshape: free GPUs plus the
        # job's own devices, which the reshape returns to the pool.
        free = snap.free_gpus.astype(np.int64).copy()
        if job.placement is not None:
            for pod in job.placement.pods:
                free[pod.node] += len(pod.gpu_indices)
        pool = snap.candidate_pool(int(job.gpu_type))
        target = None
        for plan in spec.by_throughput():
            if plan.throughput <= cur.throughput:
                break                          # no improvement below here
            slots = np.where(pool & (free >= plan.gpus_per_pod),
                             free // plan.gpus_per_pod, 0)
            if int(slots.sum()) >= plan.n_pods:
                target = plan
                break
        if target is None:
            return None
        # Payback: wall time saved on the remaining work must beat the
        # reshape cost with margin.  Remaining work is estimated
        # conservatively — checkpoint state plus everything this
        # attempt has run (even the yet-uncheckpointed slice, which the
        # boundary slack bounds).
        remaining = job.original_duration - job.checkpointed_progress
        r_cur = cur.throughput / ideal.throughput
        if ctx is not None and job.run_time is not None:
            remaining -= max(0.0, ctx.now - job.run_time) * r_cur
        if remaining <= 0.0:
            return None
        r_new = target.throughput / ideal.throughput
        saved = remaining / r_cur - remaining / r_new
        if saved <= self.grow_payback * max(reshape_cost_s, 0.0):
            return None
        return target
