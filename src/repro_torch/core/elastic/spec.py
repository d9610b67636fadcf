"""ElasticSpec: the alternative-parallelism contract of a training job.

Kant gang-schedules distributed training all-or-nothing (§3.2.1), so a
128-GPU job waits idle while 64 GPUs of fragmented capacity sit free.
The elastic subsystem closes that gap Arena-style: a job declares a
small menu of :class:`ParallelismPlan`s — concrete DP×TP shapes at
different GPU counts, each with a throughput estimate (derived from the
dry-run roofline analysis via :mod:`repro_torch.core.elastic.estimate`, or
supplied directly) — and the scheduler may run the job at any plan in
the menu, shrinking into fragmented capacity now and growing back at a
checkpoint boundary later.

Unit convention: ``throughput`` is *any* consistent rate (steps/s,
tokens/s, 1/step-time) — only ratios between plans of one spec are ever
used.  The **ideal** plan is the highest-throughput one; a job's
``duration``/``original_duration`` are expressed in ideal-plan seconds
("work"), and an attempt at plan *p* burns wall time at relative rate
``p.throughput / ideal.throughput`` (see ``Job.work_rate``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from ..job import JobKind

__all__ = ["ParallelismPlan", "ElasticSpec"]


@dataclasses.dataclass(frozen=True)
class ParallelismPlan:
    """One concrete shape a job can run at: ``n_pods`` pods of
    ``gpus_per_pod`` GPUs, delivering ``throughput`` (relative units,
    see module docstring).  ``name`` is informational (e.g.
    ``"dp16xtp8"``)."""

    n_pods: int
    gpus_per_pod: int
    throughput: float
    name: str = ""

    def __post_init__(self) -> None:
        if self.n_pods <= 0 or self.gpus_per_pod <= 0:
            raise ValueError("plans must request at least one pod and GPU")
        if self.throughput <= 0:
            raise ValueError("plan throughput must be positive")

    @property
    def n_gpus(self) -> int:
        return self.n_pods * self.gpus_per_pod

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_pods, self.gpus_per_pod)

    def label(self) -> str:
        return self.name or f"{self.n_pods}x{self.gpus_per_pod}"


@dataclasses.dataclass(frozen=True)
class ElasticSpec:
    """The menu of plans a job may run at.  Immutable and shareable
    across job clones (benchmark A/Bs clone the same spec object)."""

    plans: Tuple[ParallelismPlan, ...]

    def __post_init__(self) -> None:
        plans = tuple(self.plans)
        object.__setattr__(self, "plans", plans)
        if not plans:
            raise ValueError("ElasticSpec needs at least one plan")
        shapes = [p.shape for p in plans]
        if len(set(shapes)) != len(shapes):
            raise ValueError("duplicate (n_pods, gpus_per_pod) plan shapes")

    # ------------------------------------------------------------------
    def ideal(self) -> ParallelismPlan:
        """The highest-throughput plan — the shape a rigid scheduler
        would queue for, and the yardstick work is measured against.
        Ties break toward more GPUs, then fewer pods (determinism)."""
        return max(self.plans,
                   key=lambda p: (p.throughput, p.n_gpus, -p.n_pods))

    def by_throughput(self) -> Tuple[ParallelismPlan, ...]:
        """Plans best-first (same tie-breaking as :meth:`ideal`)."""
        return tuple(sorted(
            self.plans,
            key=lambda p: (-p.throughput, -p.n_gpus, p.n_pods)))

    def plan_for(self, n_pods: int, gpus_per_pod: int
                 ) -> Optional[ParallelismPlan]:
        for p in self.plans:
            if p.shape == (n_pods, gpus_per_pod):
                return p
        return None

    def min_gpus(self) -> int:
        return min(p.n_gpus for p in self.plans)

    # ------------------------------------------------------------------
    def validate_for(self, job) -> None:
        """A spec is only meaningful on a gang-scheduled training job
        whose declared shape IS the ideal plan — ``original_duration``
        is interpreted as ideal-plan seconds, so a mismatch would make
        every plan's wall-time accounting wrong."""
        if job.kind is not JobKind.TRAIN or not job.gang:
            raise ValueError(
                "ElasticSpec applies to gang-scheduled training jobs only")
        ideal = self.ideal()
        if (job.n_pods, job.gpus_per_pod) != ideal.shape:
            raise ValueError(
                f"job shape {job.n_pods}x{job.gpus_per_pod} must equal the "
                f"ideal plan {ideal.n_pods}x{ideal.gpus_per_pod}")

    # ------------------------------------------------------------------
    @classmethod
    def from_throughputs(cls, entries: Sequence[Tuple[int, float]], *,
                         gpus_per_node: int = 8) -> "ElasticSpec":
        """Build a spec from ``(n_gpus, throughput)`` pairs, packing
        pods at node granularity (``gpus_per_node`` per pod, like the
        workload generators' ``_pods_for``)."""
        plans = []
        for n_gpus, thr in entries:
            if n_gpus <= gpus_per_node:
                n_pods, per_pod = 1, int(n_gpus)
            else:
                if n_gpus % gpus_per_node:
                    raise ValueError(
                        f"multi-node plan size {n_gpus} must be a multiple "
                        f"of gpus_per_node={gpus_per_node}")
                n_pods, per_pod = n_gpus // gpus_per_node, gpus_per_node
            plans.append(ParallelismPlan(n_pods=n_pods, gpus_per_pod=per_pod,
                                         throughput=float(thr)))
        return cls(plans=tuple(plans))
