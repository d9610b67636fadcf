"""Tidal train/inference autoscaling (the co-scheduling story).

Inference demand is diurnal (:func:`repro_torch.core.workload.diurnal_demand`):
it crests mid-afternoon and bottoms out overnight.  The
:class:`TidalAutoscaler` tracks each service's demand curve at a fixed
cadence (SCALE_DECISION events) and resizes its replica fleet:

* **night ebb** — surplus replicas are retired; the freed GPUs flow to
  the scheduler's pending queue, where low-priority training backfill
  soaks them up;
* **morning ramp** — new high-priority replicas are submitted; when the
  pool is full they block at the queue head and the framework's
  **Preempt** chain (PriorityPreempt) evicts the low-priority backfill
  to hand the GPUs back — the fleet is never starved by its own
  generosity.

Replica pods go through the same Admit/Reserve/Permit pipeline as any
job, so quota and feasibility checks apply unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..events import EventKind
from ..framework.api import DynamicsPlugin
from ..framework.registry import register
from ..job import Job, JobKind, JobState, PRIO_HIGH
from ..workload import diurnal_demand


@dataclasses.dataclass
class TidalService:
    """One autoscaled inference service and its demand curve."""

    name: str
    tenant: str = "svc"
    gpu_type: int = 0
    gpus_per_replica: int = 1
    min_replicas: int = 1
    max_replicas: int = 8
    peak_hour: float = 14.0
    priority: int = PRIO_HIGH
    #: Measured demand hook: replicas wanted at time ``t`` (fractional
    #: ok; clipped to [min, max]).  When set it replaces the analytic
    #: diurnal curve — this is how the serving fabric's ReplicaPool
    #: exports its observed request load to the autoscaler
    #: (see :func:`repro_torch.serve.replica.demand_service`).
    demand: Optional[Callable[[float], float]] = None

    def target_replicas(self, t: float) -> int:
        """Demanded replica count at time ``t`` (rounded to a pod)."""
        if self.demand is not None:
            raw = float(self.demand(t))
            return int(round(min(float(self.max_replicas),
                                 max(float(self.min_replicas), raw))))
        return int(round(diurnal_demand(t, self.min_replicas,
                                        self.max_replicas,
                                        peak_hour=self.peak_hour)))


@dataclasses.dataclass
class DemandSample:
    t: float
    service: str
    target: int
    running: int
    fleet: int           # running + pending replicas


@register
class TidalAutoscaler(DynamicsPlugin):
    """Scales replica fleets along their diurnal demand curves."""

    name = "TidalAutoscaler"
    handles = (EventKind.SCALE_DECISION,)

    def __init__(self, services: Sequence[TidalService],
                 interval_s: float = 900.0, start: float = 0.0) -> None:
        if interval_s <= 0:
            raise ValueError("scale interval must be positive")
        self.services = list(services)
        self.interval_s = float(interval_s)
        self.start = float(start)
        self._fleet: Dict[str, List[Job]] = {s.name: []
                                             for s in self.services}
        #: (t, service, target, running, fleet) log — the benchmark's
        #: demand-satisfaction series.
        self.demand_log: List[DemandSample] = []
        self.replicas_started = 0
        self.replicas_retired = 0

    # ------------------------------------------------------------------
    def schedule(self, engine, rng) -> Sequence[Tuple[float, EventKind,
                                                      object]]:
        # {"owner": self} routes the chain to this autoscaler only —
        # several autoscalers can coexist without consuming (and
        # re-continuing) each other's SCALE_DECISION events.
        return [(self.start, EventKind.SCALE_DECISION, {"owner": self})]

    def on_event(self, event, engine) -> None:
        t = event.t
        for svc in self.services:
            self._scale_service(svc, t, engine)
        if t + self.interval_s <= engine.horizon:
            engine.push(t + self.interval_s, EventKind.SCALE_DECISION,
                        {"owner": self})

    # ------------------------------------------------------------------
    def _scale_service(self, svc: TidalService, t: float,
                       engine) -> None:
        fleet = self._fleet[svc.name]
        # Drop replicas that left the system (completed / failed).
        fleet[:] = [j for j in fleet
                    if j.state not in (JobState.COMPLETED, JobState.FAILED)]
        target = svc.target_replicas(t)
        running = sum(1 for j in fleet if j.state is JobState.RUNNING)
        if target > len(fleet):
            for _ in range(target - len(fleet)):
                fleet.append(self._submit_replica(svc, t, engine))
                self.replicas_started += 1
        elif target < len(fleet):
            # Retire pending replicas first (cheapest), then the
            # youngest running ones (oldest replicas keep the caches).
            doomed = sorted(
                fleet, key=lambda j: (
                    j.state is JobState.RUNNING,
                    -(j.start_time if j.start_time is not None else t)))
            for job in doomed[:len(fleet) - target]:
                engine.retire_job(job, t)
                fleet.remove(job)
                self.replicas_retired += 1
        self.demand_log.append(DemandSample(
            t=t, service=svc.name, target=target, running=running,
            fleet=len(fleet)))

    def _submit_replica(self, svc: TidalService, t: float, engine) -> Job:
        job = Job(
            uid=engine.next_uid(),
            tenant=svc.tenant,
            gpu_type=svc.gpu_type,
            n_pods=1,
            gpus_per_pod=svc.gpus_per_replica,
            kind=JobKind.INFER,
            gang=False,
            priority=svc.priority,
            submit_time=t,
            # Replicas live until retired: size the nominal duration to
            # the remaining horizon so no natural END fires first.
            duration=max(1.0, engine.horizon - t + 3600.0),
            preemptible=False,
        )
        engine.submit_job(job, t)
        return job

    # ------------------------------------------------------------------
    def satisfaction(self) -> float:
        """Mean demand satisfaction: running/target, clipped at 1."""
        vals = [min(1.0, s.running / s.target) for s in self.demand_log
                if s.target > 0]
        return sum(vals) / len(vals) if vals else 1.0
