"""Discrete-event cluster simulator driving QSCH + RSCH.

The loop is an :class:`~repro_torch.core.events.EventBus` (see that module for
the determinism contract).  Built-in event kinds:

* ``SUBMIT``  — a job arrives and enters its tenant queue;
* ``TICK``    — a scheduling cycle fires (QSCH admission -> RSCH placement
  -> binding);
* ``END``     — a running job completes and releases devices;
* ``SAMPLE``  — metrics sampling.

The dynamics subsystem (:mod:`repro_torch.core.dynamics`) subscribes the
remaining kinds (NODE_FAIL, NODE_RECOVER, GPU_FAIL/RECOVER,
DRAIN_START/END, SCALE_DECISION) when ``SimConfig.dynamics`` is set;
with it unset the event stream — and therefore every placement and
metric — is identical to the pre-bus simulator (asserted by
``benchmarks/dynamics_bench.py``).

Binding latency (image pull, container start — §4.2) is modeled as a
constant delay between scheduling completion and Running, but GPU-hours
accrue from scheduling completion per the SOR definition.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence

from .cluster import ClusterState
from .events import Event, EventBus, EventKind
from .job import Job, JobState
from .metrics import MetricsRecorder
from .qsch import QSCH, CycleResult

if TYPE_CHECKING:  # dynamics imports stay lazy — see run()
    from .dynamics.engine import ClusterDynamics, DynamicsConfig


@dataclasses.dataclass
class SimConfig:
    tick_interval: float = 30.0        # scheduling cycle period (s)
    sample_interval: float = 300.0     # metric sampling period (s)
    binding_latency: float = 45.0      # schedule->running delay (s)
    horizon: Optional[float] = None    # stop time; default: drain
    # Cluster dynamics (failures, drains, autoscaling); None = static
    # cluster, byte-identical to the pre-dynamics simulator.
    dynamics: Optional["DynamicsConfig"] = None
    # Optimistic cycle pipelining (repro_torch.core.pipeline): speculatively
    # snapshot+score the next cycle's head job so a pipelined deployment
    # can overlap it with binding I/O.  Off = byte-identical classic
    # sequential cycles.
    pipelined_cycles: bool = False


@dataclasses.dataclass
class SimResult:
    jobs: List[Job]
    metrics: MetricsRecorder
    end_time: float
    cycles: int
    preemptions: int
    # Why jobs waited (summed over cycles; see CycleResult counters):
    # static-admission rejections, dynamic-admission failures, and
    # requeue events (§3.2.4: placement failures + preemptions).
    admit_rejected: int = 0
    infeasible: int = 0
    requeues: int = 0
    # Dynamics accounting (zero on static runs); the engine's summary
    # object carries the detailed per-event breakdown.
    failures: int = 0
    interrupts: int = 0
    drains: int = 0
    scale_events: int = 0
    dynamics: Optional[object] = None
    # CyclePipeline.stats() when pipelined_cycles was on (hits,
    # conflicts, misses, spec_seconds); None otherwise.
    pipeline: Optional[dict] = None


class Simulator:
    def __init__(self, state: ClusterState, qsch: QSCH,
                 config: Optional[SimConfig] = None) -> None:
        self.state = state
        self.qsch = qsch
        self.config = config or SimConfig()
        self.metrics = MetricsRecorder(state.topology)
        elastic = getattr(qsch, "elastic", None)
        if elastic is not None:
            # Voluntary reshapes report through the same recorder as
            # failures (flagged, so MTTR stays failure-only).
            elastic.bind_metrics(self.metrics)
        if self.config.pipelined_cycles and qsch.pipeline is None:
            qsch.enable_pipeline()
        self.bus = EventBus()
        self.now = 0.0
        self.cycles = 0
        self.preemptions = 0
        self.admit_rejected = 0
        self.infeasible = 0
        self.requeues = 0
        # job uid -> authoritative END time; a preempted/interrupted
        # job's stale END event must be ignored (the rescheduled run
        # pushes a fresh one).
        self.pending_ends: Dict[int, float] = {}
        # Extra work-outstanding predicate for federated drivers: jobs
        # not yet routed to this member live outside the bus, so the
        # TICK/SAMPLE chains must not die while the federation still has
        # arrivals or in-flight forwards (None = standalone, unchanged).
        self.external_work: Optional[Callable[[], bool]] = None
        self._engine: Optional["ClusterDynamics"] = None
        # Optional telemetry facade (repro_torch.obs.Telemetry.attach sets it,
        # together with qsch.obs / rsch.obs / metrics.obs / bus.tap).
        # None = untelemetered, byte-identical output.
        self.obs = None
        self._register_builtins()

    # ------------------------------------------------------------------
    # Built-in handlers
    # ------------------------------------------------------------------
    def _register_builtins(self) -> None:
        self.bus.subscribe(EventKind.SUBMIT, self._on_submit)
        self.bus.subscribe(EventKind.END, self._on_end)
        self.bus.subscribe(EventKind.TICK, self._on_tick)
        self.bus.subscribe(EventKind.SAMPLE, self._on_sample)

    def _on_submit(self, ev: Event) -> None:
        self.qsch.submit(ev.payload)

    def _on_end(self, ev: Event) -> None:
        job = ev.payload
        if (job.state is JobState.RUNNING
                and self.pending_ends.get(job.uid) == ev.t):
            self.pending_ends.pop(job.uid, None)
            self.qsch.on_complete(job, self.state, ev.t)
            self.metrics.on_job_finished(job)

    def _on_tick(self, ev: Event) -> None:
        cfg = self.config
        result = self.qsch.cycle(self.state, ev.t)
        self.cycles += 1
        self.preemptions += len(result.preempted)
        self.admit_rejected += result.admit_rejected
        self.infeasible += result.infeasible
        self.requeues += result.requeues
        for job in result.scheduled:
            self.metrics.on_job_placed(job, now=ev.t)
            job.run_time = ev.t + cfg.binding_latency
            end = job.run_time + job.duration
            self.pending_ends[job.uid] = end
            self.bus.push(end, EventKind.END, job)
        # Keep ticking while anything is queued or running.
        if self._work_outstanding():
            self.bus.push(ev.t + cfg.tick_interval, EventKind.TICK)

    def _on_sample(self, ev: Event) -> None:
        self.metrics.sample(ev.t, self.state, self.qsch.queue_depth(),
                            running=self.qsch.running)
        if self._work_outstanding():
            self.bus.push(ev.t + self.config.sample_interval,
                          EventKind.SAMPLE)

    def _work_outstanding(self) -> bool:
        return bool(self.qsch.queue_depth() or self.qsch.running
                    or self.bus.pending(EventKind.SUBMIT)
                    or (self.external_work is not None
                        and self.external_work()))

    # ------------------------------------------------------------------
    # Revival hooks (dynamics): a failure or scale decision can create
    # work after the TICK/SAMPLE chains died out — restart them without
    # ever double-scheduling (the per-kind pending counters are O(1)).
    # ------------------------------------------------------------------
    def ensure_tick(self, t: float) -> None:
        if self.bus.pending(EventKind.TICK) == 0:
            self.bus.push(t, EventKind.TICK)

    def ensure_sample(self, t: float) -> None:
        if self.bus.pending(EventKind.SAMPLE) == 0:
            self.bus.push(t, EventKind.SAMPLE)

    # ------------------------------------------------------------------
    # Run = prime + event loop + finalize.  The pieces are public so a
    # federated driver (repro_torch.core.federation) can prime members, merge
    # their buses in ONE lockstep loop, and finalize each — a standalone
    # ``run`` stays byte-identical to the pre-split implementation.
    # ------------------------------------------------------------------
    def attach_dynamics(self) -> None:
        """Instantiate and attach the dynamics engine (idempotent)."""
        if self.config.dynamics is not None and self._engine is None:
            from .dynamics.engine import ClusterDynamics
            self._engine = ClusterDynamics(self.config.dynamics)
            self._engine.attach(self)
            elastic = getattr(self.qsch, "elastic", None)
            if elastic is not None:
                # One checkpoint model for failures AND reshapes unless
                # the elastic config pinned its own.
                elastic.adopt_recovery(self.config.dynamics.recovery)

    def prime(self, jobs: Sequence[Job]) -> List[Job]:
        """Attach dynamics, enqueue submissions, start the TICK/SAMPLE
        chains.  Returns the submit-time-sorted job list."""
        self.attach_dynamics()
        jobs = sorted(jobs, key=lambda j: j.submit_time)
        for j in jobs:
            self.bus.push(j.submit_time, EventKind.SUBMIT, j)
        if jobs:
            t0 = jobs[0].submit_time
            self.bus.push(t0, EventKind.TICK)
            self.bus.push(t0, EventKind.SAMPLE)
        elif self._engine is not None and len(self.bus):
            # Dynamics-only run (e.g. a pure autoscaler scenario): the
            # engine seeded events; give metrics a t=0 anchor.
            self.bus.push(0.0, EventKind.SAMPLE)
        return list(jobs)

    def finalize(self, jobs: Sequence[Job]) -> SimResult:
        """Closing metrics sample + result assembly."""
        self.metrics.sample(self.now, self.state, self.qsch.queue_depth(),
                            running=self.qsch.running)
        result = SimResult(jobs=list(jobs), metrics=self.metrics,
                           end_time=self.now, cycles=self.cycles,
                           preemptions=self.preemptions,
                           admit_rejected=self.admit_rejected,
                           infeasible=self.infeasible,
                           requeues=self.requeues)
        if self.qsch.pipeline is not None:
            result.pipeline = self.qsch.pipeline.stats()
        if self._engine is not None:
            self._engine.finalize(result)
        if self.obs is not None:
            self.obs.finalize_run(self)
        return result

    def run(self, jobs: Sequence[Job]) -> SimResult:
        cfg = self.config
        jobs = self.prime(jobs)
        while len(self.bus):
            ev = self.bus.pop()
            if cfg.horizon is not None and ev.t > cfg.horizon:
                break
            self.now = ev.t
            self.bus.dispatch(ev)
        return self.finalize(jobs)
