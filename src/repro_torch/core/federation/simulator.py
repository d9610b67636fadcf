"""FederatedSimulator: N member event buses driven in ONE lockstep loop.

Each member gets its own :class:`~repro_torch.core.simulator.Simulator`
(state, QSCH, metrics, optional dynamics — failures, drains, tidal
autoscaling compose per member on the existing
:mod:`repro_torch.core.events` kinds).  This driver merges the member buses
into a single global ordering:

* the next event is the minimum over member bus heads by
  ``(t, kind, member, seq)`` — within one member that is exactly the
  bus's own ``(t, kind, seq)`` contract, so member-local dispatch order
  is untouched;
* job *arrivals* live outside any bus until the GSCH routes them: an
  arrival at time ``t`` is processed before any member event with
  ``(t', kind') > (t, SUBMIT)``, which reproduces the plain simulator's
  "SUBMITs sort first at equal timestamps" ordering;
* after a member TICK dispatches, the GSCH gets its spillover pass for
  that member, and after an authoritative END the federation quota is
  refunded and the quota backlog retried.

Determinism/parity contract: with ONE member, no federation quota and
the default config, every event dispatches in exactly the order the
plain ``Simulator.run`` would produce — placements and metric samples
are byte-identical (gated by ``benchmarks/federation_bench.py``).  The
member TICK/SAMPLE chains stay alive while federation-level work is
outstanding via the simulator's ``external_work`` hook (mirroring the
pre-pushed-SUBMIT behavior of the standalone loop), and all member
chains are started at the first arrival so samples align across
members while the federation is loaded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..events import EventKind
from ..job import Job, JobState
from ..simulator import SimResult, Simulator
from .gsch import GSCH, GSCHConfig, RoutingStats
from .member import FederatedCluster, MemberCluster
from .metrics import FederatedMetrics


@dataclasses.dataclass
class FederatedResult:
    jobs: List[Job]
    members: List[SimResult]
    metrics: FederatedMetrics
    routing: RoutingStats
    end_time: float
    cycles: int
    preemptions: int
    spills: int
    # Jobs never handed to any member (held in the federation-quota
    # backlog at the horizon, or arriving past it).  Empty on
    # single-member runs, where unrouted jobs stay attributed to the
    # lone member exactly like the plain Simulator attributes them.
    unrouted: List[Job] = dataclasses.field(default_factory=list)

    def report(self) -> Dict[str, object]:
        rep = self.metrics.report(self.jobs)
        rep["routing"] = {
            "routed": list(self.routing.routed),
            "spills": self.routing.spills,
            "cross_region_forwards": self.routing.cross_region_forwards,
            "backlogged": self.routing.backlogged,
            "summary_refreshes": self.routing.summary_refreshes,
        }
        return rep


class FederatedSimulator:
    def __init__(self, fed: FederatedCluster,
                 config: Optional[GSCHConfig] = None,
                 horizon: Optional[float] = None) -> None:
        self.fed = fed
        self.gsch = GSCH(fed, config)
        self.horizon = horizon
        self.sims: List[Simulator] = []
        for m in fed.members:
            if horizon is not None and m.sim_config.horizon is None:
                # One global clock: member dynamics traces and drains
                # sample against the federation horizon.
                m.sim_config = dataclasses.replace(m.sim_config,
                                                   horizon=horizon)
            self.sims.append(Simulator(m.state, m.qsch, m.sim_config))
        self._arrivals_left = 0
        for sim in self.sims:
            sim.external_work = self._federation_work_outstanding

    # ------------------------------------------------------------------
    def attach_telemetry(self, tel) -> None:
        """Attach one :class:`repro_torch.obs.Telemetry` across every member,
        scoped by member name: registry series get ``member=...``
        labels, each member runs its own scheduler trace lane, and
        decisions carry the member they were made on.  The lockstep
        loop dispatches one member event at a time, so the shared
        facade's per-scope cycle accumulators never interleave."""
        for m, sim in zip(self.fed.members, self.sims):
            tel.attach(sim, scope=m.name)
        if tel.registry is not None:
            metrics = FederatedMetrics(
                names=[m.name for m in self.fed.members],
                recorders=[sim.metrics for sim in self.sims])
            tel.registry.add_collector(lambda reg: metrics.publish(reg))

    # ------------------------------------------------------------------
    def _federation_work_outstanding(self) -> bool:
        """Unrouted arrivals or quota-held jobs keep member TICK/SAMPLE
        chains alive, exactly like pre-pushed SUBMITs do standalone."""
        return self._arrivals_left > 0 or bool(self.gsch.backlog)

    def _forward(self, job: Job, member: int, t: float) -> None:
        """Hand a routed job to a member bus and make sure that member
        will actually run cycles to look at it."""
        sim = self.sims[member]
        sim.bus.push(t, EventKind.SUBMIT, job)
        sim.ensure_tick(t)
        sim.ensure_sample(t)

    def _start_chains(self, t: float) -> None:
        """Lockstep start: every member begins ticking/sampling at the
        first arrival so per-member samples align while loaded."""
        for sim in self.sims:
            sim.ensure_tick(t)
            sim.ensure_sample(t)

    # ------------------------------------------------------------------
    def run(self, jobs: Sequence[Job]) -> FederatedResult:
        gsch = self.gsch
        for sim in self.sims:
            sim.attach_dynamics()
        arrivals = sorted(jobs, key=lambda j: j.submit_time)
        self._arrivals_left = len(arrivals)
        if not arrivals:
            # Dynamics-only federation: anchor metrics like the plain
            # simulator's no-jobs branch.
            for sim in self.sims:
                if sim.config.dynamics is not None and len(sim.bus):
                    sim.bus.push(0.0, EventKind.SAMPLE)
        next_arrival = 0
        started = False
        while True:
            # Next member event: min over bus heads by (t, kind, member).
            best = None
            best_key = None
            for i, sim in enumerate(self.sims):
                ev = sim.bus.peek()
                if ev is None:
                    continue
                key = (ev.t, int(ev.kind), i)
                if best_key is None or key < best_key:
                    best, best_key = i, key
            if next_arrival < len(arrivals):
                job = arrivals[next_arrival]
                akey = (job.submit_time, int(EventKind.SUBMIT))
                if best_key is None or akey < best_key[:2]:
                    if (self.horizon is not None
                            and job.submit_time > self.horizon):
                        break
                    next_arrival += 1
                    self._arrivals_left -= 1
                    if not started:
                        self._start_chains(job.submit_time)
                        started = True
                    target = gsch.route(job, job.submit_time)
                    if target is not None:
                        self._forward(job, target, job.submit_time)
                    continue
            if best is None:
                break
            if self.horizon is not None and best_key[0] > self.horizon:
                break
            sim = self.sims[best]
            ev = sim.bus.pop()
            sim.now = ev.t
            sim.bus.dispatch(ev)
            if ev.kind is EventKind.TICK:
                for job, target, arrive in gsch.maybe_spill(best, ev.t):
                    self._forward(job, target, arrive)
                for job, target in gsch.drain_backlog(ev.t):
                    self._forward(job, target, ev.t)
            elif (ev.kind is EventKind.END
                  and isinstance(ev.payload, Job)
                  and ev.payload.state is JobState.COMPLETED):
                gsch.on_job_finished(ev.payload)

        # Finalize members; attribute each job to where it last ran or
        # waited.  Jobs with no route record (quota backlog / past the
        # horizon) belong to no member — except in the single-member
        # degenerate case, where the plain Simulator's SimResult.jobs
        # carries the full trace.
        member_jobs: List[List[Job]] = [[] for _ in self.sims]
        unrouted: List[Job] = []
        for job in arrivals:
            rec = gsch.routes.get(job.uid)
            if rec is not None:
                member_jobs[rec.member].append(job)
            elif len(self.sims) == 1:
                member_jobs[0].append(job)
            else:
                unrouted.append(job)
        results = [sim.finalize(member_jobs[i])
                   for i, sim in enumerate(self.sims)]
        metrics = FederatedMetrics(
            names=[m.name for m in self.fed.members],
            recorders=[sim.metrics for sim in self.sims])
        return FederatedResult(
            jobs=list(arrivals), members=results, metrics=metrics,
            routing=gsch.stats,
            end_time=max((r.end_time for r in results), default=0.0),
            cycles=sum(r.cycles for r in results),
            preemptions=sum(r.preemptions for r in results),
            spills=gsch.stats.spills, unrouted=unrouted)
