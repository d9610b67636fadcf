"""The Telemetry facade: one attach point for all four pillars.

``Telemetry`` owns a :class:`~repro_torch.obs.registry.MetricRegistry`, a
:class:`~repro_torch.obs.trace.Tracer` and the observer chain (including the
built-in :class:`~repro_torch.obs.audit.DecisionAudit`), and wires them into
a simulator with one call::

    tel = Telemetry()
    sim = Simulator(state, qsch, cfg)
    tel.attach(sim)
    result = sim.run(jobs)
    tel.save("run_telemetry.json")        # full bundle
    tel.save_trace("run_trace.json")      # Perfetto-loadable trace

``attach`` sets the duck-typed ``obs`` attribute on the QSCH, RSCH and
MetricsRecorder and installs the EventBus tap — the *only* coupling the
core has to this package.  With no telemetry attached every ``obs`` is
``None`` and the pipeline is byte-identical to an untelemetered build
(held by ``chip_smoke.py``'s ``obs`` phase); attached overhead is
budgeted at ≤5% per cycle at 10k nodes by the same phase.

A federation attaches one Telemetry to every member simulator with a
*scope*::

    tel = Telemetry()
    fed_sim.attach_telemetry(tel)   # scope = member name per member

Scoped streams label registry series with ``member=...``, run one
scheduler trace lane per member, and stamp decisions with the member
name.

Time domains: the registry clock and job/cluster trace events run on
**simulated** time; cycle spans are **wall-clock** (that is what "where
does scheduling CPU go" means).  See :mod:`repro_torch.obs.trace`.

Spans: every span (the cycle, its pipeline phases, and the program's
other spans: ``admit``, ``schedule``, ``pass-zone``, ``pass-general``
and ``pass-all`` (the passes of a plan of more than one), ``level1``,
``devices``, ``seam`` and its parts, ``backfill`` (Backfill's pass
over the jobs behind a blocked head), ``head-timeout`` (a head past its
timeout running its Preempt plugin), ``event``, ``loop``, ``end``,
``gc``) records its start
and end on ``time.perf_counter_ns`` and nests under the span open when
it began.  Closing a span adds its time to its parent's children, so
every name has a self time (its duration less its children's) beside
its count: :attr:`Telemetry.span_self_s`, :attr:`Telemetry.span_count`.
Only the pipeline phases also feed ``phase_totals`` and
``CycleSpan.phases``.  ``attach`` also hooks garbage collections
(``gc``); the event bus keeps a ``loop`` span open from the end of one
dispatch to the start of the next (whatever drives the bus: its pop, the
caller's loop); and RSCH's ``schedule`` hands this telemetry to the
score seam (``core.scoring.probed``), which then times each pass's
parts.  Attach with ``audit=False`` to measure the path a detached run
takes: an audit capture makes RSCH score the whole cluster instead of
the selected groups.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import weakref
from time import perf_counter_ns
from typing import Dict, List, Optional, Sequence

from ..core.events import EventKind
from ..launch.combo_cache import cache_stats
from .audit import DecisionAudit, PreemptionRecord, build_decision
from .registry import MetricRegistry
from .trace import PID_CLUSTER, PID_JOBS, PID_SCHED, Tracer

__all__ = ["Telemetry", "CycleSpan", "JobRecord"]

#: The argument a span opened through ``span`` records, by span name
#: (``cycle`` records ``t_sim`` and ``gc`` its ``generation``).
_SPAN_ARGS = {"schedule": "uid", "event": "kind"}

#: The score seam's counters: name, help, labels; tallied per pass in
#: plain numbers and published to the registry when it is collected.
_SEAM_COUNTERS = (
    ("kant_seam_calls_total", "score seam passes", {}),
    ("kant_seam_rows_total", "node rows given to the score seam", {}),
    ("kant_seam_bytes_total", "packed bytes of the score seam, by direction",
     {"dir": "up"}),
    ("kant_seam_bytes_total", "packed bytes of the score seam, by direction",
     {"dir": "down"}),
)

#: The commit path's tallies, kept on the state in plain numbers and
#: published when the registry is collected: the attribute of
#: ``ClusterState`` and its index, then name, help and labels.  The pods
#: ``allocate`` committed (``commit_pods``: one gang write, pod by pod);
#: the rows a commit updated on the state and on its snapshots, by count
#: deltas or re-derived, and the snapshots' group-sum patches
#: (``commit_work``).
_COMMIT_COUNTERS = (
    ("commit_pods", 0, "kant_commit_pods_total",
     "pods committed to the column block, by path", {"path": "batched"}),
    ("commit_pods", 1, "kant_commit_pods_total",
     "pods committed to the column block, by path", {"path": "per_pod"}),
    ("commit_work", 0, "kant_commit_rows_total",
     "rows a commit updated on the state and its snapshots, by path",
     {"path": "delta"}),
    ("commit_work", 1, "kant_commit_rows_total",
     "rows a commit updated on the state and its snapshots, by path",
     {"path": "rederive"}),
    ("commit_work", 2, "kant_group_sum_patches_total",
     "per-group sums patched when read", {}),
)

#: Counters tallied in plain numbers where they happen and published
#: when the registry is collected, with their help: the placement passes
#: RSCH ran, by pool (``zone``, ``general`` or ``all``) and whether the
#: pass placed the job; Backfill's tries of the jobs behind a blocked
#: head, by outcome (``bound``, ``admit``: turned away by admission,
#: ``placement``: admitted and not bound); the cycles in which a head
#: past its timeout ran its Preempt plugin.
_TALLIED = {
    "kant_placement_passes_total":
        "placement passes run, by pool and outcome",
    "kant_backfill_attempts_total":
        "tries of a job behind a blocked head, by outcome",
    "kant_head_timeouts_total":
        "cycles in which a head past its timeout ran its Preempt plugin",
}

#: Telemetries whose spans receive the process's garbage collections.
_GC_LISTENERS: "weakref.WeakSet" = weakref.WeakSet()


def _gc_callback(phase: str, info: Dict) -> None:
    """The one ``gc.callbacks`` entry: a ``gc`` span on every listener."""
    for tel in list(_GC_LISTENERS):
        tel._on_gc(phase, info)


#: Histogram buckets for per-cycle wall time (seconds).
_CYCLE_BUCKETS = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1,
                  0.3, 1.0)


@dataclasses.dataclass
class CycleSpan:
    """One QSCH cycle as observers see it (the Tick tap payload)."""

    t: float                      # simulated cycle time
    wall_s: float                 # wall-clock duration
    phases: Dict[str, float]      # phase -> wall seconds
    scope: Optional[str]
    result: object                # framework.api.CycleResult


@dataclasses.dataclass
class JobRecord:
    """Per-job lifecycle summary accumulated from the hooks."""

    uid: int
    tenant: str
    kind: str
    n_gpus: int
    submit_t: Optional[float] = None
    first_start: Optional[float] = None
    end_t: Optional[float] = None
    binds: int = 0
    interrupts: int = 0
    reshapes: int = 0
    preemptions: int = 0
    scope: Optional[str] = None
    _span_open: bool = False

    @property
    def wait_s(self) -> Optional[float]:
        if self.submit_t is None or self.first_start is None:
            return None
        return self.first_start - self.submit_t

    def as_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d.pop("_span_open", None)
        d["wait_s"] = self.wait_s
        return d


class _Span:
    """Context manager of one span name on one scope's lane.  A pipeline
    phase (``phase``) also adds its wall time to the phase totals.  The
    open span lives on the telemetry's stack, so the object holds no
    timing of its own; ``arg`` is read when the span opens."""

    __slots__ = ("tel", "scope", "name", "tid", "key", "phase", "arg")

    def __init__(self, tel: "Telemetry", scope: Optional[str], name: str,
                 phase: bool) -> None:
        self.tel = tel
        self.scope = scope
        self.name = name
        # Unscoped spans take the lane of the span they open under.
        self.tid = None if scope is None else tel._sched_tid(scope)
        self.key = _SPAN_ARGS.get(name)
        self.phase = phase
        self.arg = None

    def __enter__(self) -> "_Span":
        self.tel._open(self.name, self.tid, self.key, self.arg)
        return self

    def __exit__(self, *exc) -> None:
        dt_ns = self.tel._close()
        if self.phase:
            self.tel._phase_done(self.scope, self.name, dt_ns / 1e9)


class _ScopedTelemetry:
    """Thin per-member adapter: the same obs interface, scope-bound."""

    def __init__(self, tel: "Telemetry", scope: str) -> None:
        self._tel = tel
        self._scope = scope

    @property
    def audit_on(self) -> bool:
        return self._tel.audit_on

    def phase(self, name: str) -> _Span:
        return self._tel._timer(self._scope, name, True)

    def span(self, name: str, arg=None) -> _Span:
        span = self._tel._timer(self._scope, name, False)
        span.arg = arg
        return span

    def cycle_begin(self, now: float) -> None:
        self._tel.cycle_begin(now, scope=self._scope)

    def cycle_end(self, result, ctx) -> None:
        self._tel.cycle_end(result, ctx, scope=self._scope)

    def emit_bind(self, job, sched, ctx) -> None:
        self._tel.emit_bind(job, sched, ctx, scope=self._scope)

    def emit_reject(self, job, sched, ctx, reason: str) -> None:
        self._tel.emit_reject(job, sched, ctx, reason, scope=self._scope)

    def emit_preempt(self, victim, ctx, source) -> None:
        self._tel.emit_preempt(victim, ctx, source, scope=self._scope)

    def on_bus_event(self, event) -> None:
        self._tel.on_bus_event(event, scope=self._scope)

    def loop_open(self) -> None:
        self._tel.loop_open(self._scope)

    def loop_close(self) -> None:
        self._tel.loop_close()

    def seam_done(self, rows: int, up_bytes: int, down_bytes: int) -> None:
        self._tel.seam_done(rows, up_bytes, down_bytes)

    def pass_done(self, pool: str, placed: bool) -> None:
        self._tel.pass_done(pool, placed, scope=self._scope)

    def backfill_try(self, outcome: str) -> None:
        self._tel.backfill_try(outcome, scope=self._scope)

    def head_timeout(self) -> None:
        self._tel.head_timeout(scope=self._scope)

    def on_sample(self, sample) -> None:
        self._tel.on_sample(sample, scope=self._scope)

    def on_job_placed(self, job, now) -> None:
        self._tel.on_job_placed(job, now, scope=self._scope)

    def on_job_finished(self, job) -> None:
        self._tel.on_job_finished(job, scope=self._scope)

    def on_job_interrupted(self, job, t, lost, overhead, reshape) -> None:
        self._tel.on_job_interrupted(job, t, lost, overhead, reshape,
                                     scope=self._scope)

    def on_param_change(self, change) -> None:
        self._tel.on_param_change(change, scope=self._scope)

    def finalize_run(self, sim) -> None:
        self._tel.finalize_run(sim, scope=self._scope)


class Telemetry:
    """Unified telemetry: metric registry + tracing + decision audit.

    ``registry`` / ``tracing`` / ``audit`` toggle the pillars (each
    ``False`` drops that pillar's cost entirely); ``observers`` adds
    custom :class:`~repro_torch.core.framework.api.ObserverPlugin` instances
    behind the built-in audit.
    """

    def __init__(self, registry: bool = True, tracing: bool = True,
                 audit: bool = True, observers: Sequence = (),
                 ring: int = 512, max_trace_events: int = 500_000,
                 audit_max_records: int = 20_000) -> None:
        self._simclock = 0.0
        self.registry: Optional[MetricRegistry] = (
            MetricRegistry(ring=ring, clock=lambda: self._simclock)
            if registry else None)
        self.tracer: Optional[Tracer] = (
            Tracer(max_events=max_trace_events) if tracing else None)
        self.audit: Optional[DecisionAudit] = (
            DecisionAudit(max_records=audit_max_records) if audit
            else None)
        self.observers: List = ([self.audit] if self.audit is not None
                                else []) + list(observers)
        self._timers: Dict[tuple, _Span] = {}
        self._cycles: Dict[Optional[str], Dict] = {}
        self._scope_tids: Dict[Optional[str], int] = {}
        self.phase_totals: Dict[str, float] = {}
        # Open spans, innermost last: [name, tid, start_ns, children_ns,
        # written to the trace].
        self._stack: List[list] = []
        # Per span name: [self ns, total ns, count].
        self._spans: Dict[str, List[int]] = {}
        # The number of the cycle open now (None between cycles): the
        # identifier that the spans of one cycle share.
        self._cycle_no: Optional[int] = None
        self._n_cycles = 0
        # The seam's tallies (``_SEAM_COUNTERS``) and what the registry
        # has of them.
        self._seam = [0] * len(_SEAM_COUNTERS)
        self._seam_published = list(self._seam)
        # The ``_TALLIED`` counters, (name, scope, labels) -> count, and
        # what the registry has of them.
        self._tallies: Dict[tuple, int] = {}
        self._tallies_published: Dict[tuple, int] = {}
        self.jobs: Dict[tuple, JobRecord] = {}
        self.event_counts: Dict[str, int] = {}
        self._attached: List = []
        if self.registry is not None:
            self.registry.add_collector(self._collect_combo_caches)
            self.registry.add_collector(self._collect_seam)
            self.registry.add_collector(self._collect_tallies)

    # -- wiring --------------------------------------------------------
    @property
    def audit_on(self) -> bool:
        return bool(self.observers)

    def attach(self, sim, scope: Optional[str] = None) -> None:
        """Wire this telemetry into a simulator (and its QSCH/RSCH/
        metrics + event bus).  ``scope`` labels a federation member."""
        obs = self if scope is None else _ScopedTelemetry(self, scope)
        sim.obs = obs
        sim.qsch.obs = obs
        sim.qsch.rsch.obs = obs
        sim.metrics.obs = obs
        sim.bus.tap = obs.on_bus_event
        sim.bus.obs = obs
        self._attached.append(sim)
        _GC_LISTENERS.add(self)
        if _gc_callback not in gc.callbacks:
            gc.callbacks.append(_gc_callback)
        if self.tracer is not None:
            self.tracer.anchor()
        if self.registry is not None:
            lbl = self._labels(scope)
            # What the state had committed before it was attached.
            committed = [getattr(sim.state, attr)[i]
                         for attr, i, *_ in _COMMIT_COUNTERS]

            def collect(reg, sim=sim, lbl=lbl, committed=committed):
                for j, (attr, i, name, help_, labels) in enumerate(
                        _COMMIT_COUNTERS):
                    value = getattr(sim.state, attr)[i]
                    if value != committed[j]:
                        reg.counter(name, help_).inc(
                            value - committed[j], **labels, **lbl)
                        committed[j] = value
                eng = getattr(sim, "_engine", None)
                if eng is not None:
                    for k, v in eng.summary.as_dict().items():
                        reg.gauge("kant_dynamics_" + k,
                                  "dynamics engine counters").set(v, **lbl)
                elastic = getattr(sim.qsch, "elastic", None)
                if elastic is not None:
                    for k, v in elastic.stats().items():
                        reg.gauge("kant_elastic_" + k,
                                  "elastic manager counters").set(v, **lbl)
            self.registry.add_collector(collect)

    def detach(self, sim) -> None:
        """Undo :meth:`attach` (the byte-identity benchmark's A side)."""
        sim.obs = None
        sim.qsch.obs = None
        sim.qsch.rsch.obs = None
        sim.metrics.obs = None
        sim.bus.tap = None
        sim.bus.obs = None
        if sim in self._attached:
            self._attached.remove(sim)
        self.loop_close()
        if not self._attached:
            self._unhook()

    def _unhook(self) -> None:
        """Stop receiving garbage collections (the last sim detached, or
        a run ended)."""
        _GC_LISTENERS.discard(self)
        if not _GC_LISTENERS and _gc_callback in gc.callbacks:
            gc.callbacks.remove(_gc_callback)

    def attach_qsch(self, qsch, scope: Optional[str] = None) -> None:
        """Wire a bare QSCH/RSCH pair (no simulator) — unit-test and
        standalone-cycle use."""
        obs = self if scope is None else _ScopedTelemetry(self, scope)
        qsch.obs = obs
        qsch.rsch.obs = obs

    # -- labels / lanes ------------------------------------------------
    @staticmethod
    def _labels(scope: Optional[str]) -> Dict[str, str]:
        return {} if scope is None else {"member": scope}

    def _sched_tid(self, scope: Optional[str]) -> int:
        tid = self._scope_tids.get(scope)
        if tid is None:
            tid = self._scope_tids[scope] = len(self._scope_tids)
            if self.tracer is not None:
                self.tracer.metadata(PID_SCHED, "scheduler (wall clock)")
                self.tracer.metadata(PID_SCHED, scope or "qsch", tid=tid)
                self.tracer.metadata(PID_JOBS, "jobs (sim time)")
                self.tracer.metadata(PID_CLUSTER, "cluster (sim time)")
        return tid

    def _job_rec(self, job, scope: Optional[str]) -> JobRecord:
        key = (scope, job.uid)
        rec = self.jobs.get(key)
        if rec is None:
            rec = self.jobs[key] = JobRecord(
                uid=job.uid, tenant=job.tenant, kind=job.kind.name,
                n_gpus=job.n_gpus, submit_t=job.submit_time, scope=scope)
        return rec

    # -- spans / phases / cycles ---------------------------------------
    def phase(self, name: str) -> _Span:
        """A pipeline phase's span (``obs_phase``)."""
        return self._timer(None, name, True)

    def span(self, name: str, arg=None) -> _Span:
        """A span that is no pipeline phase (``obs_span``); ``arg`` is
        recorded under the name's key (``_SPAN_ARGS``)."""
        span = self._timer(None, name, False)
        span.arg = arg
        return span

    def _timer(self, scope: Optional[str], name: str,
               phase: bool) -> _Span:
        """Interned per (scope, name): reusing the context manager keeps
        the attached hot path allocation-free."""
        tmr = self._timers.get((scope, name))
        if tmr is None:
            tmr = self._timers[(scope, name)] = _Span(self, scope, name,
                                                      phase)
        return tmr

    def _open(self, name: str, tid: Optional[int], key: Optional[str],
              arg) -> None:
        # A garbage collection runs at the first check for pending work
        # after an allocation schedules it (a call).  The order here puts
        # every allocation and every call that can run one where a
        # collection nests under the right span in the trace and in the
        # self times alike: before the clock read, or after the span is
        # both on the stack and written.
        stack = self._stack
        if tid is None:
            tid = stack[-1][1] if stack else self._sched_tid(None)
        if name not in self._spans:
            self._spans[name] = [0, 0, 0]
        frame = [name, tid, 0, 0, False]
        frame[2] = t0 = perf_counter_ns()
        stack.append(frame)
        tr = self.tracer
        if tr is not None:
            frame[4] = tr.wall_begin(name, t0, tid, self._cycle_no, key, arg)

    def _close(self, args: Optional[Dict] = None) -> int:
        """Close the innermost span; returns its duration in ns."""
        t1 = perf_counter_ns()
        stack = self._stack
        name, tid, t0, children, written = stack.pop()
        dur = t1 - t0
        if stack:
            stack[-1][3] += dur
        acc = self._spans[name]
        acc[0] += dur - children
        acc[1] += dur
        acc[2] += 1
        if written:
            self.tracer.wall_end(name, t1, tid, args)
        return dur

    @property
    def span_self_s(self) -> Dict[str, float]:
        """Seconds of each span name less the time of its children."""
        return {k: v[0] / 1e9 for k, v in self._spans.items()}

    @property
    def span_total_s(self) -> Dict[str, float]:
        """Seconds of each span name, children included."""
        return {k: v[1] / 1e9 for k, v in self._spans.items()}

    @property
    def span_count(self) -> Dict[str, int]:
        """Closed spans of each name."""
        return {k: v[2] for k, v in self._spans.items()}

    def _on_gc(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._open("gc", None, "generation", info["generation"])
        elif self._stack and self._stack[-1][0] == "gc":
            self._close()

    def loop_open(self, scope: Optional[str] = None) -> None:
        """Open ``loop``: the event loop between two dispatches."""
        self._open("loop", self._sched_tid(scope), None, None)

    def loop_close(self) -> None:
        """Close ``loop`` if it is the innermost open span."""
        if self._stack and self._stack[-1][0] == "loop":
            self._close()

    # -- the score seam (core/scoring.py::_staged_pass) -----------------
    def seam_done(self, rows: int, up_bytes: int, down_bytes: int) -> None:
        """Tally a finished pass: its rows and the bytes each way."""
        tally = self._seam
        tally[0] += 1
        tally[1] += rows
        tally[2] += up_bytes
        tally[3] += down_bytes

    def _collect_seam(self, reg) -> None:
        for (name, help, labels), total, done in zip(
                _SEAM_COUNTERS, self._seam, self._seam_published):
            if total != done:
                reg.counter(name, help).inc(total - done, **labels)
        self._seam_published = list(self._seam)

    # -- tallied counters (``_TALLIED``) ---------------------------------
    def _tally(self, name: str, scope: Optional[str], labels: tuple) -> None:
        key = (name, scope, labels)
        self._tallies[key] = self._tallies.get(key, 0) + 1

    def pass_done(self, pool: str, placed: bool,
                  scope: Optional[str] = None) -> None:
        """Tally a finished pass of a placement plan
        (``core/rsch.py::_schedule``)."""
        self._tally("kant_placement_passes_total", scope,
                    (("pool", pool), ("placed", str(placed).lower())))

    def backfill_try(self, outcome: str,
                     scope: Optional[str] = None) -> None:
        """Tally Backfill's try of a job behind a blocked head
        (``core/framework/builtin.py::BackfillPolicy``)."""
        self._tally("kant_backfill_attempts_total", scope,
                    (("outcome", outcome),))

    def head_timeout(self, scope: Optional[str] = None) -> None:
        """Tally a cycle in which a head past its timeout ran its
        Preempt plugin."""
        self._tally("kant_head_timeouts_total", scope, ())

    def _collect_tallies(self, reg) -> None:
        for key, total in self._tallies.items():
            done = self._tallies_published.get(key, 0)
            if total != done:
                name, scope, labels = key
                reg.counter(name, _TALLIED[name]).inc(
                    total - done, **dict(labels), **self._labels(scope))
                self._tallies_published[key] = total

    def _phase_done(self, scope: Optional[str], name: str,
                    dt: float) -> None:
        self.phase_totals[name] = self.phase_totals.get(name, 0.0) + dt
        cyc = self._cycles.get(scope)
        if cyc is not None:
            ph = cyc["phases"]
            ph[name] = ph.get(name, 0.0) + dt

    def cycle_begin(self, now: float, scope: Optional[str] = None) -> None:
        self._simclock = float(now)
        self._cycles[scope] = {"t": float(now), "phases": {}}
        self._n_cycles += 1
        self._cycle_no = self._n_cycles
        self._open("cycle", self._sched_tid(scope), "t_sim", float(now))

    def cycle_end(self, result, ctx, scope: Optional[str] = None) -> None:
        cyc = self._cycles.pop(scope, None)
        if cyc is None:
            return
        wall = self._close({"scheduled": len(result.scheduled),
                            "preempted": len(result.preempted),
                            "requeues": result.requeues}) / 1e9
        self._cycle_no = None
        span = CycleSpan(t=cyc["t"], wall_s=wall, phases=cyc["phases"],
                         scope=scope, result=result)
        reg = self.registry
        if reg is not None:
            lbl = self._labels(scope)
            reg.counter("kant_cycles_total",
                        "QSCH scheduling cycles").inc(**lbl)
            if result.scheduled:
                reg.counter("kant_scheduled_total",
                            "jobs bound").inc(len(result.scheduled), **lbl)
                reg.counter("kant_pods_bound_total", "pods bound").inc(
                    sum(j.n_pods for j in result.scheduled), **lbl)
            if result.admit_rejected:
                reg.counter("kant_admit_rejected_total",
                            "static admission rejections").inc(
                    result.admit_rejected, **lbl)
            if result.infeasible:
                reg.counter("kant_infeasible_total",
                            "dynamic admission failures").inc(
                    result.infeasible, **lbl)
            if result.requeues:
                reg.counter("kant_requeues_total",
                            "requeue events").inc(result.requeues, **lbl)
            reg.histogram("kant_cycle_seconds",
                          "wall-clock cycle duration",
                          buckets=_CYCLE_BUCKETS).observe(wall, **lbl)
        for ob in self.observers:
            ob.on_cycle(span, ctx)

    # -- placement decisions (from QSCH) -------------------------------
    def emit_bind(self, job, sched, ctx,
                  scope: Optional[str] = None) -> None:
        decision = None
        if self.audit_on:
            capture = getattr(sched, "audit", None)
            decision = build_decision(job, capture, "bound", "ok",
                                      ctx.now, member=scope)
            # Stash the placement; decision.nodes derives lazily.
            decision._placement = sched.placement
        for ob in self.observers:
            ob.on_bind(job, decision, ctx)

    def emit_reject(self, job, sched, ctx, reason: str,
                    scope: Optional[str] = None) -> None:
        if self.registry is not None:
            self.registry.counter(
                "kant_placement_rejects_total",
                "placement attempts rejected, by reason").inc(
                reason=reason, **self._labels(scope))
        decision = None
        if self.audit_on:
            capture = getattr(sched, "audit", None) if sched is not None \
                else None
            decision = build_decision(job, capture, "rejected", reason,
                                      ctx.now, member=scope)
        for ob in self.observers:
            ob.on_reject(job, decision, ctx)

    def emit_preempt(self, victim, ctx, source,
                     scope: Optional[str] = None) -> None:
        plugin, beneficiary = (source if source is not None
                               else ("unknown", None))
        record = PreemptionRecord(
            victim_uid=victim.uid, victim_tenant=victim.tenant,
            victim_n_gpus=victim.n_gpus, beneficiary_uid=beneficiary,
            plugin=plugin, t=ctx.now, member=scope)
        rec = self._job_rec(victim, scope)
        rec.preemptions += 1
        if self.registry is not None:
            self.registry.counter(
                "kant_preemptions_total",
                "evictions by the preemption engine").inc(
                plugin=plugin, **self._labels(scope))
        if self.tracer is not None:
            self.tracer.instant("preempt", ctx.now * 1e6, PID_CLUSTER,
                                self._sched_tid(scope),
                                args={"victim": victim.uid,
                                      "beneficiary": beneficiary,
                                      "plugin": plugin})
        for ob in self.observers:
            ob.on_preempt(record, ctx)

    # -- event bus tap -------------------------------------------------
    def on_bus_event(self, event, scope: Optional[str] = None) -> None:
        self._simclock = event.t
        kind = event.kind.name
        self.event_counts[kind] = self.event_counts.get(kind, 0) + 1
        tr = self.tracer
        if tr is not None:
            if event.kind is EventKind.SUBMIT:
                job = event.payload
                rec = self._job_rec(job, scope)
                if not rec._span_open:
                    rec._span_open = True
                    self._sched_tid(scope)     # lane metadata
                    tr.begin(f"job-{job.uid}", event.t * 1e6, PID_JOBS,
                             job.uid, args={"tenant": job.tenant,
                                            "n_gpus": job.n_gpus,
                                            "kind": job.kind.name})
            elif event.kind not in (EventKind.END, EventKind.TICK,
                                    EventKind.SAMPLE):
                tr.instant(kind, event.t * 1e6, PID_CLUSTER,
                           self._sched_tid(scope),
                           args={"payload": repr(event.payload)})
        for ob in self.observers:
            ob.on_event(event, scope)

    # -- MetricsRecorder hooks -----------------------------------------
    def on_sample(self, sample, scope: Optional[str] = None) -> None:
        self._simclock = sample.t
        reg = self.registry
        if reg is not None:
            lbl = self._labels(scope)
            reg.gauge("kant_gar", "allocated/total GPUs").set(
                sample.gar, **lbl)
            reg.gauge("kant_gfr", "fragmented-node ratio").set(
                sample.gfr, **lbl)
            reg.gauge("kant_queue_depth", "pending jobs").set(
                sample.queue_depth, **lbl)
            reg.gauge("kant_allocated_gpus", "GPUs allocated").set(
                sample.allocated, **lbl)
            reg.gauge("kant_capacity_gpus", "allocatable GPUs").set(
                sample.capacity, **lbl)
            reg.gauge("kant_train_allocated_gpus",
                      "GPUs held by training jobs").set(
                sample.train_allocated, **lbl)
            reg.gauge("kant_infer_allocated_gpus",
                      "GPUs held by inference jobs").set(
                sample.infer_allocated, **lbl)
        for ob in self.observers:
            ob.on_sample(sample, scope)

    def on_job_placed(self, job, now: Optional[float],
                      scope: Optional[str] = None) -> None:
        t = float(now) if now is not None else (job.start_time or 0.0)
        rec = self._job_rec(job, scope)
        rec.binds += 1
        first = rec.first_start is None
        if first:
            rec.first_start = t
            if self.registry is not None:
                w = job.waiting_time
                if w is not None:
                    self.registry.histogram(
                        "kant_job_wait_seconds",
                        "queue wait until first bind").observe(
                        w, **self._labels(scope))
        if self.tracer is not None and rec._span_open:
            self.tracer.instant("bind" if first else "rebind",
                                t * 1e6, PID_JOBS, job.uid,
                                args={"attempt": job.attempt})
        for ob in self.observers:
            ob.on_job(job, "placed", t, scope)

    def on_job_finished(self, job,
                        scope: Optional[str] = None) -> None:
        rec = self._job_rec(job, scope)
        t = job.end_time if job.end_time is not None else self._simclock
        rec.end_t = t
        if self.registry is not None:
            self.registry.counter(
                "kant_jobs_completed_total", "jobs finished").inc(
                **self._labels(scope))
        if self.tracer is not None and rec._span_open:
            rec._span_open = False
            self.tracer.end(f"job-{job.uid}", t * 1e6, PID_JOBS,
                            job.uid, args={"interrupts": rec.interrupts,
                                           "binds": rec.binds})
        for ob in self.observers:
            ob.on_job(job, "finished", t, scope)

    def on_job_interrupted(self, job, t: float, lost: float,
                           overhead: float, reshape: bool,
                           scope: Optional[str] = None) -> None:
        rec = self._job_rec(job, scope)
        lbl = self._labels(scope)
        if reshape:
            rec.reshapes += 1
        else:
            rec.interrupts += 1
        if self.registry is not None:
            name = ("kant_reshapes_total" if reshape
                    else "kant_interrupts_total")
            help = ("voluntary checkpoint-boundary reshapes" if reshape
                    else "failure/drain interrupts")
            self.registry.counter(name, help).inc(**lbl)
        if self.tracer is not None and rec._span_open:
            self.tracer.instant("reshape" if reshape else "interrupt",
                                t * 1e6, PID_JOBS, job.uid,
                                args={"lost_s": lost,
                                      "overhead_s": overhead})
        for ob in self.observers:
            ob.on_job(job, "reshape" if reshape else "interrupted", t,
                      scope)

    # -- tuning hooks (repro_torch.core.tuning) ------------------------------
    def on_param_change(self, change,
                        scope: Optional[str] = None) -> None:
        """A tuning controller moved a registered handle: publish the
        new value as a Gauge, stamp a trace instant on the scheduler
        lane, and feed the observer chain (DecisionAudit keeps the
        ring-capped change log)."""
        self._simclock = max(self._simclock, change.t)
        if self.registry is not None:
            lbl = self._labels(scope)
            self.registry.gauge(
                "kant_tuned_param",
                "current value of a tuned scheduling parameter").set(
                change.value, param=change.param, **lbl)
            self.registry.counter(
                "kant_param_changes_total",
                "applied tuning parameter moves, by source").inc(
                source=change.source or "unknown", **lbl)
        if self.tracer is not None:
            self.tracer.instant("param-change", change.t * 1e6,
                                PID_CLUSTER, self._sched_tid(scope),
                                args={"param": change.param,
                                      "previous": change.previous,
                                      "value": change.value,
                                      "source": change.source})
        for ob in self.observers:
            ob.on_param_change(change, scope)

    # -- run lifecycle -------------------------------------------------
    def finalize_run(self, sim, scope: Optional[str] = None) -> None:
        self._simclock = max(self._simclock, sim.now)
        self.loop_close()
        self._unhook()
        if self.tracer is not None:
            # Horizon cuts / still-pending jobs: close their spans so
            # the trace stays balanced and loadable.
            self.tracer.close_all(sim.now * 1e6)
            for rec in self.jobs.values():
                rec._span_open = False
        if self.registry is not None:
            self.registry.collect()
        for ob in self.observers:
            ob.on_run_end(sim, scope)

    # -- external collectors -------------------------------------------
    @staticmethod
    def _collect_combo_caches(reg) -> None:
        for name, st in cache_stats().items():
            reg.gauge("combo_cache_hits",
                      "dry-run combo cache hits").set(st["hits"],
                                                      cache=name)
            reg.gauge("combo_cache_misses",
                      "dry-run combo cache misses").set(st["misses"],
                                                        cache=name)
            reg.gauge("combo_cache_entries",
                      "dry-run combo cache size").set(st["size"],
                                                      cache=name)

    # -- export --------------------------------------------------------
    def job_records(self) -> List[Dict[str, object]]:
        return [r.as_dict() for r in self.jobs.values()]

    def bundle(self) -> Dict[str, object]:
        """The complete telemetry bundle (input of repro_torch.obs.report)."""
        out: Dict[str, object] = {
            "meta": {
                # The reference package's format: a bundle of either
                # package renders with either report tool.
                "format": "repro.obs/1",
                "pillars": {"registry": self.registry is not None,
                            "tracing": self.tracer is not None,
                            "audit": self.audit is not None},
                "sim_end_t": self._simclock,
            },
            "events": dict(self.event_counts),
            "phase_totals": dict(self.phase_totals),
            "jobs": self.job_records(),
        }
        if self.registry is not None:
            out["metrics"] = self.registry.to_json()
        if self.tracer is not None:
            out["trace"] = self.tracer.to_json()
        if self.audit is not None:
            out["audit"] = self.audit.to_json()
        return out

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.bundle(), f, default=float)
        return path

    def save_trace(self, path: str) -> str:
        if self.tracer is None:
            raise ValueError("tracing pillar is disabled")
        return self.tracer.save(path)
