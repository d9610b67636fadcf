"""TuningManager: wires controllers into a simulator's event stream.

The manager is the tuning analogue of ``repro_torch.obs.Telemetry.attach``:
it binds a :class:`~repro_torch.core.tuning.params.ParamSpace` over one
simulator stack (QSCH knobs + profile fused weights + optional GSCH
deadline), subscribes TICK/SAMPLE handlers on the simulator's event
bus *after* the built-ins (so a cycle's placements and the cycle's
metric sample are already recorded when the manager observes them),
and invokes each attached :class:`~repro_torch.core.framework.api.
ControllerPlugin` on its control-period cadence with a
:class:`TuningWindow` — the windowed GFR/JWTD/GAR/SOR aggregate the
frontier objective is computed from.

Every applied parameter move flows back out through the obs facade
(``Telemetry.on_param_change``): a Gauge per tuned parameter, a trace
instant on the scheduler track, and a DecisionAudit record — the
tuning loop is itself observable.

Transfer (Sliwko direction): :meth:`TuningManager.export_profile`
snapshots the tuned operating point as a
:class:`~repro_torch.core.tuning.profile.TuningProfile`;
:meth:`TuningManager.warm_start` force-applies a donor profile and
lets each controller seed its search state from it, so a new
federation member starts *at* the tuned point instead of re-learning
it (gated in ``benchmarks/tuning_bench.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..events import Event, EventKind
from ..metrics import Sample
from .params import ParamChange, ParamSpace, bind_simulator
from .profile import TuningProfile


@dataclasses.dataclass(frozen=True)
class ObjectiveWeights:
    """Weights of the frontier objective (higher objective = better).

    ``wait_scale`` normalizes the P90 waiting-time term to the same
    order of magnitude as the rate metrics (seconds; default 1 hour)."""

    gar: float = 1.0
    sor: float = 1.0
    gfr: float = 1.0          # subtracted: fragmentation is a cost
    wait: float = 1.0         # subtracted: waiting is a cost
    wait_scale: float = 3600.0


@dataclasses.dataclass
class TuningWindow:
    """One control period's observations: the raw samples that landed in
    ``[t0, t1)`` plus the waiting times of jobs that *started* in it."""

    t0: float
    t1: float
    samples: List[Sample] = dataclasses.field(default_factory=list)
    waits: List[float] = dataclasses.field(default_factory=list)

    def mean_gar(self) -> float:
        return float(np.mean([s.gar for s in self.samples])) \
            if self.samples else float("nan")

    def mean_gfr(self) -> float:
        return float(np.mean([s.gfr for s in self.samples])) \
            if self.samples else float("nan")

    def sor(self) -> float:
        """Window SOR approximation: Σallocated / Σcapacity over the
        window's equally-spaced samples."""
        cap = sum(s.capacity for s in self.samples)
        if cap <= 0:
            return float("nan")
        return sum(s.allocated for s in self.samples) / cap

    def p90_wait(self) -> float:
        return float(np.percentile(self.waits, 90.0)) if self.waits \
            else float("nan")

    def mean_queue_depth(self) -> float:
        return float(np.mean([s.queue_depth for s in self.samples])) \
            if self.samples else float("nan")


def frontier_objective(window: TuningWindow,
                       weights: Optional[ObjectiveWeights] = None
                       ) -> float:
    """Scalarized multi-objective score of one window (higher = better).

    NaN terms (no samples / no starts in the window) contribute zero
    rather than poisoning the sum — an idle window scores 0, not NaN."""
    w = weights or ObjectiveWeights()
    total = 0.0
    for value, weight in ((window.mean_gar(), w.gar),
                          (window.sor(), w.sor),
                          (window.mean_gfr(), -w.gfr),
                          (window.p90_wait() / w.wait_scale, -w.wait)):
        if not math.isnan(value):
            total += weight * value
    return total


class TuningManager:
    """Owns the ParamSpace and drives controllers over one simulator.

    ``attach`` may be called once per manager; use one manager per
    federation member (each gets its own space and window state)."""

    def __init__(self, controllers: Sequence = (),
                 objective: Optional[ObjectiveWeights] = None,
                 control_period_s: Optional[float] = None) -> None:
        self.controllers = list(controllers)
        self.objective = objective or ObjectiveWeights()
        if control_period_s is None and self.controllers:
            control_period_s = min(c.control_period_s
                                   for c in self.controllers)
        self.control_period_s = control_period_s or 1800.0
        self.space = ParamSpace()
        self.space.on_change = self._emit_change
        #: (window_end_time, objective) per completed control period.
        self.history: List[Tuple[float, float]] = []
        #: ParamSpace snapshot at the END of each control period — the
        #: parameter trajectory (warm-start convergence is measured on
        #: the distance of these to a donor profile).
        self.period_snapshots: List[Dict[str, float]] = []
        self.periods = 0
        self._sim = None
        self._scope: Optional[str] = None
        self._window: Optional[TuningWindow] = None
        self._next_control: Optional[float] = None
        self._seen_starts: set = set()
        self.now = 0.0

    # ------------------------------------------------------------------
    def attach(self, sim, scope: Optional[str] = None,
               gsch=None) -> "TuningManager":
        """Bind the tunable surface of ``sim`` and start consuming its
        Tick/Sample stream.  ``scope`` labels emitted telemetry (the
        federation member name); ``gsch`` additionally registers the
        spillover-deadline handle."""
        if self._sim is not None:
            raise RuntimeError("TuningManager is already attached")
        self._sim = sim
        self._scope = scope
        bind_simulator(self.space, sim, gsch=gsch)
        # Subscribed after Simulator._register_builtins: the manager's
        # handlers observe post-cycle, post-sample state.
        sim.bus.subscribe(EventKind.TICK, self._on_tick)
        sim.bus.subscribe(EventKind.SAMPLE, self._on_sample)
        for c in self.controllers:
            c.bind(self.space, self)
        return self

    def _emit_change(self, change: ParamChange) -> None:
        obs = getattr(self._sim, "obs", None) if self._sim is not None \
            else None
        if obs is not None:
            obs.on_param_change(change)

    # ------------------------------------------------------------------
    # Event handlers (run after the simulator built-ins)
    # ------------------------------------------------------------------
    def _on_tick(self, ev: Event) -> None:
        self.now = ev.t
        sim = self._sim
        if self._window is None:
            self._window = TuningWindow(t0=ev.t, t1=ev.t)
            self._next_control = ev.t + self.control_period_s
        # Harvest waiting times of jobs that started since the last
        # tick.  Keyed by (uid, start_time) so a preempted-and-restarted
        # job's new wait is counted again.
        for job in sim.qsch.running.values():
            if job.start_time is None:
                continue
            key = (job.uid, job.start_time)
            if key in self._seen_starts:
                continue
            self._seen_starts.add(key)
            w = job.waiting_time
            if w is not None:
                self._window.waits.append(float(w))
        for c in self.controllers:
            c.on_tick(ev.t, sim.qsch, self.space)
        if ev.t >= self._next_control:
            self._fire_control(ev.t)

    def _on_sample(self, ev: Event) -> None:
        if self._window is None:
            self._window = TuningWindow(t0=ev.t, t1=ev.t)
            self._next_control = ev.t + self.control_period_s
        metrics = self._sim.metrics
        if metrics.samples:
            # The built-in SAMPLE handler appended this event's sample
            # before this handler ran (subscription order).
            self._window.samples.append(metrics.samples[-1])

    def _fire_control(self, t: float) -> None:
        window = self._window
        window.t1 = t
        score = frontier_objective(window, self.objective)
        self.history.append((t, score))
        self.periods += 1
        for c in self.controllers:
            c.control(window, self.space)
        self.period_snapshots.append(self.space.snapshot())
        self._window = TuningWindow(t0=t, t1=t)
        self._next_control = t + self.control_period_s

    # ------------------------------------------------------------------
    # Transfer (Sliwko direction)
    # ------------------------------------------------------------------
    def export_profile(self, name: str) -> TuningProfile:
        """Snapshot the current operating point as a transferable
        profile (parameter dict + last objective)."""
        objective = self.history[-1][1] if self.history else None
        return TuningProfile(
            name=name, params=self.space.snapshot(), objective=objective,
            meta={"scope": self._scope or "",
                  "periods": self.periods,
                  "n_params": len(self.space)})

    def warm_start(self, profile: TuningProfile) -> List[str]:
        """Seed this stack from a donor profile: force-apply the
        parameter intersection, then let each controller adopt the
        donor's search state.  Returns the donor parameter names that
        had no local handle (differently-shaped donor cluster)."""
        skipped = self.space.apply(profile.params, now=self.now,
                                   source=f"warm-start:{profile.name}")
        for c in self.controllers:
            c.warm_start(profile, self.space)
        return skipped
