"""Built-in controllers: guarded hill-climb + starvation escalator.

Three :class:`~repro_torch.core.framework.api.ControllerPlugin` implementations
registered in the plugin registry like any Score/Policy plugin:

* :class:`NoOpController` — attaches, observes, never writes.  The
  parity baseline: an attached NoOpController must leave the run
  byte-identical to a detached one (tests + tuning_bench gate (a)).
* :class:`HillClimbController` — Mamirov-style dynamic multi-objective
  adaptation as a guarded epsilon-greedy hill climb: each control
  period it either *measures* (judging the previous probe against the
  pre-probe baseline with absolute hysteresis, reverting on
  regression) or *probes* (one bounded, rate-limited move on one
  parameter).  One-move-at-a-time keeps credit assignment unambiguous;
  revert-on-regression bounds the damage of any probe to one window.
* :class:`StarvationEscalator` — Mamirov's starvation counter-measure:
  long-waiting queued gangs get their effective priority raised (up to
  ``PRIO_HIGH``) so size/FIFO ordering cannot starve them forever.
  Its wait threshold is itself a registered tunable handle, so the
  hill climb can tune the escalator.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from ..framework.api import ControllerPlugin
from ..framework.registry import register
from ..job import PRIO_HIGH
from .manager import ObjectiveWeights, TuningWindow, frontier_objective
from .params import ParamSpace
from .profile import TuningProfile


@register
class NoOpController(ControllerPlugin):
    """Observes every window, never touches a handle — the attached-run
    byte-identity baseline."""

    name = "NoOpController"

    def __init__(self) -> None:
        self.windows_seen = 0
        self.ticks_seen = 0

    def on_tick(self, now, sched, space) -> None:
        self.ticks_seen += 1

    def control(self, window, space) -> None:
        self.windows_seen += 1


@register
class HillClimbController(ControllerPlugin):
    """Guarded epsilon-greedy hill climb over the registered handles.

    Lifecycle per control period (``control_period_s`` simulated
    seconds):

    1. **First window** measures the static baseline — no write.
    2. If a probe is outstanding, judge it: keep the move when the
       window's frontier objective beats the baseline by at least
       ``hysteresis`` (absolute), else force-revert to the pre-probe
       value.  Arm statistics record the outcome either way.
    3. Pick the next arm — one ``(parameter, direction)`` pair —
       epsilon-greedy on observed win rate (optimistic for untried
       arms), and apply a single rate-limited step.

    ``params`` restricts tuning to a name subset (prefix match), e.g.
    ``["train-e-binpack."]`` tunes only the training profile's weights.
    ``warm_start`` adopts a donor profile's objective as the initial
    baseline, so the climb continues *from* the transferred operating
    point instead of re-measuring and re-walking to it."""

    name = "HillClimbController"
    control_period_s = 1800.0

    def __init__(self, objective: Optional[ObjectiveWeights] = None,
                 seed: int = 0, epsilon: float = 0.25,
                 hysteresis: float = 0.01,
                 params: Optional[Sequence[str]] = None) -> None:
        self.objective = objective
        self.epsilon = float(epsilon)
        self.hysteresis = float(hysteresis)
        self.param_prefixes = list(params) if params is not None else None
        self.rng = random.Random(seed)
        self.baseline: Optional[float] = None
        self.moves = 0
        self.accepts = 0
        self.reverts = 0
        self._pending: Optional[Tuple[Tuple[str, int], float]] = None
        self._arms: List[Tuple[str, int]] = []
        # arm -> [tries, wins]
        self._stats: Dict[Tuple[str, int], List[int]] = {}

    # -- lifecycle -----------------------------------------------------
    def bind(self, space: ParamSpace, manager) -> None:
        if self.objective is None:
            self.objective = manager.objective
        self._arms = [(name, direction)
                      for name in space.names()
                      if self._tunes(name)
                      for direction in (+1, -1)]

    def _tunes(self, name: str) -> bool:
        if self.param_prefixes is None:
            return True
        return any(name.startswith(p) for p in self.param_prefixes)

    def warm_start(self, profile: TuningProfile, space: ParamSpace
                   ) -> None:
        # Parameters were already force-applied by the manager; adopting
        # the donor's objective as baseline makes the next window judge
        # against the transferred operating point.
        if profile.objective is not None:
            self.baseline = float(profile.objective)

    # -- control -------------------------------------------------------
    def control(self, window: TuningWindow, space: ParamSpace) -> None:
        score = frontier_objective(window, self.objective)
        if math.isnan(score):
            return
        if self.baseline is None:
            self.baseline = score        # first window: establish baseline
        elif self._pending is not None:
            arm, prev = self._pending
            self._pending = None
            stats = self._stats.setdefault(arm, [0, 0])
            stats[0] += 1
            if score >= self.baseline + self.hysteresis:
                stats[1] += 1
                self.accepts += 1
                self.baseline = score
            else:
                space.set(arm[0], prev, now=window.t1,
                          source=f"{self.name}:revert", force=True)
                self.reverts += 1
            return                        # next window measures clean
        self._probe(window.t1, space)

    def _probe(self, now: float, space: ParamSpace) -> None:
        if not self._arms:
            return
        arm = self._pick_arm()
        name, direction = arm
        p = space.param(name)
        prev = space.get(name)
        applied = space.set(name, prev + direction * p.max_step,
                            now=now, source=self.name)
        if applied != prev:
            self.moves += 1
            self._pending = (arm, prev)
        else:
            # Pinned at a bound: record a loss so the greedy choice
            # stops re-picking a dead arm.
            stats = self._stats.setdefault(arm, [0, 0])
            stats[0] += 1

    def _pick_arm(self) -> Tuple[str, int]:
        if self.rng.random() < self.epsilon:
            return self.rng.choice(self._arms)

        def win_rate(arm: Tuple[str, int]) -> float:
            tries, wins = self._stats.get(arm, (0, 0))
            return 1.0 if tries == 0 else wins / tries   # optimistic

        best = max(win_rate(a) for a in self._arms)
        candidates = [a for a in self._arms if win_rate(a) == best]
        return self.rng.choice(candidates)


@register
class StarvationEscalator(ControllerPlugin):
    """Raise the effective queue priority of long-waiting jobs.

    Every tick it scans the tenant queues; a job that has waited longer
    than ``wait_threshold_s`` gets ``boost`` added to its priority
    (capped at ``PRIO_HIGH``), at most once per
    ``escalation_period_s`` per job — repeated escalation walks a
    starving gang up the admission order one bounded step at a time.
    The threshold registers as a tunable handle
    (``escalator.wait_threshold_s``), so an outer controller can tune
    how aggressive starvation relief is."""

    name = "StarvationEscalator"
    control_period_s = 1800.0

    def __init__(self, wait_threshold_s: float = 3600.0,
                 boost: int = 10,
                 escalation_period_s: float = 1800.0) -> None:
        self.wait_threshold_s = float(wait_threshold_s)
        self.boost = int(boost)
        self.escalation_period_s = float(escalation_period_s)
        self.escalations = 0
        self._last_boost: Dict[int, float] = {}

    def bind(self, space: ParamSpace, manager) -> None:
        t0 = self.wait_threshold_s

        def get_threshold() -> float:
            return self.wait_threshold_s

        def set_threshold(v: float) -> None:
            self.wait_threshold_s = float(v)

        space.register("escalator.wait_threshold_s", get_threshold,
                       set_threshold, lo=max(60.0, 0.125 * t0),
                       hi=4.0 * t0, max_step=0.25 * t0)

    def on_tick(self, now: float, sched, space: ParamSpace) -> None:
        for queue in sched.queues.values():
            for job in queue:
                if job.priority >= PRIO_HIGH:
                    continue
                if now - job.submit_time < self.wait_threshold_s:
                    continue
                last = self._last_boost.get(job.uid)
                if last is not None \
                        and now - last < self.escalation_period_s:
                    continue
                job.priority = min(PRIO_HIGH, job.priority + self.boost)
                self._last_boost[job.uid] = now
                self.escalations += 1
