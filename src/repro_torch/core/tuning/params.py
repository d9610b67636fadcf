"""Tunable parameter handles: the ParamSpace contract.

Every hand-set scheduling constant Kant's Table-1 profiles carry —
fused score weights, the preemption budget, the backfill head timeout,
the federation spillover deadline, the starvation-escalation threshold
— becomes a *registered handle* in a :class:`ParamSpace`: a named
getter/setter pair with declared bounds, a per-move change-rate limit
and an integer flag.  Controllers (:mod:`repro_torch.core.tuning.controllers`)
only ever write through :meth:`ParamSpace.set`, which

* clamps the requested value into ``[lo, hi]``,
* rate-limits the move to ``max_step`` per call (``force=True``
  bypasses the rate limit for warm-starts and reverts, never the
  bounds),
* rounds integer handles,
* drops no-op writes (same effective value -> nothing recorded), and
* on a real change appends a :class:`ParamChange` record and notifies
  the attached observability sink (Gauge + trace instant +
  DecisionAudit entry via ``Telemetry.on_param_change``).

This is what makes profiles *live-reconfigurable* instead of
constructor-frozen: :class:`~repro_torch.core.framework.builtin.WeightSetScore`
re-reads ``self.weights`` on every ``fused_weights`` call, QSCH re-reads
its config every preemption chain, the Backfill policy re-reads
``head_timeout`` every cycle, and the GSCH re-reads
``spill_deadline_s`` every spillover scan — so a handle write takes
effect at the next cycle with zero hot-path cost.

The binding helpers (:func:`bind_qsch`, :func:`bind_profile_weights`,
:func:`bind_simulator`, :func:`bind_gsch`) are **read-only probes**:
they enumerate a profile's placement passes with representative jobs,
register handles for every discovered :class:`WeightSetScore` term, and
never mutate anything — an attached-but-silent controller stays
byte-identical to a detached run (gated in
``benchmarks/tuning_bench.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from ..framework.builtin import BackfillPolicy, WeightSetScore
from ..job import Job, JobKind
from ..scoring import ScoreWeights


@dataclasses.dataclass(frozen=True)
class ParamChange:
    """One applied parameter move (the audit record)."""

    param: str
    t: float
    previous: float
    value: float
    source: str = ""

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TunableParam:
    """One registered handle: getter/setter + envelope."""

    name: str
    get: Callable[[], float]
    set: Callable[[float], None]
    lo: float
    hi: float
    #: Largest move one (non-forced) ``ParamSpace.set`` may apply.
    max_step: float
    integer: bool = False

    def clamp(self, value: float, *, force: bool = False) -> float:
        """The effective value a write of ``value`` would land at."""
        v = min(self.hi, max(self.lo, float(value)))
        if not force:
            cur = float(self.get())
            lo = cur - self.max_step
            hi = cur + self.max_step
            v = min(hi, max(lo, v))
            # The rate-limit window may poke outside the bounds when the
            # current value sits at an edge; bounds always win.
            v = min(self.hi, max(self.lo, v))
        if self.integer:
            v = float(int(round(v)))
        return v


class ParamSpace:
    """The registered tunable surface of one scheduler stack.

    ``on_change`` (set by the :class:`~repro_torch.core.tuning.manager.
    TuningManager` at attach time) receives every applied
    :class:`ParamChange` — that is the hook through which changes reach
    the obs registry, the tracer and the decision audit."""

    def __init__(self) -> None:
        self._params: Dict[str, TunableParam] = {}
        self.changes: List[ParamChange] = []
        self.on_change: Optional[Callable[[ParamChange], None]] = None

    # -- registration --------------------------------------------------
    def register(self, name: str, get: Callable[[], float],
                 set: Callable[[float], None], lo: float, hi: float,
                 max_step: float, integer: bool = False) -> TunableParam:
        if name in self._params:
            raise ValueError(f"tunable {name!r} already registered")
        if not (lo <= hi):
            raise ValueError(f"tunable {name!r}: lo {lo} > hi {hi}")
        p = TunableParam(name=name, get=get, set=set, lo=lo, hi=hi,
                         max_step=float(max_step), integer=integer)
        self._params[name] = p
        return p

    def names(self) -> List[str]:
        return sorted(self._params)

    def __contains__(self, name: str) -> bool:
        return name in self._params

    def __len__(self) -> int:
        return len(self._params)

    def param(self, name: str) -> TunableParam:
        return self._params[name]

    # -- reads ---------------------------------------------------------
    def get(self, name: str) -> float:
        return float(self._params[name].get())

    def snapshot(self) -> Dict[str, float]:
        """Current value of every handle (TuningProfile payload)."""
        return {name: self.get(name) for name in self.names()}

    # -- writes --------------------------------------------------------
    def set(self, name: str, value: float, now: float = 0.0,
            source: str = "", force: bool = False) -> float:
        """Apply a bounded, rate-limited write; returns the effective
        value.  A write that lands on the current value is a no-op:
        nothing is stored, nothing is notified."""
        p = self._params[name]
        prev = float(p.get())
        v = p.clamp(value, force=force)
        if v == prev:
            return prev
        p.set(v)
        change = ParamChange(param=name, t=float(now), previous=prev,
                             value=v, source=source)
        self.changes.append(change)
        if self.on_change is not None:
            self.on_change(change)
        return v

    def apply(self, values: Dict[str, float], now: float = 0.0,
              source: str = "warm-start") -> List[str]:
        """Force-apply a parameter dict (warm-start / transfer path).
        Unknown names are skipped and returned — a donor profile from a
        differently-shaped cluster warm-starts the intersection."""
        skipped = []
        for name, value in sorted(values.items()):
            if name in self._params:
                self.set(name, value, now=now, source=source, force=True)
            else:
                skipped.append(name)
        return skipped


# ----------------------------------------------------------------------
# Binding helpers: enumerate a stack's tunable surface
# ----------------------------------------------------------------------
class _FakeZoneSnap:
    """Minimal snapshot stand-in for plan probing.

    Profile ``plan(job, snap)`` closures only consult
    ``snap.inference_zone.any()`` (the §3.3.4 zone dance); probing with
    both zone states enumerates every branch without touching cluster
    state."""

    def __init__(self, has_zone: bool) -> None:
        self.inference_zone = np.asarray([has_zone])


def _probe_jobs() -> List[Job]:
    """Representative jobs covering every plan branch: training gang,
    small inference pod (dedicated zone), large inference pod, debug."""
    return [
        Job(uid=-1, tenant="_probe", gpu_type=0, n_pods=2, gpus_per_pod=8,
            kind=JobKind.TRAIN),
        Job(uid=-2, tenant="_probe", gpu_type=0, n_pods=1, gpus_per_pod=1,
            kind=JobKind.INFER, gang=False),
        Job(uid=-3, tenant="_probe", gpu_type=0, n_pods=1, gpus_per_pod=8,
            kind=JobKind.INFER, gang=False),
        Job(uid=-4, tenant="_probe", gpu_type=0, n_pods=1, gpus_per_pod=1,
            kind=JobKind.DEBUG, gang=False),
    ]


def iter_profile_weight_plugins(profiles):
    """Yield ``(profile_name, plugin)`` for every distinct
    :class:`WeightSetScore` instance reachable through the profile
    set's plan closures (deduplicated by identity — espread plans share
    scorer instances across passes)."""
    seen = set()
    snaps = (_FakeZoneSnap(False), _FakeZoneSnap(True))
    jobs = _probe_jobs()
    for profile in (profiles.train, profiles.inference,
                    profiles.best_effort):
        for job in jobs:
            for snap in snaps:
                try:
                    passes = profile.plan(job, snap)
                except Exception:
                    # A custom plan inspecting more of the snapshot than
                    # the zone mask: skip the branch, keep the rest.
                    continue
                for p in passes:
                    for scorer in p.scorers:
                        if not isinstance(scorer, WeightSetScore):
                            continue
                        if id(scorer) in seen:
                            continue
                        seen.add(id(scorer))
                        yield profile.name, scorer


def _weight_setter(plugin: WeightSetScore, field: str
                   ) -> Callable[[float], None]:
    def setter(v: float) -> None:
        plugin.weights = dataclasses.replace(plugin.weights,
                                             **{field: float(v)})
    return setter


def _weight_getter(plugin: WeightSetScore, field: str
                   ) -> Callable[[], float]:
    def getter() -> float:
        return float(getattr(plugin.weights, field))
    return getter


def bind_profile_weights(space: ParamSpace, profiles,
                         prefix: str = "") -> List[str]:
    """Register a handle per nonzero fused-weight term of every
    :class:`WeightSetScore` in the profile set.

    Bounds are sign-preserving — ``[0, 4w]`` for positive terms,
    ``[4w, 0]`` for negative ones — so tuning can rescale a term's
    strength but never flip its semantics (a binpack term cannot become
    a spread term under the controller's feet); ``max_step`` is 25% of
    the initial magnitude per move."""
    registered: List[str] = []
    counts: Dict[str, int] = {}
    for profile_name, plugin in iter_profile_weight_plugins(profiles):
        base = f"{prefix}{profile_name}.{plugin.name}"
        counts[base] = counts.get(base, 0) + 1
        if counts[base] > 1:
            # Two same-named plugin instances in one profile (e.g. the
            # espread general/general-zone pass pair): disambiguate.
            base = f"{base}#{counts[base]}"
        for field in ("used", "fit", "group", "topo"):
            w = float(getattr(plugin.weights, field))
            if w == 0.0:
                continue
            lo, hi = (0.0, 4.0 * w) if w > 0 else (4.0 * w, 0.0)
            name = f"{base}.{field}"
            space.register(name, _weight_getter(plugin, field),
                           _weight_setter(plugin, field), lo=lo, hi=hi,
                           max_step=0.25 * abs(w))
            registered.append(name)
    return registered


def bind_qsch(space: ParamSpace, qsch, prefix: str = "") -> List[str]:
    """Register the QSCH-level handles: the per-cycle preemption budget
    and (when the queue policy is Backfill) the head timeout."""
    registered: List[str] = []
    cfg = qsch.config

    name = f"{prefix}qsch.max_preemptions_per_cycle"
    budget0 = int(cfg.max_preemptions_per_cycle)

    def get_budget() -> float:
        return float(cfg.max_preemptions_per_cycle)

    def set_budget(v: float) -> None:
        cfg.max_preemptions_per_cycle = int(v)

    space.register(name, get_budget, set_budget, lo=0.0,
                   hi=float(max(4 * budget0, 16)),
                   max_step=float(max(budget0 // 4, 4)), integer=True)
    registered.append(name)

    policy = qsch.queue_policy
    if isinstance(policy, BackfillPolicy):
        name = f"{prefix}qsch.backfill_head_timeout"
        t0 = float(policy.head_timeout)

        def get_timeout() -> float:
            return float(policy.head_timeout)

        def set_timeout(v: float) -> None:
            # The config mirror keeps introspection (and any re-built
            # policy) consistent with the live plugin.
            policy.head_timeout = float(v)
            cfg.backfill_head_timeout = float(v)

        space.register(name, get_timeout, set_timeout,
                       lo=max(60.0, 0.125 * t0), hi=4.0 * t0,
                       max_step=0.25 * t0)
        registered.append(name)
    return registered


def bind_gsch(space: ParamSpace, gsch, prefix: str = "gsch."
              ) -> List[str]:
    """Register the federation-level spillover deadline."""
    cfg = gsch.config
    d0 = float(cfg.spill_deadline_s)
    name = f"{prefix}spill_deadline_s"

    def get_deadline() -> float:
        return float(cfg.spill_deadline_s)

    def set_deadline(v: float) -> None:
        cfg.spill_deadline_s = float(v)

    space.register(name, get_deadline, set_deadline,
                   lo=max(60.0, 0.125 * d0), hi=4.0 * d0,
                   max_step=0.25 * d0)
    return [name]


def bind_simulator(space: ParamSpace, sim, prefix: str = "",
                   gsch=None) -> List[str]:
    """The standard binding for one simulator stack: QSCH knobs + every
    profile fused-weight term (+ the GSCH deadline when routing through
    a federation)."""
    registered = bind_qsch(space, sim.qsch, prefix=prefix)
    registered += bind_profile_weights(space, sim.qsch.rsch.profiles,
                                       prefix=prefix)
    if gsch is not None:
        registered += bind_gsch(space, gsch, prefix=f"{prefix}gsch.")
    return registered
