"""Extension-point plugin API (the framework's contract).

The scheduling pipeline exposes one extension point per decision the
paper's QSCH/RSCH make; a plugin implements exactly one point:

==============  ======================================================
QueueSort       ordering of the global pending queue (§3.2.2)
Admit           static (quota, §3.2.1) and dynamic (feasibility)
                admission; ``stage`` selects when the plugin runs
Filter          vectorized node filtering: a boolean mask over the
                snapshot's node table (§3.4.1 node pools)
Score           vectorized node scoring: either *fused weights* into
                the shared filter+score kernel pass, an additive float
                term over the node table, or a pod-dependent
                per-extra-pod bonus (§3.3.3/§3.3.4)
Reserve/Permit  transactional gang commit: Reserve claims bookkeeping
                (quota), Permit may veto; any failure rolls back
                every successful Reserve (§3.3.2 all-or-nothing)
PostBind        fire-and-forget hook after a placement is bound
Preempt         victim selection for the conservative preemption
                engine (§3.2.3)
QueuePolicy     the cycle body: Strict FIFO / Best-Effort / Backfill
                (Table 1)
Dynamics        cluster dynamics (failure injection, drain windows,
                autoscaling) driven through the simulator's event bus
ClusterSelect   federation-level routing (repro_torch.core.federation): which
                member cluster a job lands in, vectorized over the
                per-cluster summary matrix
RouterPolicy    query-level routing (repro_torch.serve): which model replica
                serves an individual request, one level below
                ClusterSelect
ElasticPolicy   scheduler × parallelism co-design (repro_torch.core.elastic):
                which declared parallelism plan an elastic training job
                runs at — shrink into fragmented capacity at placement,
                grow back at a checkpoint boundary
Observer        telemetry taps (repro_torch.obs): cycle spans, placement /
                rejection decisions with filter+score attribution,
                preemption rationale, and every simulator bus event —
                strictly read-only, fed by the Telemetry facade
Controller      online parameter control (repro_torch.core.tuning): consumes
                the Sample/Tick stream on a control-period cadence and
                adjusts registered tunable handles (score weights,
                preemption budgets, timeouts) through a bounded,
                rate-limited ParamSpace — the metrics→parameters loop
==============  ======================================================

**Score plugin contract** — every Score plugin declares whether its term
is *snapshot-static* (depends only on the snapshot, not on pods of the
job placed earlier in the same gang) or *pod-dependent*:

* snapshot-static terms either return :class:`ScoreWeights` from
  :meth:`ScorePlugin.fused_weights` (combined into ONE fused
  filter+score pass so the numpy/torch/CUDA backends and the batched
  slot-chain gang selection are preserved) or a float array from
  :meth:`ScorePlugin.score` that is added onto the fused result;
* pod-dependent terms (``pod_dependent = True``) contribute a scalar
  per-extra-pod bonus via :meth:`ScorePlugin.per_pod_bonus`, folded
  into the per-node slot chains of
  :func:`repro_torch.core.scoring.select_gang_slots` — the only
  pod-dependence the exact batched emulation supports is this linear
  same-node bonus (what ColocateBonus needs).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import (TYPE_CHECKING, Callable, ClassVar, List, Mapping,
                    Optional, Sequence, Tuple)

import numpy as np

from ..events import EventKind
from ..job import Job, JobKind, Placement
from ..scoring import ScoreWeights
from ..snapshot import Snapshot

if TYPE_CHECKING:  # avoid import cycles: qsch/rsch import this module
    from ..cluster import ClusterState
    from ..qsch import QSCH
    from ..quota import QuotaManager
    from ..rsch import RSCH


class Plugin:
    """Base for every extension-point plugin.

    ``name`` is the registry key (see
    :mod:`repro_torch.core.framework.registry`); instances may carry
    constructor parameters (weights, timeouts, ...).
    """

    name: ClassVar[str] = "plugin"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self.name!r}>"


# ----------------------------------------------------------------------
# Contexts
# ----------------------------------------------------------------------
@dataclasses.dataclass
class SchedulingContext:
    """What a placement computation may consult beyond the snapshot.

    RSCH stays pure — plugins read this context, they never mutate
    cluster state through it.  ``running`` maps job uid -> running Job
    (used e.g. by tenant-affinity scoring); standalone callers of
    ``RSCH.schedule`` can pass their own.
    """

    running: Mapping[int, Job] = dataclasses.field(default_factory=dict)
    quota: Optional["QuotaManager"] = None


@dataclasses.dataclass
class CycleResult:
    """Outcome of one QSCH scheduling cycle (returned by ``cycle``)."""

    scheduled: List[Job] = dataclasses.field(default_factory=list)
    preempted: List[Job] = dataclasses.field(default_factory=list)
    blocked_head: Optional[Job] = None
    snapshot_version: int = 0
    # Why jobs waited (policy-experiment accounting): jobs excluded from
    # the global pass by static admission this cycle, dynamic-admission
    # failures during placement attempts, and requeue events (placement
    # failures + preemptions, §3.2.4).
    admit_rejected: int = 0
    infeasible: int = 0
    requeues: int = 0


@dataclasses.dataclass
class CycleContext(SchedulingContext):
    """Per-cycle context handed to queue-policy/admit/preempt plugins.

    ``sched`` is the QSCH orchestrator; plugins drive placements through
    its public helpers (``try_place``, ``preempt_job``,
    ``dynamic_admit``) so gang commit, snapshot deltas and accounting
    stay in one place.
    """

    sched: Optional["QSCH"] = None
    rsch: Optional["RSCH"] = None
    state: Optional["ClusterState"] = None
    snap: Optional[Snapshot] = None
    now: float = 0.0
    result: CycleResult = dataclasses.field(default_factory=CycleResult)


# ----------------------------------------------------------------------
# Extension points
# ----------------------------------------------------------------------
class QueueSortPlugin(Plugin):
    """Orders the pending queue; lower keys schedule first (§3.2.2)."""

    def key(self, job: Job) -> Tuple:
        raise NotImplementedError


class AdmitPlugin(Plugin):
    """Admission control.  ``stage`` is ``"static"`` (runs when the
    global queue is built and re-checked before every placement,
    §3.2.1) or ``"dynamic"`` (runs against the working snapshot)."""

    stage: ClassVar[str] = "static"

    def admit(self, job: Job, ctx: CycleContext) -> bool:
        raise NotImplementedError


class FilterPlugin(Plugin):
    """Vectorized node filter: returns a boolean mask over the node
    table.  ``zone`` is the pass's zone selector (``None`` / ``"zone"``
    / ``"general"``); most filters ignore it."""

    def mask(self, job: Job, snap: Snapshot,
             zone: Optional[str]) -> np.ndarray:
        raise NotImplementedError


class ScorePlugin(Plugin):
    """Vectorized node scoring term (see module docstring contract)."""

    #: snapshot-static (False) vs pod-dependent (True) declaration.
    pod_dependent: ClassVar[bool] = False

    def fused_weights(self, job: Job) -> Optional[ScoreWeights]:
        """Weights folded into the single fused filter+score pass
        (numpy / torch / CUDA).  Return ``None`` if this plugin scores
        via :meth:`score` instead."""
        return None

    def score(self, job: Job, snap: Snapshot, pool: np.ndarray,
              ctx: Optional[SchedulingContext]) -> Optional[np.ndarray]:
        """Additive snapshot-static term over the node table (float
        array, shape ``(n_nodes,)``); added where the fused pass kept
        the node valid.  Return ``None`` to contribute nothing."""
        return None

    def group_score(self, job: Job, snap: Snapshot, pool: np.ndarray,
                    ctx: Optional[SchedulingContext]
                    ) -> Optional[np.ndarray]:
        """Additive term over the NodeNetGroup table (shape
        ``(n_leaf_groups,)``): biases Level-1 group preselection
        (§3.4.2), the group-granular twin of :meth:`score` — without it
        a group-constant node term can never steer single-group jobs,
        whose group is fixed before node scoring runs.  Aggregate only
        over ``pool`` nodes: the preselection never places outside the
        pass's Filter mask, so out-of-pool nodes must not earn a group
        its rank.  Higher wins; ties fall back to the pass's default
        group ranking.  Return ``None`` (the default) to leave
        preselection untouched."""
        return None

    def per_pod_bonus(self, job: Job) -> float:
        """Pod-dependent plugins only: bonus a node earns per pod of
        this job already placed on it (folded into the slot chains)."""
        return 0.0


class ReservePlugin(Plugin):
    """Claims bookkeeping for a computed placement before binding.
    Must be undoable: ``unreserve`` is called on every successfully
    reserved plugin if a later Reserve/Permit fails (§3.3.2)."""

    def reserve(self, job: Job, placement: Placement,
                ctx: CycleContext) -> bool:
        return True

    def unreserve(self, job: Job, placement: Placement,
                  ctx: CycleContext) -> None:
        pass


class PermitPlugin(Plugin):
    """Last gate before binding; a veto rolls back all reservations."""

    def permit(self, job: Job, placement: Placement,
               ctx: CycleContext) -> bool:
        return True


class PostBindPlugin(Plugin):
    """Runs after a placement is committed (informational)."""

    def post_bind(self, job: Job, placement: Placement,
                  ctx: CycleContext) -> None:
        pass


class PreemptPlugin(Plugin):
    """Victim selection for the conservative preemption engine
    (§3.2.3).  The orchestrator consults the profile's chain in order
    and runs its shared dry-run-checked eviction loop on the first
    non-empty victim list.  A plugin may instead override
    :meth:`execute` to own its whole preemption flow — eviction AND
    placement, via ``ctx.sched.preempt_job``/``try_place`` (Backfill
    head-timeout does this): the chain calls ``execute`` on every
    plugin whose ``victims`` came back empty and stops once the job is
    running."""

    def victims(self, job: Job, ctx: CycleContext) -> List[Job]:
        return []

    def execute(self, job: Job, ctx: CycleContext) -> None:
        """Full preemption flow for policies that are not driven by the
        shared chain loop (default: no-op)."""


class QueuePolicyPlugin(Plugin):
    """The cycle body (Table 1): walks the admitted global queue and
    drives placements via ``ctx.sched.try_place``."""

    # True when a blocked head ends the cycle with no further placement
    # attempts (Strict FIFO).  The cycle pipeline consults this to
    # predict which job — if any — opens the next cycle's RSCH call.
    strict_head = False

    def run_cycle(self, queue: List[Job], ctx: CycleContext) -> None:
        raise NotImplementedError


class DynamicsPlugin(Plugin):
    """Cluster-dynamics extension point (the ``DynamicsPolicy`` family).

    Where every other extension point decides *where work goes*, a
    dynamics plugin decides *what happens to the cluster*: failures,
    maintenance drains, autoscaling.  Two hooks:

    * :meth:`schedule` — called once at attach time with the
      :class:`~repro_torch.core.dynamics.engine.ClusterDynamics` engine and a
      seeded RNG; yields ``(t, EventKind, payload)`` tuples that are
      pre-seeded onto the simulator's event bus (a reproducible failure
      trace, drain windows, the autoscaler's first SCALE_DECISION).
    * :meth:`on_event` — called for every bus event whose kind is in
      :attr:`handles`; the plugin drives cluster mutations and job
      submissions through the engine's action helpers (``fail_node``,
      ``submit_job``, ``retire_job``, ``push`` ...), never by touching
      ``ClusterState`` directly — that keeps snapshot sync, quota
      refunds and requeue accounting in one place.

    The built-in NODE_FAIL/NODE_RECOVER/GPU_FAIL/GPU_RECOVER/
    DRAIN_START/DRAIN_END semantics live in the engine itself, so
    injector plugins stay declarative trace generators.
    """

    #: Event kinds routed to :meth:`on_event`.
    handles: ClassVar[Tuple[EventKind, ...]] = ()

    def schedule(self, engine, rng) -> Sequence[Tuple[float, EventKind,
                                                      object]]:
        return ()

    def on_event(self, event, engine) -> None:  # pragma: no cover - hook
        pass


class ClusterSelectPlugin(Plugin):
    """Federation routing extension point (GSCH,
    :mod:`repro_torch.core.federation`): decides which *member cluster* a job
    is forwarded to, the level above the per-cluster QSCH/RSCH pipeline.

    Both hooks are vectorized over the federation's per-cluster summary
    matrix (:class:`~repro_torch.core.federation.summary.FederationSummary`):
    free GPUs per (member, pool), leaf-group headroom, queue depth,
    pending gang backlog, cost/capability tables.  A routing decision
    must stay O(members) — plugins read the summary, they never walk a
    member's node arrays.

    * :meth:`feasible` — boolean mask over members; ``None`` abstains.
      The GSCH ANDs all plugin masks onto the structural-fit mask (pool
      exists, a pod fits on one node).  If the chain vetoes every
      member, the GSCH falls back to structural fit so a veto can delay
      but never strand a job.
    * :meth:`score` — additive float term over members; higher wins.
      Ties break toward the lower member index (determinism).
    """

    def feasible(self, job: Job, summary) -> Optional[np.ndarray]:
        return None

    def score(self, job: Job, summary) -> Optional[np.ndarray]:
        return None


class ElasticPolicyPlugin(Plugin):
    """Elastic-training extension point (:mod:`repro_torch.core.elastic`):
    decides which of a job's declared
    :class:`~repro_torch.core.elastic.spec.ParallelismPlan`s it runs at.

    Both hooks are *advisory* — the
    :class:`~repro_torch.core.elastic.manager.ElasticManager` executes the
    decision through the standard QSCH paths (placement via
    ``try_place``, reshape via the checkpoint-interrupt machinery), so
    plugins never mutate cluster state.  Jobs without an
    :attr:`~repro_torch.core.job.Job.elastic` spec never reach these hooks:
    the non-elastic pipeline stays byte-identical.

    * :meth:`select_plan` — called on every placement attempt of an
      elastic job, against the cycle's working snapshot.  Return the
      plan the attempt should use, or ``None`` to keep the ideal plan
      (rigid behavior: queue/preempt for the full shape).  Returning a
      smaller fitting plan is the **shrink** path — the gang starts in
      currently-free fragmented capacity instead of waiting.
    * :meth:`want_grow` — called once per cycle for each *running*
      elastic job below its ideal plan, only at a checkpoint boundary
      (reshaping restarts from the last checkpoint, see
      ``docs/elastic.md``).  ``reshape_cost_s`` is the restart overhead
      the recovery model will charge.  Return a strictly better target
      plan to trigger the reshape, or ``None`` to keep running as-is.
    """

    def select_plan(self, job: Job, snap: Snapshot,
                    ctx: Optional[CycleContext]):
        return None

    def want_grow(self, job: Job, snap: Snapshot,
                  ctx: Optional[CycleContext], reshape_cost_s: float):
        return None


class RouterPolicyPlugin(Plugin):
    """Query-routing extension point (:mod:`repro_torch.serve`): decides which
    model *replica* serves an individual request — the request-level
    sibling of :class:`ClusterSelectPlugin` (jobs → clusters there,
    queries → replicas here, per ECCOS-style constrained routing).

    * :meth:`select` — pick a replica index from ``replicas`` (a
      sequence of :class:`repro_torch.serve.replica.Replica`, each exposing
      its :class:`~repro_torch.serve.replica.ReplicaSpec` and live load) for
      ``request`` (a :class:`repro_torch.core.workload.ServeRequest`) at
      simulated time ``now``.  Return ``None`` to REJECT the request
      (no replica can meet its constraints); the pool records the
      rejection as an SLO miss rather than queueing it forever.
    * :meth:`observe` — optional feedback hook called with each
      completed :class:`repro_torch.serve.metrics.RequestOutcome`, so
      learning policies can update capability estimates online.
    """

    def select(self, request, replicas: Sequence, now: float
               ) -> Optional[int]:
        raise NotImplementedError

    def observe(self, outcome) -> None:  # pragma: no cover - hook
        pass


class ObserverPlugin(Plugin):
    """Telemetry extension point (:mod:`repro_torch.obs`): read-only taps on
    the scheduling pipeline, fed by an attached
    :class:`~repro_torch.obs.telemetry.Telemetry` facade.

    Where every other extension point *decides* something, an observer
    only *watches*: hooks must never mutate jobs, snapshots or cluster
    state — the detached-telemetry byte-identity gate
    (``benchmarks/obs_bench.py``) also runs with telemetry attached and
    asserts placements and metrics are unchanged.

    Hooks (all optional; default implementations are no-ops):

    * :meth:`on_cycle` — after every QSCH cycle (the Tick tap), with a
      :class:`~repro_torch.obs.telemetry.CycleSpan` carrying wall-clock phase
      timings and the :class:`CycleResult`;
    * :meth:`on_bind` / :meth:`on_reject` — after a placement binds
      (the PostBind tap) or an attempt fails, with a
      :class:`~repro_torch.obs.audit.PlacementDecision` carrying per-Filter
      node-elimination counts and the per-ScorePlugin score breakdown
      of the winning nodes (``None`` when the audit pillar is off);
    * :meth:`on_preempt` — one eviction fired (the Preempt tap), with a
      :class:`~repro_torch.obs.audit.PreemptionRecord` naming victim,
      beneficiary and the Preempt plugin that selected it;
    * :meth:`on_event` — every simulator :class:`~repro_torch.core.events.Event`
      (the EventBus subscriber: SUBMIT/END plus all dynamics kinds);
    * :meth:`on_sample` — every metrics :class:`~repro_torch.core.metrics.Sample`;
    * :meth:`on_job` — job lifecycle edges (``"placed"`` /
      ``"finished"`` / ``"interrupted"`` / ``"reshape"``);
    * :meth:`on_param_change` — a tuning controller moved a registered
      handle (:class:`~repro_torch.core.tuning.params.ParamChange`);
    * :meth:`on_run_end` — the simulator finalized.

    ``scope`` is ``None`` standalone and the member name under a
    federation (one Telemetry can watch every member simulator).
    """

    def on_cycle(self, span, ctx: "CycleContext") -> None:
        pass

    def on_bind(self, job: Job, decision, ctx: "CycleContext") -> None:
        pass

    def on_reject(self, job: Job, decision, ctx: "CycleContext") -> None:
        pass

    def on_preempt(self, record, ctx: "CycleContext") -> None:
        pass

    def on_event(self, event, scope: Optional[str] = None) -> None:
        pass

    def on_sample(self, sample, scope: Optional[str] = None) -> None:
        pass

    def on_job(self, job: Job, edge: str, t: float,
               scope: Optional[str] = None) -> None:
        pass

    def on_param_change(self, change,
                        scope: Optional[str] = None) -> None:
        pass

    def on_run_end(self, sim, scope: Optional[str] = None) -> None:
        pass


class ControllerPlugin(Plugin):
    """Online parameter-control extension point
    (:mod:`repro_torch.core.tuning`): closes the metrics→parameters loop.

    Where an :class:`ObserverPlugin` only *watches*, a controller
    *steers* — but only through the registered tunable handles of a
    :class:`~repro_torch.core.tuning.params.ParamSpace`, never by touching
    scheduler state directly.  Every write goes through
    ``ParamSpace.set``, which clamps to the handle's bounds, enforces
    its per-step change-rate limit, publishes the new value as a Gauge
    into the attached obs registry and emits a DecisionAudit/trace
    instant — so a controller cannot push the system outside its
    declared envelope and every change is attributable.

    Controllers are registered like any plugin and attached via
    :class:`~repro_torch.core.tuning.manager.TuningManager`, which feeds them
    the simulator's Tick/Sample stream:

    * :meth:`bind` — once at attach time, after the ParamSpace is
      populated; stash references, seed internal state.
    * :meth:`on_tick` — every scheduler tick (between QSCH cycles, on
      the simulator's TICK cadence).  Cheap bookkeeping only — this is
      on the per-cycle path and is covered by the ≤5% attached-overhead
      gate (``benchmarks/tuning_bench.py``).
    * :meth:`control` — once per **control period**
      (:attr:`control_period_s` of simulated time), with a
      :class:`~repro_torch.core.tuning.manager.TuningWindow` summarizing the
      period's GFR/JWTD/GAR/SOR observations.  This is where parameter
      moves happen.
    * :meth:`warm_start` — seed from a
      :class:`~repro_torch.core.tuning.profile.TuningProfile` exported by a
      previously tuned run/member (Sliwko-style transfer) instead of
      starting cold.

    A controller that never calls ``space.set`` must be byte-identical
    to a detached run (placements, metric report, raw samples) — the
    tuning twin of the obs parity gate, enforced by
    ``benchmarks/tuning_bench.py`` and ``tests/test_tuning.py``.
    """

    #: Simulated seconds between :meth:`control` invocations.
    control_period_s: ClassVar[float] = 1800.0

    def bind(self, space, manager) -> None:
        pass

    def on_tick(self, now: float, sched: "QSCH", space) -> None:
        pass

    def control(self, window, space) -> None:
        pass

    def warm_start(self, profile, space) -> None:
        pass


#: Shared no-op context for detached-telemetry phase sites (one object,
#: never re-allocated: the detached hot path pays a single ``is None``
#: branch plus a constant-cost ``with``).
_NULL_PHASE = contextlib.nullcontext()


def obs_phase(obs, name: str):
    """Timed-phase context for an attached telemetry observer.

    QSCH/RSCH wrap each pipeline stage (snapshot → queue-sort → filter
    → score → reserve-permit → bind → preempt) in
    ``with obs_phase(self.obs, "..."):``; with ``obs is None`` (no
    telemetry attached) this returns a shared null context and the
    stage runs untimed and unchanged."""
    return _NULL_PHASE if obs is None else obs.phase(name)


# ----------------------------------------------------------------------
# Profiles
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PlacementPass:
    """One Filter+Score placement attempt over a node-pool restriction.

    ``spread``/``enhanced`` steer the Level-1 NodeNetGroup preselection
    (§3.4.2): spread prefers the emptiest group, enhanced reserves
    empty groups for large jobs (LeafGroup E-Binpack, §3.3.3); ``zone``
    restricts to the inference dedicated zone or its complement
    (§3.3.4).
    """

    scorers: Tuple[ScorePlugin, ...]
    spread: bool = False
    enhanced: bool = False
    zone: Optional[str] = None


#: Plan: ordered placement passes for a job against a snapshot; the
#: first pass that yields a placement wins.
PlanFn = Callable[[Job, Snapshot], Sequence[PlacementPass]]


def single_pass_plan(p: PlacementPass) -> PlanFn:
    """Plan that always runs exactly one pass (the common case)."""
    def plan(job: Job, snap: Snapshot) -> Sequence[PlacementPass]:
        return (p,)
    return plan


@dataclasses.dataclass
class SchedulingProfile:
    """One plugin chain per extension point, for one workload class."""

    name: str
    plan: PlanFn
    queue_sort: QueueSortPlugin
    admit: Tuple[AdmitPlugin, ...] = ()
    filters: Tuple[FilterPlugin, ...] = ()
    reserve: Tuple[ReservePlugin, ...] = ()
    permit: Tuple[PermitPlugin, ...] = ()
    post_bind: Tuple[PostBindPlugin, ...] = ()
    preempt: Tuple[PreemptPlugin, ...] = ()

    def admit_chain(self, stage: str) -> Tuple[AdmitPlugin, ...]:
        return tuple(p for p in self.admit if p.stage == stage)


@dataclasses.dataclass
class ProfileSet:
    """Per-workload profiles (§2 diverse task types) + the shared queue
    policy.  Like kube-scheduler profiles, the queue is global: the
    ``train`` profile's QueueSort orders it for every workload."""

    train: SchedulingProfile
    inference: SchedulingProfile
    best_effort: SchedulingProfile

    def for_job(self, job: Job) -> SchedulingProfile:
        if job.kind is JobKind.INFER:
            return self.inference
        if job.kind is JobKind.DEBUG:
            return self.best_effort
        return self.train

    @property
    def queue_sort(self) -> QueueSortPlugin:
        return self.train.queue_sort
