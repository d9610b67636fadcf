"""The cluster-dynamics engine: event semantics + action helpers.

:class:`ClusterDynamics` attaches to a :class:`~repro_torch.core.simulator.
Simulator` and owns the *semantics* of the dynamic event kinds:

* NODE_FAIL / GPU_FAIL — flip health bitmaps on the live state, mirror
  the change onto the scheduler's working snapshot
  (:meth:`~repro_torch.core.qsch.QSCH.sync_health` — the mid-cycle
  cache-invalidation fix), and kill every resident gang: each victim
  goes through the checkpoint-restart recovery model and re-enters its
  tenant queue with the recomputed remaining duration (§3.2.4 requeue
  applied to failures);
* NODE_RECOVER / GPU_RECOVER — restore health and revive the scheduling
  tick chain so waiting work can use the returned capacity;
* DRAIN_START / DRAIN_END — planned maintenance windows: draining nodes
  accept no new placements (drain-aware filtering in RSCH); ``evict``
  windows also checkpoint-kill resident jobs;
* SCALE_DECISION — routed to the owning
  :class:`~repro_torch.core.framework.api.DynamicsPlugin` (tidal autoscaler).

Plugins never mutate ``ClusterState`` directly — they drive the
engine's action helpers so snapshot sync, quota refunds, stale-END
bookkeeping and metrics accounting stay in one place.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..events import Event, EventKind
from ..framework.api import DynamicsPlugin
from ..job import Job, JobState
from .recovery import CheckpointModel

_DYNAMIC_KINDS = (EventKind.NODE_FAIL, EventKind.NODE_RECOVER,
                  EventKind.GPU_FAIL, EventKind.GPU_RECOVER,
                  EventKind.DRAIN_START, EventKind.DRAIN_END)


@dataclasses.dataclass
class DynamicsConfig:
    """Everything the engine needs; an empty config (no plugins) is the
    documented no-op — simulation results are byte-identical to a run
    with ``SimConfig.dynamics=None`` (asserted by
    ``benchmarks/dynamics_bench.py``)."""

    plugins: Sequence[DynamicsPlugin] = ()
    recovery: CheckpointModel = dataclasses.field(
        default_factory=CheckpointModel)
    seed: int = 0
    # Horizon for pre-sampled traces when SimConfig.horizon is None
    # (drain-to-empty runs still need a bound for failure sampling).
    trace_horizon: float = 7 * 86_400.0


@dataclasses.dataclass
class DynamicsSummary:
    node_failures: int = 0
    gpu_failures: int = 0
    recoveries: int = 0
    interrupts: int = 0
    drain_windows: int = 0
    drain_evictions: int = 0
    scale_events: int = 0
    replicas_started: int = 0
    replicas_retired: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class ClusterDynamics:
    def __init__(self, config: DynamicsConfig) -> None:
        self.config = config
        self.summary = DynamicsSummary()
        self.sim = None
        self.rng = np.random.default_rng(config.seed)
        self._uids = itertools.count(10_000_000)
        # Reference counts of open failures/drains per node (device):
        # overlapping injector traces or drain windows must not let the
        # first recovery/window-end revive a node another open outage
        # still claims.
        self._down: Dict[int, int] = {}
        self._draining: Dict[int, int] = {}
        self._gpu_down: Dict[tuple, int] = {}

    # ------------------------------------------------------------------
    # Wiring
    # ------------------------------------------------------------------
    @property
    def state(self):
        return self.sim.state

    @property
    def qsch(self):
        return self.sim.qsch

    @property
    def horizon(self) -> float:
        h = self.sim.config.horizon
        return float(h) if h is not None else self.config.trace_horizon

    def attach(self, sim) -> None:
        self.sim = sim
        bus = sim.bus
        bus.subscribe(EventKind.NODE_FAIL, self._on_node_fail)
        bus.subscribe(EventKind.NODE_RECOVER, self._on_node_recover)
        bus.subscribe(EventKind.GPU_FAIL, self._on_gpu_fail)
        bus.subscribe(EventKind.GPU_RECOVER, self._on_gpu_recover)
        bus.subscribe(EventKind.DRAIN_START, self._on_drain_start)
        bus.subscribe(EventKind.DRAIN_END, self._on_drain_end)
        # Recovery-side events are pushed even past the horizon: with a
        # SimConfig horizon the loop stops before reaching them anyway,
        # but a drain-to-empty run (horizon=None) must not inherit a
        # permanently dead node from a dropped repair — that would keep
        # the requeued work pending and the TICK chain alive forever.
        closing = (EventKind.NODE_RECOVER, EventKind.GPU_RECOVER,
                   EventKind.DRAIN_END)
        for plugin in self.config.plugins:
            for kind in plugin.handles:
                bus.subscribe(kind, self._plugin_handler(plugin))
            for t, kind, payload in plugin.schedule(self, self.rng):
                if t <= self.horizon or kind in closing:
                    bus.push(t, kind, payload)

    def _plugin_handler(self, plugin: DynamicsPlugin):
        def handler(event: Event) -> None:
            # Owner routing: a plugin-owned event (payload carries
            # {"owner": plugin}) is delivered only to its owner.  Two
            # autoscalers subscribed to SCALE_DECISION must not see —
            # and re-continue — each other's chains, or the event count
            # doubles per generation.
            owner = (event.payload.get("owner")
                     if isinstance(event.payload, dict) else None)
            if owner is not None and owner is not plugin:
                return
            if event.kind is EventKind.SCALE_DECISION:
                self.summary.scale_events += 1
            plugin.on_event(event, self)
        return handler

    # ------------------------------------------------------------------
    # Action helpers (the only sanctioned mutation paths for plugins)
    # ------------------------------------------------------------------
    def push(self, t: float, kind: EventKind, payload=None) -> None:
        self.sim.bus.push(t, kind, payload)

    def next_uid(self) -> int:
        return next(self._uids)

    def submit_job(self, job: Job, t: float) -> None:
        """Enqueue a plugin-created job through the normal SUBMIT path
        and make sure a scheduling cycle will actually look at it."""
        self.sim.bus.push(max(t, job.submit_time), EventKind.SUBMIT, job)
        self._revive(t)

    def retire_job(self, job: Job, t: float) -> None:
        """Gracefully terminate a job now (autoscaler scale-down): it
        counts as completed with the work it actually delivered."""
        if job.state is JobState.RUNNING:
            # Useful work = total serving time, not the nominal
            # until-the-horizon duration replicas are created with.
            # Pre-interruption serving survives in checkpointed_progress
            # (stateless services checkpoint continuously); the current
            # attempt contributes its elapsed time minus the restore
            # overhead it started with.
            elapsed = max(0.0, t - (job.run_time if job.run_time
                                    is not None else t))
            # Wall time converts to work at the active plan's relative
            # throughput (1.0 for rigid jobs).
            attempt_work = max(
                0.0, elapsed - self.config.recovery.attempt_overhead(job)
            ) * job.work_rate
            job.original_duration = job.checkpointed_progress \
                + attempt_work
            self.sim.pending_ends.pop(job.uid, None)
            self.qsch.on_complete(job, self.state, t)
            self.sim.metrics.on_job_finished(job)
        else:
            # Still queued: cancel before it ever places.  Work served
            # before an interruption still counts.
            self.qsch._remove_from_queue(job)
            job.original_duration = job.checkpointed_progress
            job.state = JobState.COMPLETED
            job.end_time = t
            if job.original_duration > 0:
                self.sim.metrics.on_job_finished(job)

    def interrupt_job(self, job: Job, t: float) -> None:
        """Checkpoint-kill one running job (failure/drain-evict path)."""
        remaining, lost, overhead = self.config.recovery.on_interrupt(
            job, t)
        self.sim.metrics.on_job_interrupted(job, t, lost, overhead)
        self.qsch.on_interrupted(job, self.state, t, remaining)
        self.summary.interrupts += 1

    # ------------------------------------------------------------------
    # Built-in event semantics
    # ------------------------------------------------------------------
    def _kill_resident(self, node: int, t: float,
                       gpu: Optional[int] = None) -> List[Job]:
        victims = []
        for uid in self.state.jobs_on(node, gpu):
            job = self.qsch.running.get(uid)
            if job is not None:
                victims.append(job)
        for job in victims:
            self.interrupt_job(job, t)
        return victims

    def _sync(self, nodes: Sequence[int], t: float) -> None:
        self.qsch.sync_health(self.state, nodes)
        self._revive(t)

    def _revive(self, t: float) -> None:
        """Failures/recoveries/scale actions can create schedulable work
        after the tick/sample chains drained — restart them."""
        self.sim.ensure_tick(t)
        self.sim.ensure_sample(t)

    def _on_node_fail(self, ev: Event) -> None:
        node = int(ev.payload["node"])
        self._down[node] = self._down.get(node, 0) + 1
        if self._down[node] > 1:      # already down: stack the outage
            return
        self._kill_resident(node, ev.t)
        self.state.set_node_health(node, False)
        self.summary.node_failures += 1
        self._sync([node], ev.t)

    def _on_node_recover(self, ev: Event) -> None:
        node = int(ev.payload["node"])
        if node not in self._down:
            return
        self._down[node] -= 1
        if self._down[node] > 0:      # another overlapping outage open
            return
        del self._down[node]
        self.state.set_node_health(node, True)
        self.summary.recoveries += 1
        self._sync([node], ev.t)

    def _on_gpu_fail(self, ev: Event) -> None:
        node, gpu = int(ev.payload["node"]), int(ev.payload["gpu"])
        key = (node, gpu)
        self._gpu_down[key] = self._gpu_down.get(key, 0) + 1
        if self._gpu_down[key] > 1:
            return
        if node not in self._down:    # node-down already killed it all
            self._kill_resident(node, ev.t, gpu=gpu)
        self.state.set_gpu_health(node, gpu, False)
        self.summary.gpu_failures += 1
        self._sync([node], ev.t)

    def _on_gpu_recover(self, ev: Event) -> None:
        node, gpu = int(ev.payload["node"]), int(ev.payload["gpu"])
        key = (node, gpu)
        if key not in self._gpu_down:
            return
        self._gpu_down[key] -= 1
        if self._gpu_down[key] > 0:
            return
        del self._gpu_down[key]
        self.state.set_gpu_health(node, gpu, True)
        self.summary.recoveries += 1
        self._sync([node], ev.t)

    def _on_drain_start(self, ev: Event) -> None:
        nodes = [int(n) for n in ev.payload["nodes"]]
        fresh = []
        for n in nodes:
            self._draining[n] = self._draining.get(n, 0) + 1
            if self._draining[n] == 1:
                fresh.append(n)
        self.summary.drain_windows += 1
        if not fresh:
            return
        self.state.set_drain(fresh, True)
        if ev.payload.get("evict"):
            for node in fresh:
                self.summary.drain_evictions += len(
                    self._kill_resident(node, ev.t))
        self._sync(fresh, ev.t)

    def _on_drain_end(self, ev: Event) -> None:
        done = []
        for n in (int(n) for n in ev.payload["nodes"]):
            if n not in self._draining:
                continue
            self._draining[n] -= 1
            if self._draining[n] == 0:   # last open window on this node
                del self._draining[n]
                done.append(n)
        if not done:
            return
        self.state.set_drain(done, False)
        self._sync(done, ev.t)

    # ------------------------------------------------------------------
    def finalize(self, result) -> None:
        s = self.summary
        for plugin in self.config.plugins:
            s.replicas_started += getattr(plugin, "replicas_started", 0)
            s.replicas_retired += getattr(plugin, "replicas_retired", 0)
        result.failures = s.node_failures + s.gpu_failures
        result.interrupts = s.interrupts
        result.drains = s.drain_windows
        result.scale_events = s.scale_events
        result.dynamics = s
