"""RSCH — the Resource-aware Scheduler (paper §3.3), as a placement
engine running its profile's plugin chains.

RSCH turns an admitted job into a concrete :class:`Placement` by running
the :class:`~repro_torch.core.framework.api.SchedulingProfile` selected for
the job's workload kind (train / inference / best-effort):

1. **Plan** — the profile yields an ordered list of
   :class:`~repro_torch.core.framework.api.PlacementPass` attempts (e.g. the
   E-Spread zone dance, §3.3.4); the first pass that places wins.
2. **Filter** (§3.4.1): the pass's Filter plugins produce the node-pool
   mask.  The default GpuTypeFilter+HealthFilter pair resolves through
   the snapshot's cached ``candidate_pool`` fast path.
3. **Level-1 group preselection** (§3.4.2): NodeNetGroups chosen by the
   pass's ``spread``/``enhanced`` flags (§3.3.3/§3.3.5).
4. **Score** (§3.3.3/§3.3.4): Score plugins contribute to ONE fused
   filter+score pass (numpy/torch/CUDA, :mod:`repro_torch.core.scoring`);
   snapshot-static extra terms are added onto it, pod-dependent bonuses
   are folded into the batched slot chains.
5. **Gang semantics** (§3.3.2): the whole job is placed transactionally
   — if any pod cannot be placed the job stays pending and no state is
   mutated.
6. **Fine-grained device selection** (§3.3.1): within a node, pick the
   healthy GPU combination with the best interconnect and pair it with
   the island's RDMA NIC.

The legacy ``Strategy`` enum and ``RSCHConfig(train_strategy=...)`` are
kept as a deprecation shim: :func:`profiles_from_config` maps them onto
default profiles built from the built-in plugins, placement-identical
to the pre-framework scheduler (asserted by
``benchmarks/sched_scale_bench.py`` and ``tests/test_framework.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import numpy as np

from .framework.api import (PlacementPass, ProfileSet, SchedulingContext,
                            SchedulingProfile, obs_phase, obs_span,
                            single_pass_plan)
from .framework.builtin import (GpuTypeFilter, HealthFilter, binpack_pass,
                                ebinpack_pass, espread_plan, make_profile,
                                spread_pass)
from .job import Job, JobKind, Placement, PodPlacement
from .scoring import (NEG_INF, ScoreWeights, combine_weights,
                      compute_node_scores, compute_node_scores_and_slots,
                      node_scores_np, probed, select_gang_slots)
from .snapshot import Snapshot
from .topology import ClusterTopology
from ..device import resolve_device

#: the context a pass runs in when it has no span of its own (reusable)
_NO_SPAN = contextlib.nullcontext()


class Strategy(enum.Enum):
    """Legacy strategy names (shim over the plugin profiles; the weight
    compositions live in :mod:`repro_torch.core.framework.builtin`)."""

    BINPACK = "binpack"
    E_BINPACK = "e-binpack"
    SPREAD = "spread"
    E_SPREAD = "e-spread"


@dataclasses.dataclass
class RSCHConfig:
    """Engine knobs + the legacy strategy shim.

    ``train_strategy``/``infer_strategy`` only matter when no explicit
    ``profiles`` are passed to :class:`RSCH`; they are then mapped onto
    default profiles via :func:`profiles_from_config`.
    """

    train_strategy: Strategy = Strategy.E_BINPACK
    infer_strategy: Strategy = Strategy.E_SPREAD
    # E-Spread (§3.3.4): inference pods smaller than this use the dedicated
    # zone; everything else falls back to E-Binpack in the general pool.
    espread_small_pod_gpus: int = 8
    # Schedule EP-style jobs at HBD granularity (§3.3.5 Scale-Up).
    hbd_granular_ep: bool = True
    # Batched gang placement (§3.4): one fused filter+score pass +
    # capacity-aware top-k slot selection for the whole gang, instead of
    # re-scoring every node once per pod.  The sequential path is kept
    # for A/B benchmarking (benchmarks/sched_scale_bench.py).
    batched_gang: bool = True
    # Score-pass backend: "kernel" (the CUDA kernel on a CUDA device, its
    # plain torch version on device="cpu"), "ref" (plain torch on the
    # device) or "np" (host numpy, the A/B path).
    score_backend: str = "kernel"
    # Device of the score pass: None = CUDA (raises without one); pass
    # "cpu" to run the plain versions on the host.
    device: Optional[str] = None
    # Same-node co-location bonus per already-placed pod of the job
    # (node-level E-Binpack, §3.3.3).
    colocate_bonus: float = 2.0
    # Subset scoring (million-node core): for default Filter chains,
    # Level-1 preselection runs on snapshot-maintained per-group
    # aggregates (O(groups), patched row-wise on placement deltas) and
    # the Level-2 score pass touches only the selected groups' member
    # nodes — exact-identical to the full-width pass.  Falls back to
    # full width for custom Filter chains and decision-audit capture.
    subset_scoring: bool = True
    # Gang slot-selection engine: "topk" (vectorized sort + chain
    # emission), "heap" (the lazy-greedy loop, kept as the A/B oracle),
    # or "topk_kernel" (torch top-k prefilter on the device).  The vectorized
    # engines auto-fall-back to the heap when plugin weights make slot
    # chains decreasing (see scoring.chains_nondecreasing).
    slot_engine: str = "topk"


def profiles_from_config(config: RSCHConfig) -> ProfileSet:
    """Deprecation shim: legacy ``Strategy`` pair -> default profiles.

    The resulting profiles are placement-identical to the pre-framework
    RSCH for every (strategy, workload) combination, including the
    train-with-E-Spread fallback to E-Binpack and the inference zone
    dance.
    """
    def plan_for(strategy: Strategy, for_infer: bool):
        # Co-location only ever applied to enhanced strategies on
        # non-inference jobs (the old `enhanced and kind != INFER` gate).
        colocate = 0.0 if for_infer else config.colocate_bonus
        if strategy is Strategy.BINPACK:
            return single_pass_plan(binpack_pass())
        if strategy is Strategy.SPREAD:
            return single_pass_plan(spread_pass())
        if strategy is Strategy.E_BINPACK:
            return single_pass_plan(ebinpack_pass(colocate))
        return espread_plan(config.espread_small_pod_gpus, colocate)

    return ProfileSet(
        train=make_profile(
            f"train-{config.train_strategy.value}",
            plan_for(config.train_strategy, for_infer=False)),
        inference=make_profile(
            f"inference-{config.infer_strategy.value}",
            plan_for(config.infer_strategy, for_infer=True)),
        best_effort=make_profile(
            f"best-effort-{config.train_strategy.value}",
            plan_for(config.train_strategy, for_infer=False)),
    )


@dataclasses.dataclass
class ScheduleResult:
    placement: Optional[Placement]
    reason: str = ""
    groups_used: int = 0
    # Raw decision-audit capture (repro_torch.obs lifts it into typed records
    # via build_decision); None when no telemetry observer is attached.
    audit: Optional[Dict] = None


class RSCH:
    def __init__(self, topology: ClusterTopology,
                 config: Optional[RSCHConfig] = None,
                 profiles: Optional[ProfileSet] = None) -> None:
        self.topology = topology
        self.config = config or RSCHConfig()
        self.device = resolve_device(self.config.device)
        self.profiles = profiles or profiles_from_config(self.config)
        self._link_class = topology.gpu_link_class()
        self._nic = topology.nic_for_gpu()
        # Device selection runs once per placed pod; python lists over the
        # G-sized slot axis beat numpy dispatch overhead at G=8.
        self._nic_list = [int(n) for n in self._nic]
        self._n_islands = int(self._nic.max()) + 1
        # Static per-NodeNetGroup spine membership (topology never changes).
        self._group_spine = topology.spine_id[np.searchsorted(
            topology.leaf_id, np.arange(topology.n_leaf_groups))]
        # Member-node range of each NodeNetGroup: leaf_id is contiguous
        # ascending (idx // nodes_per_leaf), so group g's members are
        # exactly arange(_leaf_start[g], _leaf_start[g+1]).  This is what
        # lets subset scoring materialize selected-group node lists
        # without an O(n) membership scan.
        self._leaf_start = np.searchsorted(
            topology.leaf_id, np.arange(topology.n_leaf_groups + 1))
        # Optional telemetry facade (repro_torch.obs): filter/score phase
        # timing + decision-audit capture.  None = zero-cost detached.
        self.obs = None
        # Armed by the cycle pipeline (repro_torch.core.pipeline): a
        # precomputed ScheduleResult for the predicted head job, consumed
        # by :meth:`schedule` when every optimistic-concurrency guard
        # holds.  None in unpipelined operation.
        self.speculation = None

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def profile_for(self, job: Job) -> SchedulingProfile:
        return self.profiles.for_job(job)

    def strategy_for(self, job: Job) -> Strategy:
        """Legacy shim: the strategy the config would have used."""
        if job.kind is JobKind.INFER:
            return self.config.infer_strategy
        return self.config.train_strategy

    def feasible(self, job: Job, snap: Snapshot) -> bool:
        """Dynamic-resource-admission check (§3.2.1): are there enough
        free, healthy GPUs in the job's node pool right now?

        The pool honors the profile's full Filter chain (zone-agnostic,
        like the legacy check) — otherwise a restrictive custom filter
        would let admission pass forever while placement always fails.
        """
        return self.feasible_shape(job, snap, job.n_pods,
                                   job.gpus_per_pod)

    def feasible_shape(self, job: Job, snap: Snapshot, n_pods: int,
                       gpus_per_pod: int) -> bool:
        """Would ``job`` pass dynamic resource admission at a
        *hypothetical* ``(n_pods, gpus_per_pod)`` shape?  The elastic
        subsystem enumerates a job's candidate parallelism plans
        through this check without ever mutating the job; with the
        job's own shape it IS :meth:`feasible`."""
        pool, default = self._resolve_pool(job, snap, self.profile_for(job),
                                           None)
        if default:
            # Snapshot-maintained per-group slot totals: O(groups) to
            # sum, patched in O(dirty rows) on placement deltas.  A
            # node's ``floor(free/gpus_per_pod)`` is 0 exactly when
            # ``free < gpus_per_pod``, so the masked-division sum equals
            # the legacy ``pool & per_node_ok`` capacity count.
            totals = self._group_slots_cached(snap, int(job.gpu_type),
                                              None, gpus_per_pod)
            return int(totals.sum()) >= n_pods
        per_node_ok = snap.free_gpus >= gpus_per_pod
        capacity = int((snap.free_gpus // gpus_per_pod)[
            pool & per_node_ok].sum())
        return capacity >= n_pods

    def schedule(self, job: Job, snap: Snapshot,
                 ctx: Optional[SchedulingContext] = None) -> ScheduleResult:
        """Compute a placement against a snapshot.  Pure — commits happen
        via ``ClusterState.allocate`` by the caller.  ``ctx`` gives
        Score plugins optional cluster context (e.g. running jobs)."""
        obs = self.obs
        if obs is None:
            return self._schedule(job, snap, ctx, None)
        # The seam's passes of this call run in the telemetry's spans.
        with obs.span("schedule", job.uid), probed(obs):
            return self._schedule(job, snap, ctx, obs)

    def _schedule(self, job: Job, snap: Snapshot,
                  ctx: Optional[SchedulingContext], obs) -> ScheduleResult:
        audit_on = obs is not None and obs.audit_on
        spec = self.speculation
        if spec is not None and spec.job_uid == job.uid:
            # A pipelined speculative result exists for this job.  The
            # pipeline already verified no state mutation intervened;
            # here we verify the job itself (shape unchanged — elastic
            # reshapes recompute), the snapshot identity/mutation count,
            # the score-weight fingerprint (a tuning controller may
            # have nudged plugin weights between cycles) and the audit
            # regime (a speculation made before an auditing observer
            # was attached carries no capture, so it recomputes).
            self.speculation = None
            if (spec.snap is snap and spec.mut == snap.mut_count
                    and spec.shape == (job.n_pods, job.gpus_per_pod,
                                       int(job.gpu_type), job.kind)
                    and spec.fingerprint
                    == self._weights_fingerprint(job, snap)
                    and (spec.result.audit is not None) == audit_on):
                spec.consumed = True
                return spec.result
        profile = self.profile_for(job)
        capture: Optional[Dict] = None
        if audit_on:
            capture = {"profile": profile.name, "passes": []}
        result = ScheduleResult(None, "empty placement plan")
        plan = profile.plan(job, snap)
        # Attached, each pass is counted by its pool ("all" where it has
        # no zone) and whether it placed; the passes of a plan of more
        # than one (E-Spread's zone pass and its fallbacks) also run in
        # a span each, ``pass-<pool>`` under ``schedule``.  A plan of one
        # pass is its ``schedule`` span.
        spanned = obs is not None and len(plan) > 1
        for pass_ in plan:
            with (obs.span("pass-" + (pass_.zone or "all")) if spanned
                  else _NO_SPAN):
                result = self._run_pass(job, snap, pass_, profile, ctx,
                                        capture)
            if obs is not None:
                obs.pass_done(pass_.zone or "all",
                              result.placement is not None)
            if result.placement is not None:
                break
        result.audit = capture
        return result

    # ------------------------------------------------------------------
    # Snapshot-maintained per-group aggregates (subset scoring)
    # ------------------------------------------------------------------
    # Each helper registers a row-patchable TrackedGroupSum on the
    # snapshot (see repro_torch.core.snapshot): built once per (pool, cycle
    # epoch) in O(n), then patched in O(dirty rows) as placements fold
    # in, and dropped wholesale on health/drain refreshes.  Only valid
    # for DEFAULT Filter chains, whose pool mask is the snapshot's own
    # cached candidate_pool — custom chains shape the pool per job.

    def _group_slots_cached(self, snap: Snapshot, gpu_type: int,
                            zone: Optional[str],
                            request: int) -> np.ndarray:
        topo = self.topology

        def contrib(s: Snapshot, idx: Optional[np.ndarray]) -> np.ndarray:
            p = s.candidate_pool(gpu_type, zone)
            if idx is None:
                return np.where(p, s.free_gpus // request, 0)
            return np.where(p[idx], s.free_gpus[idx] // request, 0)

        return snap.tracked_sum(("gslots", gpu_type, zone, int(request)),
                                topo.leaf_id, topo.n_leaf_groups, contrib)

    def _group_free_cached(self, snap: Snapshot, gpu_type: int,
                           zone: Optional[str]) -> np.ndarray:
        topo = self.topology

        def contrib(s: Snapshot, idx: Optional[np.ndarray]) -> np.ndarray:
            p = s.candidate_pool(gpu_type, zone)
            if idx is None:
                return np.where(p, s.free_gpus, 0)
            return np.where(p[idx], s.free_gpus[idx], 0)

        return snap.tracked_sum(("gfree", gpu_type, zone),
                                topo.leaf_id, topo.n_leaf_groups, contrib)

    def _group_used_cached(self, snap: Snapshot, gpu_type: int,
                           zone: Optional[str]) -> np.ndarray:
        topo = self.topology

        def contrib(s: Snapshot, idx: Optional[np.ndarray]) -> np.ndarray:
            p = s.candidate_pool(gpu_type, zone)
            if idx is None:
                return np.where(p, s.used_gpus, 0)
            return np.where(p[idx], s.used_gpus[idx], 0)

        return snap.tracked_sum(("gused", gpu_type, zone),
                                topo.leaf_id, topo.n_leaf_groups, contrib)

    def _members_of_groups(self, groups) -> np.ndarray:
        """Ascending node indices of the given NodeNetGroups.  Ascending
        order matters: the slot-selection tie rule is lowest-node-index,
        so subset positions must increase with node index."""
        off = self._leaf_start
        return np.concatenate([np.arange(off[g], off[g + 1])
                               for g in sorted(int(g) for g in groups)])

    def _weights_fingerprint(self, job: Job, snap: Snapshot) -> tuple:
        """Per-pass (scorer, fused weights, per-pod bonus) tuple — the
        speculation guard against score-parameter drift between the
        speculative and the real schedule call (e.g. a self-tuning
        controller adjusting plugin weights)."""
        fp = []
        for pass_ in self.profile_for(job).plan(job, snap):
            for s in pass_.scorers:
                w = s.fused_weights(job)
                fp.append((s.name,
                           None if w is None
                           else (w.used, w.fit, w.group, w.topo),
                           s.per_pod_bonus(job) if s.pod_dependent
                           else 0.0))
        return tuple(fp)

    # ------------------------------------------------------------------
    # Core two-level placement (one PlacementPass)
    # ------------------------------------------------------------------
    def _resolve_pool(self, job: Job, snap: Snapshot,
                      profile: SchedulingProfile,
                      zone: Optional[str]) -> Tuple[np.ndarray, bool]:
        """Run the Filter chain.  The default GpuTypeFilter+HealthFilter
        pair hits the snapshot's cached pool mask (§3.4.1); extra
        plugins AND their masks on top.  Returns ``(pool, default)``
        where ``default`` says the pool equals the cached default mask
        (safe to key derived caches on ``(gpu_type, zone)``).

        Exact-type check, not isinstance: a subclass overriding
        ``mask()`` must go through the generic path, never be silently
        swallowed by the fast path."""
        filters = profile.filters
        extras = [f for f in filters
                  if type(f) not in (GpuTypeFilter, HealthFilter)]
        defaults = sorted(type(f).__name__ for f in filters
                          if type(f) in (GpuTypeFilter, HealthFilter))
        if defaults == ["GpuTypeFilter", "HealthFilter"]:
            pool = snap.candidate_pool(int(job.gpu_type), zone)
            default = not extras
            for f in extras:
                pool = pool & np.asarray(f.mask(job, snap, zone),
                                         dtype=bool)
        else:
            # Drain windows are structural, like the zone selector: a
            # draining node must never be placed on, even by a custom
            # Filter chain that dropped the default HealthFilter.
            pool = ~snap.node_draining
            for f in filters:
                pool = pool & np.asarray(f.mask(job, snap, zone),
                                         dtype=bool)
            if zone == "zone":
                pool = pool & snap.inference_zone
            elif zone == "general":
                pool = pool & ~snap.inference_zone
            default = False
        return pool, default

    def _run_pass(self, job: Job, snap: Snapshot, pass_: PlacementPass,
                  profile: SchedulingProfile,
                  ctx: Optional[SchedulingContext],
                  capture: Optional[Dict] = None) -> ScheduleResult:
        topo = self.topology
        obs = self.obs
        with obs_phase(obs, "filter"):
            pool, default_pool = self._resolve_pool(job, snap, profile,
                                                    pass_.zone)
        pa: Optional[Dict] = None
        if capture is not None:
            pa = {"zone": pass_.zone, "reason": "",
                  "filters": self._audit_filters(job, snap, profile,
                                                 pass_.zone),
                  "pool": int(np.count_nonzero(pool)), "breakdown": None,
                  "colocate_per_pod": 0.0}
            capture["passes"].append(pa)

        def fail(reason: str) -> ScheduleResult:
            if pa is not None:
                pa["reason"] = reason
            return ScheduleResult(None, reason)

        if not pool.any():
            return fail("empty node pool")

        # Subset scoring (million-node core): with a default Filter
        # chain and no audit capture, Level 1 runs on
        # snapshot-maintained per-group aggregates and Level 2 touches
        # only the selected groups' member nodes — exact-identical to
        # the full-width pass (tests/test_scale.py), but per-attempt
        # cost scales with the job's group footprint, not cluster size.
        use_subset = (default_pool and self.config.subset_scoring
                      and self.config.batched_gang
                      and capture is None)

        # --- Level 1: NodeNetGroup preselection (§3.4.2) ---------------
        gt = int(job.gpu_type)
        with obs_span(obs, "level1"):
            if use_subset:
                pod_slots = None
                group_slots = self._group_slots_cached(
                    snap, gt, pass_.zone, job.gpus_per_pod)
                group_free = self._group_free_cached(snap, gt, pass_.zone)
                group_used_i = self._group_used_cached(snap, gt,
                                                       pass_.zone)
            else:
                pod_slots = np.where(pool,
                                     snap.free_gpus // job.gpus_per_pod, 0)
                group_slots = group_free = group_used_i = None
            group_term = self._group_score_terms(job, snap, pool, pass_,
                                                 ctx)
            selected_groups = self._preselect_groups(
                job, snap, pool, pod_slots, pass_.enhanced, pass_.spread,
                group_term, group_slots=group_slots, group_free=group_free,
                group_used=group_used_i)
        if selected_groups is None:
            return fail("no NodeNetGroup set satisfies job")
        # One gather resolves both group membership and the per-node
        # anchor-group preference (rank table over groups -> node axis).
        group_pref = np.zeros(topo.n_leaf_groups, dtype=np.float32)
        for rank, g in enumerate(selected_groups):
            group_pref[g] = 1.0 / (1.0 + rank)

        # --- Level 2: node selection within selected groups ------------
        # Score chain: fused weights go through the shared kernel pass;
        # snapshot-static extra terms are added on top; pod-dependent
        # bonuses fold into the slot chains (see framework.api contract).
        weights = combine_weights(
            w for w in (s.fused_weights(job) for s in pass_.scorers)
            if w is not None)
        colocate = sum(s.per_pod_bonus(job) for s in pass_.scorers
                       if s.pod_dependent)
        cap_key = ("group_cap", gt, pass_.zone)
        group_cap = snap.derived.get(cap_key) if default_pool else None
        if group_cap is None:
            # Healthy capacity per group is delta-invariant -> cacheable
            # for the rest of the cycle (default pools only: custom
            # Filter chains may shape the pool per job).
            group_cap = np.bincount(
                topo.leaf_id,
                weights=np.where(pool, snap.healthy_per_node(), 0),
                minlength=topo.n_leaf_groups).astype(np.float32)
            if default_pool:
                snap.derived[cap_key] = group_cap
        if use_subset:
            group_used = group_used_i.astype(np.float32)
        else:
            group_used = np.bincount(
                topo.leaf_id, weights=np.where(pool, snap.used_gpus, 0),
                minlength=topo.n_leaf_groups).astype(np.float32)
        group_load = group_used / np.maximum(group_cap, 1.0)
        extra = self._extra_score_terms(job, snap, pool, pass_, ctx)
        score_out = {} if pa is not None else None
        with obs_phase(obs, "score"):
            if use_subset:
                gload_nodes = topo_pref = None
                nodes = self._select_nodes_subset(
                    job, snap, pool, selected_groups, group_pref,
                    group_load, weights, colocate, extra)
            else:
                # topo_pref prefers earlier-ranked (anchor) groups,
                # keeping a multi-pod job inside as few groups as
                # possible (§3.3.3 LeafGroup E-Binpack).
                topo_pref = group_pref[topo.leaf_id]
                in_groups = topo_pref > 0.0
                gload_nodes = group_load[topo.leaf_id]
                if self.config.batched_gang:
                    nodes = self._select_nodes_batched(
                        job, snap, pool & in_groups, gload_nodes,
                        topo_pref, weights, colocate,
                        np.where(in_groups, pod_slots, 0), extra,
                        score_out)
                else:
                    nodes = self._select_nodes_sequential(
                        job, snap, pool, in_groups, gload_nodes,
                        topo_pref, weights, colocate, extra)
        if nodes is None:
            return fail("gang placement failed")
        if pa is not None:
            pa["reason"] = "ok"
            pa["colocate_per_pod"] = float(colocate)
            if score_out and "scores" in score_out:
                pa["breakdown"] = self._audit_breakdown(
                    job, snap, pass_, pool, gload_nodes, topo_pref,
                    score_out["scores"], nodes, ctx)

        # --- Fine-grained device selection per chosen slot (§3.3.1) ----
        # One vectorized gather extracts the availability rows of the
        # selected nodes; the per-pod work is then pure python over
        # G-sized lists (no per-pod numpy dispatch, no full-bitmap copy).
        with obs_span(obs, "devices"):
            uniq = list(dict.fromkeys(nodes))
            avail_rows = (~snap.gpu_busy[uniq]
                          & snap.gpu_healthy[uniq]).tolist()
            avail_map = dict(zip(uniq, avail_rows))
            pods: List[PodPlacement] = []
            for node in nodes:
                avail = avail_map[node]
                gpus = self._pick_from_avail(avail, job.gpus_per_pod)
                if gpus is None:
                    return fail("device-level selection failed")
                for g in gpus:
                    avail[g] = False
                pods.append(PodPlacement(node=node, gpu_indices=gpus,
                                         nic=self._nic_list[gpus[0]]))
        placement = Placement(pods=pods)
        n_groups = len({int(topo.leaf_id[p.node]) for p in pods})
        return ScheduleResult(placement, "ok", groups_used=n_groups)

    def _group_score_terms(self, job: Job, snap: Snapshot,
                           pool: np.ndarray, pass_: PlacementPass,
                           ctx: Optional[SchedulingContext]
                           ) -> Optional[np.ndarray]:
        """Sum of Score-plugin group-level terms biasing Level-1
        preselection (None in the default profiles -> zero overhead)."""
        total: Optional[np.ndarray] = None
        for s in pass_.scorers:
            term = s.group_score(job, snap, pool, ctx)
            if term is None:
                continue
            term = np.asarray(term, dtype=np.float64)
            total = term if total is None else total + term
        return total

    def _extra_score_terms(self, job: Job, snap: Snapshot,
                           pool: np.ndarray, pass_: PlacementPass,
                           ctx: Optional[SchedulingContext]
                           ) -> Optional[np.ndarray]:
        """Sum of snapshot-static Score-plugin terms outside the fused
        weight vector (None in the default profiles -> zero overhead)."""
        total: Optional[np.ndarray] = None
        for s in pass_.scorers:
            if s.pod_dependent:
                continue
            term = s.score(job, snap, pool, ctx)
            if term is None:
                continue
            term = np.asarray(term, dtype=np.float32)
            total = term if total is None else total + term
        return total

    # ------------------------------------------------------------------
    # Decision-audit capture (repro_torch.obs; only runs with an observer on)
    # ------------------------------------------------------------------
    def _audit_filters(self, job: Job, snap: Snapshot,
                       profile: SchedulingProfile, zone: Optional[str]
                       ) -> List[tuple]:
        """Replay the Filter chain sequentially, counting the nodes each
        stage eliminates — `(plugin, before, after)` tuples, including
        the structural stages (drain windows, the zone selector).

        The default GpuTypeFilter+HealthFilter chain is job-independent
        given ``(gpu_type, zone)``, so its replay is cached per cycle in
        ``snap.derived`` (cleared on health mutations) — the audit then
        costs one dict hit per placement attempt, not an O(n) rescan."""
        filters = profile.filters
        key = None
        if all(type(f) in (GpuTypeFilter, HealthFilter) for f in filters):
            key = ("obs_fstats", int(job.gpu_type), zone)
            cached = snap.derived.get(key)
            if cached is not None:
                return cached
        pool = ~snap.node_draining
        after = int(np.count_nonzero(pool))
        stats = [("drain", int(pool.size), after)]
        for f in filters:
            before = after
            pool = pool & np.asarray(f.mask(job, snap, zone), dtype=bool)
            after = int(np.count_nonzero(pool))
            stats.append((f.name, before, after))
        if zone == "zone":
            pool = pool & snap.inference_zone
            stats.append(("inference-zone", after,
                          int(np.count_nonzero(pool))))
        elif zone == "general":
            pool = pool & ~snap.inference_zone
            stats.append(("general-zone", after,
                          int(np.count_nonzero(pool))))
        if key is not None:
            snap.derived[key] = stats
        return stats

    def _audit_breakdown(self, job: Job, snap: Snapshot,
                         pass_: PlacementPass, pool: np.ndarray,
                         gload_nodes: np.ndarray, topo_pref: np.ndarray,
                         scores: np.ndarray, nodes: List[int],
                         ctx: Optional[SchedulingContext]) -> Dict:
        """Raw capture for the per-ScorePlugin decomposition of the
        fused score at each distinct bound node.  Mirrors
        :func:`node_scores_np`'s inputs term by term, so per node the
        lifted terms sum to the captured fused score (float32 rounding
        aside).  The audit layer does the term arithmetic and the
        per-node pivot lazily, on first ``decision.passes`` read —
        this function is on the bind hot path (≤5% attached-overhead
        budget in ``benchmarks/obs_bench.py``)."""
        idx = np.fromiter(dict.fromkeys(nodes), dtype=np.intp)
        # Capture = gathers only.  Small per-node copies of the fused
        # kernel's inputs (snapshot rows mutate after the bind; the
        # full gload/topo/score arrays must not be pinned by the audit
        # ring) plus the scorers' weight rows; the per-plugin term
        # arithmetic happens lazily in the audit layer's lift.  Arrays
        # stay ndarrays: one GC-tracked object per field instead of
        # O(nodes) boxed floats, so a long attached run does not
        # inflate collector scans.
        weights: List[tuple] = []
        extra: Dict[str, np.ndarray] = {}
        for s in pass_.scorers:
            w = s.fused_weights(job)
            if w is not None:
                weights.append((s.name, w.used, w.fit, w.group, w.topo))
            if s.pod_dependent:
                continue
            term = s.score(job, snap, pool, ctx)
            if term is not None:
                prev = extra.get(s.name)
                term = np.asarray(term)[idx]
                extra[s.name] = term if prev is None else prev + term
        return {"nodes": idx,
                "used": snap.used_gpus[idx],
                "free": snap.free_gpus[idx],
                "gload": np.asarray(gload_nodes)[idx],
                "tpref": np.asarray(topo_pref)[idx],
                "totals": scores[idx],
                "g": float(self.topology.gpus_per_node),
                "request": float(job.gpus_per_pod),
                "weights": weights,
                "extra": extra}

    # ------------------------------------------------------------------
    # Node selection: batched (one fused pass) vs sequential (per pod)
    # ------------------------------------------------------------------
    def _select_nodes_batched(self, job: Job, snap: Snapshot,
                              mask: np.ndarray, gload_nodes: np.ndarray,
                              topo_pref: np.ndarray, weights: ScoreWeights,
                              colocate: float,
                              slots: Optional[np.ndarray] = None,
                              extra: Optional[np.ndarray] = None,
                              score_out: Optional[Dict] = None
                              ) -> Optional[List[int]]:
        """Whole-gang placement from ONE filter+score pass (§3.4).

        The fused pass scores every node once; capacity expansion turns
        each node into ``floor(free/gpus_per_pod)`` pod slots and the
        heap-based top-k selection emulates the sequential argmax loop
        exactly (same nodes, same order, same tie-breaking).
        """
        backend = self.config.score_backend
        if backend == "np":
            scores = node_scores_np(
                snap.free_gpus, snap.used_gpus, mask, gload_nodes,
                topo_pref, job.gpus_per_pod, self.topology.gpus_per_node,
                weights)
        else:
            scores, slots = compute_node_scores_and_slots(
                snap.free_gpus, snap.used_gpus, mask, gload_nodes,
                topo_pref, job.gpus_per_pod, self.topology.gpus_per_node,
                weights, backend=backend, device=self.device)
        if extra is not None:
            scores = np.where(scores > NEG_INF, scores + extra, scores)
        if score_out is not None:
            # By reference — the audit breakdown reads a handful of
            # entries; no copy on the scheduling path.
            score_out["scores"] = scores
        return select_gang_slots(
            scores, snap.free_gpus, job.gpus_per_pod, job.n_pods,
            fit_weight=weights.fit, colocate_bonus=colocate, slots=slots,
            engine=self.config.slot_engine, device=self.device)

    def _select_nodes_subset(self, job: Job, snap: Snapshot,
                             pool: np.ndarray, selected_groups: List[int],
                             group_pref: np.ndarray,
                             group_load: np.ndarray,
                             weights: ScoreWeights, colocate: float,
                             extra: Optional[np.ndarray] = None
                             ) -> Optional[List[int]]:
        """Batched gang placement over ONLY the selected groups' member
        nodes (subset scoring).  Exact-identical to the full-width
        batched pass: every score term is elementwise, nodes outside the
        selected groups contribute zero slots there, and the ascending
        subset preserves the lowest-node-index tie rule — so the fused
        scores, candidate set and emission order all coincide.
        """
        sub = self._members_of_groups(selected_groups)
        leaf_sub = self.topology.leaf_id[sub]
        mask = pool[sub]
        free_sub = snap.free_gpus[sub]
        backend = self.config.score_backend
        if backend == "np":
            scores = node_scores_np(
                free_sub, snap.used_gpus[sub], mask, group_load[leaf_sub],
                group_pref[leaf_sub], job.gpus_per_pod,
                self.topology.gpus_per_node, weights)
            slots = np.where(mask, free_sub // job.gpus_per_pod,
                             0).astype(np.int64)
        else:
            scores, slots = compute_node_scores_and_slots(
                free_sub, snap.used_gpus[sub], mask, group_load[leaf_sub],
                group_pref[leaf_sub], job.gpus_per_pod,
                self.topology.gpus_per_node, weights, backend=backend,
                device=self.device)
        if extra is not None:
            ex = np.asarray(extra, dtype=np.float32)[sub]
            scores = np.where(scores > NEG_INF, scores + ex, scores)
        order = select_gang_slots(
            scores, free_sub, job.gpus_per_pod, job.n_pods,
            fit_weight=weights.fit, colocate_bonus=colocate, slots=slots,
            engine=self.config.slot_engine, device=self.device)
        if order is None:
            return None
        return [int(sub[p]) for p in order]

    def _select_nodes_sequential(self, job: Job, snap: Snapshot,
                                 pool: np.ndarray, in_groups: np.ndarray,
                                 gload_nodes: np.ndarray,
                                 topo_pref: np.ndarray,
                                 weights: ScoreWeights,
                                 colocate: float,
                                 extra: Optional[np.ndarray] = None
                                 ) -> Optional[List[int]]:
        """The replaced O(n_pods × n_nodes) loop: full filter+score pass
        and argmax once per pod, with the per-pod co-location sweep.
        Kept verbatim as the A/B baseline the batched engine is measured
        against in ``benchmarks/sched_scale_bench.py``."""
        free = snap.free_gpus.copy()        # mutated as pods are placed
        backend = self.config.score_backend
        nodes: List[int] = []
        for _ in range(job.n_pods):
            mask = pool & in_groups
            scores = compute_node_scores(
                free, snap.used_gpus + 0, mask, gload_nodes, topo_pref,
                job.gpus_per_pod, self.topology.gpus_per_node, weights,
                backend=backend, device=self.device)
            if extra is not None:
                scores = np.where(scores > NEG_INF, scores + extra, scores)
            if colocate and nodes:
                for n in nodes:
                    if scores[n] > NEG_INF:
                        scores[n] += colocate
            node = int(np.argmax(scores))
            if scores[node] <= NEG_INF:
                return None
            free[node] -= job.gpus_per_pod
            nodes.append(node)
        return nodes

    # ------------------------------------------------------------------
    def _preselect_groups(self, job: Job, snap: Snapshot, pool: np.ndarray,
                          pod_slots: Optional[np.ndarray], enhanced: bool,
                          spread: bool,
                          group_term: Optional[np.ndarray] = None,
                          group_slots: Optional[np.ndarray] = None,
                          group_free: Optional[np.ndarray] = None,
                          group_used: Optional[np.ndarray] = None
                          ) -> Optional[List[int]]:
        """Pick an ordered list of candidate NodeNetGroups.

        * small job + enhanced binpack: busiest group that still fits
          (consolidate, keep empty groups reserved for large jobs);
        * spread passes: all groups, emptiest first;
        * large jobs: greedy minimal set of groups, preferring same-spine
          neighbours (JTTED: fewest groups, closest topology).

        ``pod_slots`` is the per-node capacity expansion
        ``floor(free / gpus_per_pod)`` restricted to the pool; subset
        scoring passes ``None`` and supplies precomputed per-group
        ``group_slots``/``group_free``/``group_used`` aggregates (the
        snapshot-maintained TrackedGroupSum totals — identical values to
        the legacy bincounts) instead.  ``group_term`` (Score plugins'
        group-level contribution) ranks above the pass's default keys;
        ties fall through to them.
        """
        topo = self.topology
        if group_slots is None:
            group_slots = np.bincount(
                topo.leaf_id, weights=pod_slots,
                minlength=topo.n_leaf_groups).astype(int)
        candidates = np.nonzero(group_slots > 0)[0]
        if len(candidates) == 0:
            return None

        if group_slots.sum() < job.n_pods:
            return None

        fits_one = candidates[group_slots[candidates] >= job.n_pods]
        if len(fits_one) > 0:
            # Only the best-ranked group is used; lexsort the (reversed)
            # key tuples instead of a python sort with lambda keys.
            if spread:
                if group_free is None:
                    group_free = np.bincount(
                        topo.leaf_id,
                        weights=np.where(pool, snap.free_gpus, 0),
                        minlength=topo.n_leaf_groups).astype(int)
                # Spread wants room: emptiest group first.
                keys = (fits_one, -group_free[fits_one])
            else:
                if group_used is None:
                    group_used = np.bincount(
                        topo.leaf_id,
                        weights=np.where(pool, snap.used_gpus, 0),
                        minlength=topo.n_leaf_groups).astype(int)
                if enhanced:
                    if group_free is None:
                        group_free = np.bincount(
                            topo.leaf_id,
                            weights=np.where(pool, snap.free_gpus, 0),
                            minlength=topo.n_leaf_groups).astype(int)
                    # LeafGroup-level E-Binpack: busiest group that fits.
                    keys = (fits_one, group_free[fits_one],
                            -group_used[fits_one])
                else:
                    # Plain binpack is node-level only: first fitting group
                    # by best node score; approximate with most-used group
                    # too but without reserving empties (same order,
                    # documented).
                    keys = (fits_one, -group_used[fits_one])
            if group_term is not None:
                # lexsort: last key is primary -> plugin term outranks
                # the default ranking, defaults break ties.
                keys = keys + (-group_term[fits_one],)
            return [int(fits_one[np.lexsort(keys)[0]])]

        # Multi-group job: greedy cover minimizing group count, preferring
        # same-spine neighbours of the seed group (topology-aware §3.3.5).
        seed_keys = (candidates, -group_slots[candidates])
        if group_term is not None:
            seed_keys = seed_keys + (-group_term[candidates],)
        seed = int(candidates[np.lexsort(seed_keys)[0]])
        group_spine = self._group_spine
        rest = candidates[candidates != seed]
        rest_keys = (rest, -group_slots[rest],
                     group_spine[rest] != group_spine[seed])
        if group_term is not None:
            rest_keys = rest_keys + (-group_term[rest],)
        rest = rest[np.lexsort(rest_keys)]
        # Greedy prefix: smallest set of groups whose slot total covers the
        # job (fits_one was empty, so the seed alone never suffices).
        covered = int(group_slots[seed]) + np.cumsum(group_slots[rest])
        cut = int(np.searchsorted(covered, job.n_pods)) + 1
        if cut > len(rest):
            return None
        return [seed] + [int(g) for g in rest[:cut]]

    # ------------------------------------------------------------------
    # Fine-grained device selection (§3.3.1)
    # ------------------------------------------------------------------
    def _pick_devices(self, busy_row: np.ndarray, healthy_row: np.ndarray,
                      k: int) -> Optional[Tuple[int, ...]]:
        """Choose ``k`` healthy free GPU slots minimizing link-class cost
        on one node row (see :meth:`_pick_from_avail`)."""
        return self._pick_from_avail(
            (~busy_row & healthy_row).tolist(), k)

    def _pick_from_avail(self, avail: List[bool], k: int
                         ) -> Optional[Tuple[int, ...]]:
        """Choose ``k`` available GPU slots minimizing link-class cost.

        Preference order: a single NVLink island (intra-island link class
        is 0, so the first island that fits is already cost-minimal),
        then best-effort fill in (island, slot) order.  Pure python over
        the G-sized row: this runs once per placed pod, and numpy call
        dispatch dominated the old implementation at G=8.
        """
        nic = self._nic_list
        members: List[List[int]] = [[] for _ in range(self._n_islands)]
        n_avail = 0
        for g, a in enumerate(avail):
            if a:
                members[nic[g]].append(g)
                n_avail += 1
        if n_avail < k:
            return None
        for m in members:
            if len(m) >= k:
                return tuple(m[:k])
        # No single island fits: greedy fill in (island, slot) order.
        flat = [g for m in members for g in m]
        return tuple(flat[:k])
