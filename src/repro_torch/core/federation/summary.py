"""The per-cluster summary matrix routing decisions are vectorized over.

GSCH must stay O(members) per job: a routing decision reads this
summary, never a member's node arrays.  :func:`summarize` is the one
place that walks member state — O(total nodes), vectorized, and run at
most once per ``GSCHConfig.summary_max_age_s`` window — so the per-job
cost is a handful of (M,)- and (M, T)-shaped array ops.

Matrix semantics (M members × T GPU types, T = the federation-wide type
union; a member without some pool has zero capacity in that column):

* ``free`` / ``capacity``     — free and healthy-total GPUs per pool;
* ``max_node_free`` / ``max_node_cap`` — best single node per pool
  (a pod needs ``gpus_per_pod`` on ONE node, and members differ in
  ``gpus_per_node``: an 8-GPU pod structurally cannot land on a
  4-GPU-per-node member);
* ``group_headroom``          — largest per-LeafGroup free-GPU count
  (gang locality headroom, §3.4.2);
* ``queue_depth`` / ``pending_gang_gpus`` — member backlog pressure;
* ``frag``                    — fragmented-node fraction (§4.3 GFR);
* ``cost`` / ``capability``   — the member's routing traits per pool;
* ``committed``               — GPUs routed since this refresh; charged
  by :meth:`commit` so that batch-routing between refreshes does not
  dog-pile one member.

The core fit/load matrices are computed eagerly; the pressure signals
(``frag``, ``queue_depth``, ``pending_gang_gpus``, ``group_headroom``)
are computed lazily on first access and cached — a routing chain that
never reads them (e.g. quota-fit + least-loaded) pays nothing for them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..job import Job, JobState
from .member import MemberCluster


class FederationSummary:
    def __init__(self, t: float, gpu_types: List[int],
                 regions: List[str], free: np.ndarray,
                 capacity: np.ndarray, max_node_free: np.ndarray,
                 max_node_cap: np.ndarray, cost: np.ndarray,
                 capability: np.ndarray,
                 members: Sequence[MemberCluster]) -> None:
        self.t = float(t)
        self.gpu_types = gpu_types
        self.regions = regions
        self.free = free                      # (M, T) int64
        self.capacity = capacity              # (M, T) int64
        self.max_node_free = max_node_free    # (M, T) int64
        self.max_node_cap = max_node_cap      # (M, T) int64
        self.cost = cost                      # (M, T) float64
        self.capability = capability          # (M, T) float64
        self.committed = np.zeros_like(free)  # (M, T) int64, mutable
        self.members = members
        self._col: Dict[int, int] = {tp: i
                                     for i, tp in enumerate(gpu_types)}
        self._frag: Optional[np.ndarray] = None
        self._queue_depth: Optional[np.ndarray] = None
        self._pending_gang: Optional[np.ndarray] = None
        self._group_headroom: Optional[np.ndarray] = None

    @property
    def n_members(self) -> int:
        return self.free.shape[0]

    def col(self, gpu_type: int) -> Optional[int]:
        return self._col.get(int(gpu_type))

    # ------------------------------------------------------------------
    # Lazy pressure signals (cached; see module docstring)
    # ------------------------------------------------------------------
    @property
    def frag(self) -> np.ndarray:
        """(M,) fragmented-node fraction per member."""
        if self._frag is None:
            out = np.zeros(self.n_members)
            for i, m in enumerate(self.members):
                healthy = int(m.state.node_healthy.sum())
                out[i] = (int(m.state.fragmented_nodes().sum()) / healthy
                          if healthy else 0.0)
            self._frag = out
        return self._frag

    @frag.setter
    def frag(self, value: np.ndarray) -> None:
        self._frag = np.asarray(value, dtype=float)

    @property
    def queue_depth(self) -> np.ndarray:
        """(M,) pending-job count per member."""
        if self._queue_depth is None:
            self._queue_depth = np.asarray(
                [m.qsch.queue_depth() for m in self.members],
                dtype=np.int64)
        return self._queue_depth

    @property
    def pending_gang_by_type(self) -> np.ndarray:
        """(M, T) GPUs requested by pending jobs per member per pool —
        the backlog that competes with a spilled job for one pool's
        free capacity (a type-1 backlog says nothing about type-0
        headroom)."""
        if self._pending_gang is None:
            out = np.zeros_like(self.free)
            for i, m in enumerate(self.members):
                for q in m.qsch.queues.values():
                    for j in q:
                        if j.state is not JobState.PENDING:
                            continue
                        c = self.col(j.gpu_type)
                        if c is not None:
                            out[i, c] += j.n_gpus
            self._pending_gang = out
        return self._pending_gang

    @property
    def pending_gang_gpus(self) -> np.ndarray:
        """(M,) total GPUs requested by pending jobs per member."""
        return self.pending_gang_by_type.sum(axis=1)

    @property
    def group_headroom(self) -> np.ndarray:
        """(M, T) largest per-LeafGroup free-GPU count per pool."""
        if self._group_headroom is None:
            out = np.zeros_like(self.free)
            for i, m in enumerate(self.members):
                state = m.state
                node_free = state.free_gpus()
                leaf_id = state.topology.leaf_id
                for tp in np.unique(state.gpu_type):
                    c = self.col(int(tp))
                    if c is None:
                        continue
                    pool_free = np.where(state.pool_mask(int(tp)),
                                         node_free, 0)
                    out[i, c] = int(np.bincount(
                        leaf_id, weights=pool_free,
                        minlength=state.topology.n_leaf_groups).max())
            self._group_headroom = out
        return self._group_headroom

    # ------------------------------------------------------------------
    # Vectorized per-job views (each O(members))
    # ------------------------------------------------------------------
    def structural_fit(self, job: Job) -> np.ndarray:
        """Members that could EVER host the job: enough healthy pool
        capacity and a node model large enough for one pod."""
        c = self.col(job.gpu_type)
        if c is None:
            return np.zeros(self.n_members, dtype=bool)
        return ((self.capacity[:, c] >= job.n_gpus)
                & (self.max_node_cap[:, c] >= job.gpus_per_pod))

    def immediate_fit(self, job: Job) -> np.ndarray:
        """Members with enough free capacity to place the job *now*
        (modulo fragmentation), net of routing commitments."""
        c = self.col(job.gpu_type)
        if c is None:
            return np.zeros(self.n_members, dtype=bool)
        free_now = self.free[:, c] - self.committed[:, c]
        return ((free_now >= job.n_gpus)
                & (self.max_node_free[:, c] >= job.gpus_per_pod))

    def free_fraction(self, gpu_type: int) -> np.ndarray:
        """(M,) free/capacity in one pool (0 where the pool is absent),
        net of commitments — the least-loaded routing signal."""
        c = self.col(gpu_type)
        if c is None:
            return np.zeros(self.n_members)
        cap = np.maximum(self.capacity[:, c], 1)
        free_now = np.maximum(self.free[:, c] - self.committed[:, c], 0)
        return free_now / cap

    def commit(self, member: int, job: Job) -> None:
        """Charge a routing decision against the cached free view."""
        c = self.col(job.gpu_type)
        if c is not None:
            self.committed[member, c] += job.n_gpus


def summarize(members: Sequence[MemberCluster], t: float = 0.0,
              gpu_types: Optional[Sequence[int]] = None
              ) -> FederationSummary:
    """Build the summary matrix — the only node-array walk in GSCH."""
    if gpu_types is None:
        types = sorted({int(tp) for m in members
                        for tp in np.unique(m.state.gpu_type)})
    else:
        types = [int(tp) for tp in gpu_types]
    col = {tp: i for i, tp in enumerate(types)}
    m_n, t_n = len(members), len(types)
    free = np.zeros((m_n, t_n), dtype=np.int64)
    capacity = np.zeros((m_n, t_n), dtype=np.int64)
    max_node_free = np.zeros((m_n, t_n), dtype=np.int64)
    max_node_cap = np.zeros((m_n, t_n), dtype=np.int64)
    cost = np.zeros((m_n, t_n))
    capability = np.zeros((m_n, t_n))
    for i, m in enumerate(members):
        state = m.state
        node_free = state.free_gpus()
        node_cap = np.where(state.node_healthy,
                            state.healthy_counts(), 0)
        for tp in np.unique(state.gpu_type):
            c = col.get(int(tp))
            if c is None:
                continue
            pool = state.pool_mask(int(tp))
            pool_free = np.where(pool, node_free, 0)
            pool_cap = np.where(pool, node_cap, 0)
            free[i, c] = int(pool_free.sum())
            capacity[i, c] = int(pool_cap.sum())
            max_node_free[i, c] = int(pool_free.max())
            max_node_cap[i, c] = int(pool_cap.max())
            cost[i, c] = m.cost_per_gpu_hour.get(int(tp), 0.0)
            capability[i, c] = m.capability.get(int(tp), 1.0)
    return FederationSummary(
        t=t, gpu_types=types, regions=[m.region for m in members],
        free=free, capacity=capacity,
        max_node_free=max_node_free, max_node_cap=max_node_cap,
        cost=cost, capability=capability, members=members)
