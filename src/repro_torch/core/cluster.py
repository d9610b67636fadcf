"""Array-native cluster resource state (paper §3.1, §3.4).

The scheduler's view of the cluster is a structure-of-arrays block
(:class:`~repro_torch.core.columns.StateColumns`) — per-node free/used/busy/
healthy counts, fragmentation, per-device busy/health bitmaps, GPU-type
ids — plus the static :class:`~repro_torch.core.topology.ClusterTopology`.
Keeping the state dense serves the paper's §3.4 optimizations directly:

* *GPU-Type-based Node Pools* (§3.4.1) are boolean masks over the node
  axis, so restricting the search space to one pool is a vectorized
  ``mask &``, not a data-structure walk;
* *incremental snapshots* (§3.4.3) reduce to copying dirty rows of the
  shared column block (see :mod:`repro_torch.core.snapshot`);
* per-node **derived columns** (free/used/busy/healthy counts, the §4.3
  fragmentation mask) are *maintained* behind the same dirty tracking
  instead of recomputed as a full ``(n_nodes × gpus_per_node)``
  reduction on every read — a metrics SAMPLE or snapshot take touches
  O(dirty) rows, not O(n·G) cells.

Mutation goes through :meth:`ClusterState.allocate` / ``release`` /
``set_*_health`` / ``set_drain`` only, so dirty-row tracking and the
allocation ledger can never drift from the arrays (property-tested in
``tests/test_properties.py``).  The one tolerated exception is *setup
writes*: tests and benchmarks may pre-fragment a fresh state by writing
``state.gpu_busy`` directly **before** the first derived read or
snapshot take — the derived columns initialize lazily on first access
(and every ``FullSnapshotter.take`` re-derives from the bitmaps), so
such writes are folded in exactly once.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from .columns import StateColumns
from .job import Job, Placement, PodPlacement
from .topology import ClusterTopology


class ClusterState:
    """Live cluster state: shared column block + allocation ledger."""

    def __init__(self, topology: ClusterTopology, cols: StateColumns,
                 allocations: Optional[Dict[int, Placement]] = None) -> None:
        self.topology = topology
        self.cols = cols
        # Allocation ledger: job uid -> placement.
        self.allocations: Dict[int, Placement] = allocations or {}
        # Nodes whose rows changed since the dirty set was last drained
        # (consumed by the incremental snapshot, §3.4.3).
        self.dirty_nodes: Set[int] = set()
        # True when a *delta-invariant* column (health, drain, type,
        # zone) changed since the last snapshot take.  Placement churn
        # only flips busy bits, so while this stays False the
        # incremental snapshotter keeps its cached §3.4.1 pool masks /
        # derived arrays and skips the invariant-row copies entirely.
        self.invariants_dirty: bool = False
        # Derived columns are refreshed lazily on first read so setup
        # code may bulk-write the bitmaps on a fresh state (see module
        # docstring); after that the mutators maintain them per-row.
        self._derived_ready = False

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------
    @classmethod
    def create(cls, topology: ClusterTopology,
               gpu_type: Optional[np.ndarray] = None,
               inference_zone_nodes: int = 0) -> "ClusterState":
        return cls(topology, StateColumns.create(
            topology.n_nodes, topology.gpus_per_node, gpu_type,
            inference_zone_nodes))

    # ------------------------------------------------------------------
    # Column views (attribute API preserved over the shared block)
    # ------------------------------------------------------------------
    @property
    def gpu_type(self) -> np.ndarray:
        return self.cols.gpu_type

    @property
    def gpu_busy(self) -> np.ndarray:
        return self.cols.gpu_busy

    @property
    def gpu_healthy(self) -> np.ndarray:
        return self.cols.gpu_healthy

    @property
    def node_healthy(self) -> np.ndarray:
        return self.cols.node_healthy

    @property
    def inference_zone(self) -> np.ndarray:
        return self.cols.inference_zone

    @property
    def node_draining(self) -> np.ndarray:
        return self.cols.node_draining

    @property
    def n_nodes(self) -> int:
        return self.topology.n_nodes

    @property
    def gpus_per_node(self) -> int:
        return self.topology.gpus_per_node

    # ------------------------------------------------------------------
    # Derived views — maintained int32/bool columns, O(1) per read
    # ------------------------------------------------------------------
    def ensure_derived(self) -> None:
        """Fold any pre-snapshot setup writes into the derived columns
        (idempotent; called by every derived read and snapshot take)."""
        if not self._derived_ready:
            self.cols.refresh_derived()
            self._derived_ready = True

    def refresh_all_derived(self) -> None:
        """Unconditional full re-derivation from the bitmaps — used by
        ``FullSnapshotter.take`` so direct setup writes are folded even
        after the lazy init already ran."""
        self.cols.refresh_derived()
        self._derived_ready = True

    def _update_rows(self, idx) -> None:
        if self._derived_ready:
            self.cols.refresh_derived(np.asarray(idx, dtype=np.int64))

    def free_gpus(self) -> np.ndarray:
        """(n_nodes,) count of healthy, unallocated devices per node."""
        self.ensure_derived()
        return self.cols.free_gpus

    def used_gpus(self) -> np.ndarray:
        self.ensure_derived()
        return self.cols.used_gpus

    def healthy_counts(self) -> np.ndarray:
        """(n_nodes,) healthy device count per node (maintained)."""
        self.ensure_derived()
        return self.cols.healthy_count

    def total_allocatable(self, gpu_type: Optional[int] = None) -> int:
        """Total healthy GPU capacity (optionally within one node pool)."""
        self.ensure_derived()
        mask = self.cols.node_healthy
        if gpu_type is not None:
            mask = mask & (self.cols.gpu_type == gpu_type)
        return int(self.cols.healthy_count[mask].sum())

    def total_allocated(self, gpu_type: Optional[int] = None) -> int:
        self.ensure_derived()
        mask = self.cols.node_healthy
        if gpu_type is not None:
            mask = mask & (self.cols.gpu_type == gpu_type)
        return int(self.cols.busy_count[mask].sum())

    def pool_mask(self, gpu_type: int) -> np.ndarray:
        """Node-pool membership mask (§3.4.1 heterogeneous splitting).
        Draining nodes are unschedulable, so they leave the pool."""
        return ((self.cols.gpu_type == gpu_type) & self.cols.node_healthy
                & ~self.cols.node_draining)

    def pool_free(self, gpu_type: int) -> int:
        """Free GPUs inside one GPU-Type-based Node Pool."""
        return int(self.free_gpus()[self.pool_mask(gpu_type)].sum())

    def group_free(self, gpu_type: int) -> np.ndarray:
        """(n_leaf_groups,) free GPUs per NodeNetGroup within a pool."""
        free = np.where(self.pool_mask(gpu_type), self.free_gpus(), 0)
        return np.bincount(self.topology.leaf_id, weights=free,
                           minlength=self.topology.n_leaf_groups
                           ).astype(np.int32)

    def group_used(self, gpu_type: int) -> np.ndarray:
        used = np.where(self.pool_mask(gpu_type), self.used_gpus(), 0)
        return np.bincount(self.topology.leaf_id, weights=used,
                           minlength=self.topology.n_leaf_groups
                           ).astype(np.int32)

    def fragmented_nodes(self) -> np.ndarray:
        """Bool mask of fragmented nodes per §4.3: neither fully idle nor
        fully occupied (w.r.t. healthy devices).  Maintained column — no
        (n × G) reduction on the metrics SAMPLE path."""
        self.ensure_derived()
        return self.cols.fragmented

    # ------------------------------------------------------------------
    # Mutation (the only entry points — keeps dirty tracking sound)
    # ------------------------------------------------------------------
    def _touch(self, nodes: Iterable[int]) -> None:
        self.dirty_nodes.update(int(n) for n in nodes)

    def allocate(self, job: Job, placement: Placement) -> None:
        """Bind a job to concrete devices.  Raises on any conflict; the
        caller (RSCH) must have validated the placement — gang semantics
        mean we never partially apply (§3.3.2)."""
        if job.uid in self.allocations:
            raise ValueError(f"job {job.uid} already allocated")
        if placement.n_gpus != job.n_gpus:
            raise ValueError("placement does not cover the job request")
        # Validate first (all-or-nothing), then apply.
        for pod in placement.pods:
            self._validate_pod(job, pod)
        for pod in placement.pods:
            self.cols.gpu_busy[pod.node, list(pod.gpu_indices)] = True
        self.allocations[job.uid] = placement
        nodes = placement.nodes
        self._touch(nodes)
        self._update_rows(nodes)

    def _validate_pod(self, job: Job, pod: PodPlacement) -> None:
        n = pod.node
        if not (0 <= n < self.n_nodes):
            raise ValueError(f"node {n} out of range")
        if not self.cols.node_healthy[n]:
            raise ValueError(f"node {n} is unhealthy")
        if self.cols.node_draining[n]:
            raise ValueError(f"node {n} is draining")
        if self.cols.gpu_type[n] != job.gpu_type:
            raise ValueError(
                f"node {n} pool {int(self.cols.gpu_type[n])} != job pool "
                f"{job.gpu_type}")
        if len(pod.gpu_indices) != job.gpus_per_pod:
            raise ValueError("pod placement size mismatch")
        idx = list(pod.gpu_indices)
        if max(idx) >= self.gpus_per_node or min(idx) < 0:
            raise ValueError("GPU index out of range")
        if self.cols.gpu_busy[n, idx].any():
            raise ValueError(f"GPU already busy on node {n}")
        if not self.cols.gpu_healthy[n, idx].all():
            raise ValueError(f"unhealthy GPU selected on node {n}")

    def release(self, job_uid: int) -> Placement:
        """Free a job's devices (completion or preemption)."""
        placement = self.allocations.pop(job_uid)
        for pod in placement.pods:
            self.cols.gpu_busy[pod.node, list(pod.gpu_indices)] = False
        nodes = placement.nodes
        self._touch(nodes)
        self._update_rows(nodes)
        return placement

    def set_gpu_health(self, node: int, gpu: int, healthy: bool) -> None:
        self.cols.gpu_healthy[node, gpu] = healthy
        self.invariants_dirty = True
        self._touch([node])
        self._update_rows([node])

    def set_node_health(self, node: int, healthy: bool) -> None:
        self.cols.node_healthy[node] = healthy
        self.invariants_dirty = True
        self._touch([node])
        self._update_rows([node])

    def set_drain(self, nodes: Iterable[int], draining: bool) -> None:
        """Open/close a planned maintenance drain window (dynamics):
        draining nodes accept no new placements but keep running work."""
        nodes = [int(n) for n in nodes]
        self.cols.node_draining[nodes] = draining
        self.invariants_dirty = True
        self._touch(nodes)
        self._update_rows(nodes)

    # ------------------------------------------------------------------
    # Failure-domain queries (dynamics subsystem)
    # ------------------------------------------------------------------
    def jobs_on(self, node: int, gpu: Optional[int] = None) -> List[int]:
        """Job uids with at least one pod on ``node`` (optionally on one
        specific device) — the blast radius of a NODE_FAIL/GPU_FAIL.
        Plain ledger scan: failures are rare events, not hot-path."""
        out: List[int] = []
        for uid, placement in self.allocations.items():
            for pod in placement.pods:
                if pod.node == node and (gpu is None
                                         or gpu in pod.gpu_indices):
                    out.append(uid)
                    break
        return out

    # ------------------------------------------------------------------
    # Invariant check (used by property tests)
    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        busy_from_ledger = np.zeros_like(self.cols.gpu_busy)
        for placement in self.allocations.values():
            for pod in placement.pods:
                idx = list(pod.gpu_indices)
                if busy_from_ledger[pod.node, idx].any():
                    raise AssertionError("double allocation in ledger")
                busy_from_ledger[pod.node, idx] = True
        if not np.array_equal(busy_from_ledger, self.cols.gpu_busy):
            raise AssertionError("gpu_busy drifted from allocation ledger")
        free = self.free_gpus()
        if (free < 0).any() or (free > self.gpus_per_node).any():
            raise AssertionError("free GPU count out of range")
        # Maintained derived columns must equal a fresh re-derivation
        # from the bitmaps (the SoA maintenance contract).
        fresh = self.cols.copy()
        fresh.refresh_derived()
        if not self.cols.columns_equal(fresh):
            raise AssertionError("derived columns drifted from bitmaps")


__all__ = ["ClusterState", "StateColumns"]
