"""Structure-of-arrays scheduler state block (million-node core).

:class:`StateColumns` is the contiguous column bundle shared by
:class:`~repro_torch.core.cluster.ClusterState` and
:class:`~repro_torch.core.snapshot.Snapshot`: node health, drain, pool type,
zone membership and the per-device busy/health bitmaps, plus the
*maintained derived* columns (free/used/busy/healthy counts and the §4.3
fragmentation mask) that every hot read used to recompute as a full
``(n_nodes × gpus_per_node)`` reduction.

Layout contract:

* every integer column is pinned to **int32** (half the copy bytes of
  the former ``np.sum`` int64 defaults at 100k+ nodes), every flag
  column to ``bool``;
* derived columns are a pure function of the bitmap columns —
  :meth:`refresh_derived` recomputes them for all rows or a dirty-row
  subset, and the sanctioned mutators of ``ClusterState`` /
  ``Snapshot._refresh_rows`` are the only writers, so dirty-row
  tracking stays sound (property-tested against a naive per-field
  reference model in ``tests/test_properties.py``);
* snapshots are column copies + dirty-row copies of this block, never
  per-field rebuilds (see :mod:`repro_torch.core.snapshot`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class StateColumns:
    """One block of contiguous numpy columns over the node axis."""

    # -- ground-truth columns (written by the sanctioned mutators) -----
    gpu_type: np.ndarray        # (n,) int32 — §3.4.1 node pools
    gpu_busy: np.ndarray        # (n, G) bool — device allocated
    gpu_healthy: np.ndarray     # (n, G) bool — device healthy (§3.3.1)
    node_healthy: np.ndarray    # (n,) bool — node schedulable at all
    inference_zone: np.ndarray  # (n,) bool — E-Spread zone (§3.3.4)
    node_draining: np.ndarray   # (n,) bool — maintenance drain window
    # -- maintained derived columns (refresh_derived is the only writer)
    free_gpus: np.ndarray       # (n,) int32: healthy & ~busy, 0 if node down
    used_gpus: np.ndarray       # (n,) int32: busy & healthy
    busy_count: np.ndarray      # (n,) int32: busy (regardless of health)
    healthy_count: np.ndarray   # (n,) int32: healthy devices per node
    fragmented: np.ndarray      # (n,) bool: §4.3 neither idle nor full

    @classmethod
    def create(cls, n_nodes: int, gpus_per_node: int,
               gpu_type: Optional[np.ndarray] = None,
               inference_zone_nodes: int = 0) -> "StateColumns":
        n, g = n_nodes, gpus_per_node
        if gpu_type is None:
            gpu_type = np.zeros(n, dtype=np.int32)
        gpu_type = np.asarray(gpu_type, dtype=np.int32)
        if gpu_type.shape != (n,):
            raise ValueError("gpu_type must have shape (n_nodes,)")
        zone = np.zeros(n, dtype=bool)
        if inference_zone_nodes:
            zone[:inference_zone_nodes] = True
        cols = cls(
            gpu_type=gpu_type,
            gpu_busy=np.zeros((n, g), dtype=bool),
            gpu_healthy=np.ones((n, g), dtype=bool),
            node_healthy=np.ones(n, dtype=bool),
            inference_zone=zone,
            node_draining=np.zeros(n, dtype=bool),
            free_gpus=np.zeros(n, dtype=np.int32),
            used_gpus=np.zeros(n, dtype=np.int32),
            busy_count=np.zeros(n, dtype=np.int32),
            healthy_count=np.zeros(n, dtype=np.int32),
            fragmented=np.zeros(n, dtype=bool),
        )
        cols.refresh_derived()
        return cols

    @property
    def n_nodes(self) -> int:
        return int(self.node_healthy.shape[0])

    # ------------------------------------------------------------------
    # Derived-column maintenance
    # ------------------------------------------------------------------
    def refresh_derived(self, idx: Optional[np.ndarray] = None) -> None:
        """Recompute the derived columns from the bitmap columns, for
        all rows (``idx=None``) or the given row subset.  The formulas
        are the single source of truth every consumer used to inline."""
        if idx is None:
            busy, healthy = self.gpu_busy, self.gpu_healthy
            nh = self.node_healthy
            view = slice(None)
        else:
            busy, healthy = self.gpu_busy[idx], self.gpu_healthy[idx]
            nh = self.node_healthy[idx]
            view = idx
        healthy_count = healthy.sum(axis=1, dtype=np.int32)
        used = (busy & healthy).sum(axis=1, dtype=np.int32)
        free = healthy_count - used
        self.healthy_count[view] = healthy_count
        self.used_gpus[view] = used
        self.busy_count[view] = busy.sum(axis=1, dtype=np.int32)
        self.free_gpus[view] = np.where(nh, free, np.int32(0))
        self.fragmented[view] = ((used > 0) & (used < healthy_count)
                                 & nh & (healthy_count > 0))

    # ------------------------------------------------------------------
    # Snapshot support: column copies + dirty-row copies
    # ------------------------------------------------------------------
    def copy(self) -> "StateColumns":
        return StateColumns(
            **{f.name: getattr(self, f.name).copy()
               for f in dataclasses.fields(StateColumns)})

    def copy_rows_from(self, src: "StateColumns", idx: np.ndarray,
                       invariants: bool) -> None:
        """Dirty-row copy (§3.4.3 incremental snapshot).

        Busy-derived columns always refresh; the *delta-invariant*
        columns (health, drain, type, zone and their derived
        ``healthy_count``) are copied only when ``invariants`` says a
        health/drain/type setter ran — placement churn flips busy bits
        alone.  Derived rows are recomputed from the just-copied bitmap
        rows (not copied), so a snapshot can never inherit drift."""
        self.gpu_busy[idx] = src.gpu_busy[idx]
        if invariants:
            self.gpu_healthy[idx] = src.gpu_healthy[idx]
            self.node_healthy[idx] = src.node_healthy[idx]
            self.gpu_type[idx] = src.gpu_type[idx]
            self.inference_zone[idx] = src.inference_zone[idx]
            self.node_draining[idx] = src.node_draining[idx]
        self.refresh_derived(idx)

    def columns_equal(self, other: "StateColumns") -> bool:
        return all(np.array_equal(getattr(self, f.name),
                                  getattr(other, f.name))
                   for f in dataclasses.fields(StateColumns))
