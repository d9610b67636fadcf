"""Scheduler snapshots: full deep copy vs incremental update (paper §3.4.3).

Before each scheduling cycle the scheduler works on a consistent copy of
the cluster state so in-flight mutations don't corrupt decisions.  The
naive approach deep-copies everything each cycle; Kant's RSCH instead
maintains a long-lived snapshot and copies only the rows dirtied since the
last cycle.  The paper reports >50 % scheduler CPU reduction on a
1 000-node cluster; ``benchmarks/snapshot_bench.py`` reproduces the
comparison and ``tests/test_snapshot.py`` property-checks equivalence.

Snapshots share the :class:`~repro_torch.core.columns.StateColumns` layout with
the live :class:`~repro_torch.core.cluster.ClusterState`, so a full take is one
column-block copy and an incremental take is a dirty-row copy of the same
block (``copy_rows_from``) — never a per-field rebuild.  On top of the
block the snapshot keeps three cache layers, all keyed to the §3.4
optimizations:

* ``_pool_cache`` — §3.4.1 GPU-Type node-pool masks (delta-invariant);
* ``derived`` — scratch for delta-invariant derived arrays (per-group
  healthy capacity, observability stats);
* ``tracked`` — **row-patchable** per-NodeNetGroup aggregates
  (:class:`TrackedGroupSum`).  Unlike ``derived``, these survive
  placement deltas: a delta queues its rows on every sum, and
  :meth:`Snapshot.tracked_sum` patches a sum over the rows queued since
  its last read, in O(dirty rows), instead of dropping it, which is what
  makes RSCH preselection O(groups) instead of O(nodes) at 100k+ nodes.
"""

from __future__ import annotations

from typing import (Callable, Collection, Dict, Hashable, Iterable, List,
                    Optional)

import numpy as np

from .cluster import ClusterState, delta_commit, write_busy
from .columns import StateColumns
from .job import Placement


class TrackedGroupSum:
    """A per-group integer aggregate patched row-wise on snapshot deltas.

    ``contrib_fn(snap, idx)`` returns each node's integer contribution to
    its leaf group's total (for ``idx=None``: all nodes).  The totals are
    maintained exactly: contributions are small non-negative integers
    (bounded by gpus_per_node × nodes_per_leaf), so the ``np.add.at``
    patch arithmetic is exact in int64 and a patched total always equals
    a from-scratch ``bincount`` (asserted in tests/test_scale.py and
    tests/test_torch_commit_delta.py).  ``pending`` holds the rows
    changed since the last patch, repeats allowed.
    """

    def __init__(self, leaf_id: np.ndarray, n_groups: int,
                 contrib_fn: Callable[["Snapshot", Optional[np.ndarray]],
                                      np.ndarray],
                 snap: "Snapshot") -> None:
        self.leaf_id = leaf_id
        self.contrib_fn = contrib_fn
        self.contrib = np.asarray(contrib_fn(snap, None), dtype=np.int64)
        self.totals = np.zeros(n_groups, dtype=np.int64)
        np.add.at(self.totals, leaf_id, self.contrib)
        self.pending: List[int] = []

    def refresh(self, snap: "Snapshot") -> None:
        """Patch the totals over the pending rows.  ``contrib_fn`` reads
        the snapshot's current columns, so one patch over their union
        equals the chain of patches, one a delta, that it replaces."""
        idx = np.array(sorted(set(self.pending)), dtype=np.int64)
        self.pending.clear()
        new = np.asarray(self.contrib_fn(snap, idx), dtype=np.int64)
        np.add.at(self.totals, self.leaf_id[idx], new - self.contrib[idx])
        self.contrib[idx] = new


class Snapshot:
    """Immutable-by-convention column block RSCH scores against.

    The one sanctioned mutation is the *placement delta*
    (:meth:`apply_placement` / :meth:`apply_release`): after QSCH commits
    a placement to the live ``ClusterState`` mid-cycle, it applies the
    same change to the working snapshot instead of re-taking a full one,
    so one scheduling cycle costs exactly one ``snapshotter.take``
    (§3.4.3 snapshot memory optimization).
    """

    def __init__(self, cols: StateColumns, version: int = 0,
                 commit_work: Optional[List[int]] = None) -> None:
        self.cols = cols
        self.version = version
        # The commit path's tally, shared with the state the snapshot
        # was taken of (``ClusterState.commit_work``).
        self.commit_work = [0, 0, 0] if commit_work is None else commit_work
        # Bumped on every row mutation folded into this snapshot.  The
        # cycle pipeline uses (id(snap), mut_count) as its optimistic-
        # concurrency fingerprint: a speculative result is reusable only
        # if the snapshot it scored against has not folded further rows.
        self.mut_count = 0
        # Cached §3.4.1 node-pool masks, keyed by (gpu_type, zone
        # selector); inputs are delta-invariant, so the cache survives
        # mid-cycle placements and is cleared on health refreshes.
        self._pool_cache: dict = {}
        # Scratch for delta-invariant derived arrays (e.g. per-group
        # healthy capacity).  Never store anything here that depends on
        # free/used/busy.
        self.derived: dict = {}
        # Row-patchable per-group aggregates (free/used/slot counts) —
        # these DO depend on busy bits and are kept current by patches
        # at their reads (``tracked_sum``) instead of invalidation.
        self.tracked: Dict[Hashable, TrackedGroupSum] = {}

    # -- column views ---------------------------------------------------
    @property
    def free_gpus(self) -> np.ndarray:
        return self.cols.free_gpus

    @property
    def used_gpus(self) -> np.ndarray:
        return self.cols.used_gpus

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
    def gpu_type(self) -> np.ndarray:
        return self.cols.gpu_type

    @property
    def inference_zone(self) -> np.ndarray:
        return self.cols.inference_zone

    @property
    def node_draining(self) -> np.ndarray:
        return self.cols.node_draining

    def healthy_per_node(self) -> np.ndarray:
        """(n_nodes,) healthy device count — a maintained column now,
        so this is a plain view rather than an O(n·G) reduction."""
        return self.cols.healthy_count

    def candidate_pool(self, gpu_type: int,
                       zone: Optional[str] = None) -> np.ndarray:
        """GPU-Type-based Node Pool mask (§3.4.1), optionally restricted
        to the inference dedicated zone (``"zone"``) or its complement
        (``"general"``).  Cached — the search-space restriction is a dict
        hit instead of two O(n) boolean passes per schedule call."""
        key = (int(gpu_type), zone)
        mask = self._pool_cache.get(key)
        if mask is None:
            mask = ((self.cols.gpu_type == gpu_type) & self.cols.node_healthy
                    & ~self.cols.node_draining)
            if zone == "zone":
                mask = mask & self.cols.inference_zone
            elif zone == "general":
                mask = mask & ~self.cols.inference_zone
            self._pool_cache[key] = mask
        return mask

    def tracked_sum(self, key: Hashable, leaf_id: np.ndarray,
                    n_groups: int,
                    contrib_fn: Callable[["Snapshot", Optional[np.ndarray]],
                                         np.ndarray]) -> np.ndarray:
        """Get-or-create a :class:`TrackedGroupSum`, patch it over the
        rows changed since its last read, and return its per-group
        totals (int64, live view — do not mutate, and read again after
        the snapshot changes: a later delta patches it at that read)."""
        cache = self.tracked.get(key)
        if cache is None:
            cache = TrackedGroupSum(leaf_id, n_groups, contrib_fn, self)
            self.tracked[key] = cache
        elif cache.pending:
            cache.refresh(self)
            self.commit_work[2] += 1
        return cache.totals

    def invalidate_caches(self) -> None:
        """Drop cached pool masks / derived arrays / tracked aggregates
        (called by the snapshotters after a health/drain refresh)."""
        self._pool_cache.clear()
        self.derived.clear()
        self.tracked.clear()

    # -- placement deltas (§3.4.3) -------------------------------------
    def apply_placement(self, placement: Placement) -> None:
        """Mark a just-committed placement's devices busy and bring the
        touched rows up to date — identical to what a fresh ``take``
        would see, because ``ClusterState.allocate`` only flips busy
        bits.  A placement of ``cluster.DELTA_MAX_PODS`` pods or fewer
        adds its counts to a row (``StateColumns.add_busy``) where this
        snapshot agrees with the state's check of the pod: node healthy,
        the pod's devices healthy and free here.  Other rows, and larger
        placements, are re-derived from the bitmaps."""
        if not delta_commit(placement):
            idx = self._refresh_rows(
                write_busy(self.cols.gpu_busy, placement, True))
            self.commit_work[1] += idx.size
            return
        cols = self.cols
        busy, healthy, up = cols.gpu_busy, cols.gpu_healthy, cols.node_healthy
        counted, stale = [], set()
        for pod in placement.pods:
            n = pod.node
            row, ok = busy[n], healthy[n]
            # Checked before the pod's bits are set, so a device that an
            # earlier pod of the placement took fails the check too.
            if up[n] and all(ok[g] and not row[g] for g in pod.gpu_indices):
                counted.append(pod)
            else:
                stale.add(n)
            for g in pod.gpu_indices:
                row[g] = True
        cols.add_busy(counted)
        rows = {p.node for p in counted}
        if stale:
            # add_busy's counts on a stale row are overwritten here
            cols.refresh_derived(np.fromiter(stale, np.int64, len(stale)))
            rows -= stale
            self.commit_work[1] += len(stale)
        self.commit_work[0] += len(rows)
        self.mut_count += 1
        self._pend(rows | stale)

    def apply_release(self, placement: Placement) -> None:
        """Inverse delta for a mid-cycle preemption/release."""
        self._refresh_rows(write_busy(self.cols.gpu_busy, placement, False))

    def apply_health(self, state: "ClusterState",
                     nodes: Iterable[int]) -> None:
        """Mirror a mid-cycle health/drain mutation of the live state.

        Unlike placement deltas, health changes are NOT delta-invariant:
        the cached §3.4.1 pool masks and every ``derived``/``tracked``
        array key on health, so they must be dropped — otherwise a
        NODE_FAIL landing between ``take`` and a later bind in the same
        cycle can place onto a dead node.
        """
        idx = np.unique(np.fromiter((int(n) for n in nodes),
                                    dtype=np.int64))
        if idx.size == 0:
            return
        self.cols.copy_rows_from(state.cols, idx, invariants=True)
        self.mut_count += 1
        self.invalidate_caches()

    def _refresh_rows(self, nodes: np.ndarray) -> np.ndarray:
        """Re-derive the rows ``nodes`` (repeats allowed) and queue them
        on the tracked sums.  Returns the distinct rows."""
        idx = np.unique(nodes)
        if idx.size == 0:
            return idx
        self.cols.refresh_derived(idx)
        self.mut_count += 1
        self._pend(idx.tolist())
        return idx

    def _pend(self, rows: Collection[int]) -> None:
        """Queue changed rows on every tracked sum for its next read.  A
        sum with more rows queued than the snapshot has nodes is dropped:
        built anew at its next read, it costs no more than the patch, and
        one no longer read holds no growing queue."""
        limit = self.cols.n_nodes
        for key, cache in list(self.tracked.items()):
            cache.pending.extend(rows)
            if len(cache.pending) > limit:
                del self.tracked[key]


class FullSnapshotter:
    """Baseline: deep copy of every column, every cycle."""

    name = "full-copy"

    def __init__(self) -> None:
        self._version = 0

    def take(self, state: ClusterState) -> Snapshot:
        self._version += 1
        # Re-derive everything from the bitmaps so direct setup writes
        # (tests/benches pre-fragmenting ``state.gpu_busy``) are folded.
        state.refresh_all_derived()
        state.dirty_nodes.clear()  # parity with the incremental path
        state.invariants_dirty = False
        return Snapshot(state.cols.copy(), version=self._version,
                        commit_work=state.commit_work)


class IncrementalSnapshotter:
    """Kant's optimization: refresh only rows dirtied since last cycle.

    The first ``take`` is a full copy; afterwards only
    ``state.dirty_nodes`` rows are copied into the retained column block.
    """

    name = "incremental"

    def __init__(self) -> None:
        self._snap: Optional[Snapshot] = None
        self._version = 0
        self.rows_copied = 0          # instrumentation for the benchmark

    def take(self, state: ClusterState) -> Snapshot:
        self._version += 1
        if self._snap is None:
            self._snap = FullSnapshotter().take(state)
            self._snap.version = self._version
            self.rows_copied += state.n_nodes
            state.dirty_nodes.clear()
            return self._snap
        snap = self._snap
        self._fold(state, snap)
        snap.version = self._version
        return snap

    def refresh(self, state: ClusterState) -> Snapshot:
        """Fold dirty rows into the retained snapshot WITHOUT bumping the
        version — the cycle pipeline's speculative refresh.  Doing this
        at the end of cycle N makes the begin-of-cycle-N+1 ``take`` a
        version bump over zero dirty rows (when nothing intervened), so
        the snapshot the pipelined path schedules against is bit-for-bit
        the one the unpipelined path would have taken."""
        if self._snap is None:
            raise RuntimeError("refresh() before first take()")
        self._fold(state, self._snap)
        return self._snap

    def _fold(self, state: ClusterState, snap: Snapshot) -> None:
        dirty = sorted(state.dirty_nodes)
        if dirty:
            idx = np.asarray(dirty, dtype=np.int64)
            # Busy rows always refresh; the delta-invariant columns
            # (health, type, zone, drain) only changed if a setter
            # raised ``state.invariants_dirty`` — placement churn flips
            # busy bits alone.  While the flag is down, the §3.4.1 pool
            # masks + ``derived`` arrays stay valid and the ``tracked``
            # aggregates queue the dirty rows instead of being dropped.
            inv = bool(state.invariants_dirty)
            snap.cols.copy_rows_from(state.cols, idx, invariants=inv)
            snap.mut_count += 1
            if inv:
                snap.invalidate_caches()
            else:
                snap._pend(dirty)
            self.rows_copied += len(dirty)
        state.dirty_nodes.clear()
        state.invariants_dirty = False


def snapshots_equal(a: Snapshot, b: Snapshot) -> bool:
    return (np.array_equal(a.free_gpus, b.free_gpus)
            and np.array_equal(a.used_gpus, b.used_gpus)
            and np.array_equal(a.gpu_busy, b.gpu_busy)
            and np.array_equal(a.gpu_healthy, b.gpu_healthy)
            and np.array_equal(a.node_healthy, b.node_healthy)
            and np.array_equal(a.gpu_type, b.gpu_type)
            and np.array_equal(a.inference_zone, b.inference_zone)
            and np.array_equal(a.node_draining, b.node_draining))
