"""A commit's count deltas and the snapshot's lazily patched group sums
(port only).

``ClusterState.allocate`` and ``Snapshot.apply_placement`` bring the
derived columns of a placement of ``cluster.DELTA_MAX_PODS`` pods or fewer
up to date by the counts it adds, and re-derive the rows of larger ones;
the snapshot re-derives a row where its own bitmaps disagree with the
state's check of the pod.  Every ``TrackedGroupSum`` queues the rows a
delta touched and is patched when read.  Seeded random sequences of
commits, releases, health and drain changes (mirrored onto the working
snapshot or left for the next take) and takes must keep, after every
step, the state's invariants, the snapshot's derived columns equal to a
re-derivation from its bitmaps, and every tracked sum, as its next read
would return it, equal to a from-scratch ``bincount``.
"""

import copy

import numpy as np
import pytest

import repro_torch.core as TC
from repro_torch.core import cluster as T_cluster

N_NODES = 48
G = 8
ZONE_NODES = 16
SIZES = (1, 2, 4, 8)
ZONES = ("zone", "general", None)


def make_cluster(snapshotter):
    topo = TC.small_topology(n_nodes=N_NODES, gpus_per_node=G,
                             nodes_per_leaf=8)
    state = TC.ClusterState.create(topo, inference_zone_nodes=ZONE_NODES)
    rsch = TC.RSCH(topo, TC.RSCHConfig(device="cpu"))
    return state, rsch, snapshotter()


def read_sums(rsch, snap, keys=None):
    """Read the tracked sums RSCH keeps for an inference cell (slots of
    every pod size over the zone, outside it and the whole pool; free and
    used over the zone and outside it) through ``tracked_sum``; with
    ``keys``, only those."""
    out = {}
    for zone in ZONES:
        for size in SIZES:
            if keys is None or ("gslots", 0, zone, size) in keys:
                out["gslots", 0, zone, size] = rsch._group_slots_cached(
                    snap, 0, zone, size)
        if zone is not None:
            if keys is None or ("gfree", 0, zone) in keys:
                out["gfree", 0, zone] = rsch._group_free_cached(snap, 0,
                                                                zone)
            if keys is None or ("gused", 0, zone) in keys:
                out["gused", 0, zone] = rsch._group_used_cached(snap, 0,
                                                                zone)
    return out


def check(state, snap):
    """The three properties, without disturbing the snapshot: each sum
    is read through ``tracked_sum`` on a copy that holds copies of the
    sums, so the real ones keep their pending rows."""
    state.check_invariants()
    fresh = snap.cols.copy()
    fresh.refresh_derived()
    assert snap.cols.columns_equal(fresh), "snapshot derived drifted"
    shadow = copy.copy(snap)
    shadow.tracked = {k: copy.deepcopy(c) for k, c in snap.tracked.items()}
    shadow.commit_work = [0, 0, 0]
    for key, cache in shadow.tracked.items():
        got = shadow.tracked_sum(key, cache.leaf_id, len(cache.totals),
                                 cache.contrib_fn)
        want = np.bincount(cache.leaf_id,
                           weights=cache.contrib_fn(snap, None),
                           minlength=len(cache.totals)).astype(np.int64)
        assert got.tolist() == want.tolist(), key


def free_slots(state):
    """(node, gpu) pairs the state would accept: healthy and free on a
    healthy node outside a drain."""
    ok = (~state.gpu_busy & state.gpu_healthy
          & (state.node_healthy & ~state.node_draining)[:, None])
    return ok


def pick_pods(rng, state, n_pods, size):
    """``n_pods`` pods of ``size`` devices on devices the state accepts,
    nodes drawn at random (several pods may share a node), or None."""
    ok = free_slots(state)
    pods = []
    for _ in range(n_pods):
        fits = np.flatnonzero(ok.sum(axis=1) >= size)
        if fits.size == 0:
            return None
        n = int(rng.choice(fits))
        gpus = rng.permutation(np.flatnonzero(ok[n]))[:size]
        ok[n, gpus] = False
        pods.append(TC.PodPlacement(node=n, gpu_indices=tuple(
            int(g) for g in gpus)))
    return pods


class Run:
    """One seeded sequence against one state and its working snapshot."""

    def __init__(self, seed, snapshotter):
        self.rng = np.random.default_rng(seed)
        self.state, self.rsch, self.snapper = make_cluster(snapshotter)
        self.snap = self.snapper.take(self.state)
        read_sums(self.rsch, self.snap)
        self.uid = 0
        self.seen = set()

    def mirror(self):
        return self.rng.random() < 0.5

    def alloc(self, n_pods, ragged=False):
        size = int(self.rng.choice(SIZES))
        pods = pick_pods(self.rng, self.state, n_pods, size)
        if pods is None:
            return
        self.uid += 1
        job = TC.Job(uid=self.uid, tenant="t", gpu_type=0, n_pods=n_pods,
                     gpus_per_pod=size, kind=TC.JobKind.INFER, gang=False)
        placement = TC.Placement(pods=pods)
        if ragged:
            # one pod a device short, another one over: the count covers
            # the job, the sizes do not, and nothing is written
            a, b = pods[0], pods[-1]
            free = np.flatnonzero(free_slots(self.state)[b.node])
            spare = [int(g) for g in free if g not in b.gpu_indices]
            if size < 2 or len(pods) < 2 or not spare:
                return
            pods[0] = TC.PodPlacement(node=a.node,
                                      gpu_indices=a.gpu_indices[:-1])
            pods[-1] = TC.PodPlacement(node=b.node, gpu_indices=(
                b.gpu_indices + (spare[0],)))
            before = (self.state.cols.copy(), dict(self.state.allocations))
            with pytest.raises(ValueError, match="size mismatch"):
                self.state.allocate(job, TC.Placement(pods=pods))
            assert self.state.cols.columns_equal(before[0])
            assert self.state.allocations == before[1]
            self.seen.add("ragged")
            return
        self.state.allocate(job, placement)
        self.snap.apply_placement(placement)
        self.seen.add("small" if T_cluster.delta_commit(placement)
                      else "gang")

    def release(self):
        if not self.state.allocations:
            return
        uid = int(self.rng.choice(sorted(self.state.allocations)))
        placement = self.state.release(uid)
        if self.mirror():
            self.snap.apply_release(placement)

    def health(self, kind):
        st = self.state
        n = int(self.rng.integers(N_NODES))
        if kind == "gpu":
            g = int(self.rng.integers(G))
            st.set_gpu_health(n, g, not st.gpu_healthy[n, g])
        elif kind == "node":
            st.set_node_health(n, not st.node_healthy[n])
        else:
            nodes = self.rng.choice(N_NODES, size=3, replace=False).tolist()
            st.set_drain(nodes, bool(self.rng.random() < 0.5))
            n = nodes
        if self.mirror():
            self.snap.apply_health(st, np.atleast_1d(n).tolist())

    def take(self):
        self.snap = self.snapper.take(self.state)
        assert self.snap.cols.columns_equal(self.state.cols)

    def read(self):
        """Read one to four of the sums, as a schedule call does."""
        every =[("gslots", 0, z, s) for z in ZONES for s in SIZES] + [
            (k, 0, z) for k in ("gfree", "gused") for z in ZONES[:2]]
        keys = [every[i] for i in self.rng.choice(
            len(every), size=int(self.rng.integers(1, 5)), replace=False)]
        read_sums(self.rsch, self.snap, keys=set(keys))

    def step(self):
        op = self.rng.choice(
            ["small", "gang", "ragged", "release", "gpu", "node", "drain",
             "take", "read"],
            p=[0.26, 0.06, 0.04, 0.24, 0.06, 0.04, 0.04, 0.08, 0.18])
        limit = T_cluster.DELTA_MAX_PODS
        if op == "small":
            self.alloc(int(self.rng.integers(1, limit + 1)))
        elif op == "gang":
            self.alloc(int(self.rng.integers(limit + 1, limit + 9)))
        elif op == "ragged":
            self.alloc(int(self.rng.integers(2, limit + 1)), ragged=True)
        elif op == "release":
            self.release()
        elif op in ("gpu", "node", "drain"):
            self.health(op)
        elif op == "take":
            self.take()
        else:
            self.read()


@pytest.mark.parametrize("snapshotter", [TC.IncrementalSnapshotter,
                                         TC.FullSnapshotter],
                         ids=["incremental", "full"])
@pytest.mark.parametrize("seed", [0, 1, 2, 2**31 + 7])
def test_random_sequences_keep_columns_and_sums_exact(seed, snapshotter):
    run = Run(seed, snapshotter)
    work0 = list(run.state.commit_work)
    for _ in range(300):
        run.step()
        check(run.state, run.snap)
    assert {"small", "gang", "ragged"} <= run.seen
    delta, rederive, patches = (a - b for a, b in
                                zip(run.state.commit_work, work0))
    assert delta > 0 and rederive > 0 and patches > 0


def _stale_gpu(state, snap, node):
    """The snapshot still holds GPU 0 unhealthy; the state healed it."""
    state.set_gpu_health(node, 0, False)
    snap.apply_health(state, [node])
    state.set_gpu_health(node, 0, True)


def _stale_node(state, snap, node):
    state.set_node_health(node, False)
    snap.apply_health(state, [node])
    state.set_node_health(node, True)


def _stale_busy(state, snap, node):
    """The state freed GPU 0 of a job the snapshot still holds busy."""
    state.allocate(TC.Job(uid=99, tenant="t", gpu_type=0, n_pods=1,
                          gpus_per_pod=1),
                   TC.Placement(pods=[TC.PodPlacement(node=node,
                                                      gpu_indices=(0,))]))
    snap.apply_placement(state.allocations[99])
    state.release(99)


@pytest.mark.parametrize("stale", [_stale_gpu, _stale_node, _stale_busy],
                         ids=["gpu_health", "node_health", "busy"])
def test_stale_snapshot_row_is_rederived(stale):
    """A pod the state accepts on a row where the snapshot disagrees
    (GPU or node unhealthy, or the device busy there) is re-derived on
    the snapshot; the placement's other row takes the count delta, and
    both the state's rows do."""
    state, rsch, snapper = make_cluster(TC.IncrementalSnapshotter)
    snap = snapper.take(state)
    read_sums(rsch, snap)
    stale(state, snap, 5)
    placement = TC.Placement(pods=[
        TC.PodPlacement(node=5, gpu_indices=(0, 1)),
        TC.PodPlacement(node=30, gpu_indices=(0, 1))])
    work = list(state.commit_work)
    state.allocate(TC.Job(uid=1, tenant="t", gpu_type=0, n_pods=2,
                          gpus_per_pod=2), placement)
    assert state.commit_work[:2] == [work[0] + 2, work[1]]
    snap.apply_placement(placement)
    assert state.commit_work[:2] == [work[0] + 3, work[1] + 1]
    check(state, snap)
    snap = snapper.take(state)
    assert snap.cols.columns_equal(state.cols)
    check(state, snap)


def test_overlapping_pods_are_rederived():
    """Two pods that name one device pass the state's per-pod checks;
    the rows are re-derived rather than counted twice."""
    state, rsch, snapper = make_cluster(TC.IncrementalSnapshotter)
    snap = snapper.take(state)
    read_sums(rsch, snap)
    placement = TC.Placement(pods=[
        TC.PodPlacement(node=3, gpu_indices=(0, 1)),
        TC.PodPlacement(node=3, gpu_indices=(1, 2))])
    work = list(state.commit_work)
    state.allocate(TC.Job(uid=1, tenant="t", gpu_type=0, n_pods=2,
                          gpus_per_pod=2), placement)
    snap.apply_placement(placement)
    assert state.commit_work[:2] == [work[0], work[1] + 2]
    fresh = state.cols.copy()
    fresh.refresh_derived()
    assert state.cols.columns_equal(fresh) and snap.cols.columns_equal(fresh)
    assert int(state.cols.busy_count[3]) == 3
