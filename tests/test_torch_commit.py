"""Committing a placement to the column block as one gang (port only).

``ClusterState.allocate``/``release`` and ``Snapshot.apply_placement``/
``apply_release`` write a placement of ``cluster.BATCH_MIN_PODS`` pods or
more of one size with one indexed write, after whole-array checks, and
smaller or ragged ones pod by pod.  Forced down each path in turn, the
same placements must leave the same state: the busy bitmap, the derived
columns, the dirty set, the allocation ledger, the snapshot's tracked
per-group sums and its mutation count.  A faulty placement must raise the
per-pod path's ``ValueError``, for the first faulty pod, and write
nothing, whichever path it is sent down.
"""

import dataclasses

import numpy as np
import pytest

import repro_torch.core as TC
from repro_torch.core import cluster as T_cluster

N_NODES = 640
G = 8
#: ``BATCH_MIN_PODS`` that forces each path.
PATHS = {"per_pod": 10 ** 9, "batched": 1}
BACKGROUND_UID = 100_000


def make_state():
    """640 nodes × 8 GPUs: two nodes in five hold a background job on
    their lowest 1–7 slots (through the ledger), two GPUs and a node are
    unhealthy, and an incremental snapshot with two tracked per-group
    sums has been taken (so the dirty set is empty)."""
    topo = TC.small_topology(n_nodes=N_NODES, gpus_per_node=G,
                             nodes_per_leaf=16)
    state = TC.ClusterState.create(topo)
    for n in range(0, N_NODES, 5):
        for m in (n, n + 1):
            k = 1 + m % 7
            state.allocate(
                TC.Job(uid=BACKGROUND_UID + m, tenant="t", gpu_type=0,
                       n_pods=1, gpus_per_pod=k),
                TC.Placement(pods=[TC.PodPlacement(
                    node=m, gpu_indices=tuple(range(k)))]))
    state.set_gpu_health(2, 7, False)
    state.set_gpu_health(9, 0, False)
    state.set_node_health(14, False)
    snapshotter = TC.IncrementalSnapshotter()
    snap = snapshotter.take(state)
    pool = snap.candidate_pool(0)
    for key, col in (("free", "free_gpus"), ("used", "used_gpus")):
        def contrib(s, idx, col=col):
            if idx is None:
                return np.where(pool, getattr(s, col), 0)
            return np.where(pool[idx], getattr(s, col)[idx], 0)
        snap.tracked_sum(key, topo.leaf_id, topo.n_leaf_groups, contrib)
    return state, snap


def gang_pods(state, n_pods, slots):
    """``n_pods`` pods of ``slots`` GPUs on free, healthy GPUs, taken
    node by node in a shuffled order (several pods share a node where
    ``slots`` < 8)."""
    avail = (~state.gpu_busy & state.gpu_healthy
             & state.node_healthy[:, None])
    pods = []
    for n in np.random.default_rng(0).permutation(N_NODES):
        free = np.flatnonzero(avail[n]).tolist()
        while len(free) >= slots and len(pods) < n_pods:
            pods.append(TC.PodPlacement(node=int(n),
                                        gpu_indices=tuple(free[:slots])))
            free = free[slots:]
        if len(pods) == n_pods:
            return pods
    raise AssertionError("the cluster cannot hold the gang")


def observe(state, snap=None):
    """Everything a commit may change, in comparable form."""
    seen = {
        "cols": {f.name: getattr(state.cols, f.name).tolist()
                 for f in dataclasses.fields(state.cols)},
        "dirty": set(state.dirty_nodes),
        "ledger": {uid: [(p.node, tuple(p.gpu_indices)) for p in pl.pods]
                   for uid, pl in state.allocations.items()},
        "commit_pods": list(state.commit_pods),
    }
    if snap is not None:
        seen["snap_cols"] = {f.name: getattr(snap.cols, f.name).tolist()
                             for f in dataclasses.fields(snap.cols)}
        # through the read path, which patches a sum over its pending rows
        seen["tracked"] = {
            k: (snap.tracked_sum(k, c.leaf_id, len(c.totals),
                                 c.contrib_fn).tolist(), c.contrib.tolist())
            for k, c in list(snap.tracked.items())}
        seen["mut_count"] = snap.mut_count
    return seen


@pytest.mark.parametrize("slots", [1, 4, 8])
@pytest.mark.parametrize("n_pods", [1, 2, 8, 64, 256])
def test_gang_commit_equals_per_pod_commit(monkeypatch, n_pods, slots):
    """Bind, mirror, release and mirror back one gang down each path:
    the state and the snapshot agree after every step, the ledger stays
    consistent, and each path's tally counts the gang's pods."""
    seen = {}
    for path, batch_min in PATHS.items():
        monkeypatch.setattr(T_cluster, "BATCH_MIN_PODS", batch_min)
        state, snap = make_state()
        tally0 = list(state.commit_pods)
        pods = gang_pods(state, n_pods, slots)
        job = TC.Job(uid=1, tenant="t", gpu_type=0, n_pods=n_pods,
                     gpus_per_pod=slots)
        placement = TC.Placement(pods=list(pods))
        steps = []
        state.allocate(job, placement)
        state.check_invariants()
        steps.append(observe(state, snap))
        snap.apply_placement(placement)
        steps.append(observe(state, snap))
        assert state.release(1) is placement
        state.check_invariants()
        # freed devices: the placement keeps no index arrays
        assert "_index" not in vars(placement)
        steps.append(observe(state, snap))
        snap.apply_release(placement)
        assert "_index" not in vars(placement)
        steps.append(observe(state, snap))
        committed = [a - b for a, b in zip(state.commit_pods, tally0)]
        assert committed == ([n_pods, 0] if path == "batched"
                             else [0, n_pods])
        seen[path] = steps
    for a, b in zip(seen["per_pod"], seen["batched"]):
        del a["commit_pods"], b["commit_pods"]     # checked above
        assert a == b
    # the mirrored snapshot equals the live state at every step
    final = seen["batched"][-1]
    assert final["cols"] == final["snap_cols"]


def _busy(state, pods, i):
    """Bind a one-GPU job on the second slot of pod ``i``."""
    state.allocate(
        TC.Job(uid=BACKGROUND_UID - 1, tenant="t", gpu_type=0, n_pods=1,
               gpus_per_pod=1),
        TC.Placement(pods=[TC.PodPlacement(
            node=pods[i].node, gpu_indices=(pods[i].gpu_indices[1],))]))


def _unhealthy_gpu(state, pods, i):
    state.set_gpu_health(pods[i].node, pods[i].gpu_indices[2], False)


def _unhealthy_node(state, pods, i):
    state.set_node_health(pods[i].node, False)


def _draining(state, pods, i):
    state.set_drain([pods[i].node], True)


def _wrong_pool(state, pods, i):
    state.gpu_type[pods[i].node] = 1


def _move(pods, i, **kw):
    pods[i] = dataclasses.replace(pods[i], **kw)


def _node_above(state, pods, i):
    _move(pods, i, node=N_NODES)


def _node_below(state, pods, i):
    _move(pods, i, node=-1)


def _slot_above(state, pods, i):
    _move(pods, i, gpu_indices=pods[i].gpu_indices[:-1] + (G,))


def _slot_below(state, pods, i):
    _move(pods, i, gpu_indices=(-1,) + pods[i].gpu_indices[1:])


def _size_mismatch(state, pods, i):
    """Pod ``i`` gives up a slot and the pod before it (cyclically) takes
    slot 7 of its own node: the GPU count still covers the job."""
    _move(pods, i, gpu_indices=pods[i].gpu_indices[:-1])
    _move(pods, i - 1, gpu_indices=pods[i - 1].gpu_indices + (7,))


#: A fault planted in pod ``i`` of the gang, and the message it raises
#: (``{n}``: that pod's node).
POD_FAULTS = {
    "busy_gpu": (_busy, "GPU already busy on node {n}"),
    "unhealthy_gpu": (_unhealthy_gpu, "unhealthy GPU selected on node {n}"),
    "unhealthy_node": (_unhealthy_node, "node {n} is unhealthy"),
    "draining_node": (_draining, "node {n} is draining"),
    "wrong_pool": (_wrong_pool, "node {n} pool 1 != job pool 0"),
    "node_above_range": (_node_above, "node {n} out of range"),
    "node_below_range": (_node_below, "node {n} out of range"),
    "slot_above_range": (_slot_above, "GPU index out of range"),
    "slot_below_range": (_slot_below, "GPU index out of range"),
    "pod_size_mismatch": (_size_mismatch, "pod placement size mismatch"),
}

#: Eight wholly free, healthy nodes of ``make_state``'s cluster, across
#: its leaves.
GANG_NODES = (22, 123, 24, 327, 28, 429, 532, 633)


def _gang_case():
    """An 8-pod × 4-GPU gang, one pod a node on slots 0–3: a fault in
    one pod never shows in another, and slots 4–7 are free."""
    state, _ = make_state()
    pods = [TC.PodPlacement(node=n, gpu_indices=(0, 1, 2, 3))
            for n in GANG_NODES]
    return state, pods, TC.Job(uid=1, tenant="t", gpu_type=0, n_pods=8,
                               gpus_per_pod=4)


def _raises_alike(monkeypatch, state, job, pods):
    """Allocate down each path; both raise one message and write
    nothing.  Returns the message."""
    before = observe(state)
    messages = set()
    for batch_min in PATHS.values():
        monkeypatch.setattr(T_cluster, "BATCH_MIN_PODS", batch_min)
        with pytest.raises(ValueError) as err:
            state.allocate(job, TC.Placement(pods=list(pods)))
        messages.add(str(err.value))
        assert observe(state) == before
    assert len(messages) == 1
    return messages.pop()


@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("fault", list(POD_FAULTS))
def test_faulty_pod_raises_the_per_pod_message(monkeypatch, fault, where):
    """A fault planted in the gang's first or last pod alone raises the
    per-pod check's message on both paths and leaves the state as it
    was."""
    plant, message = POD_FAULTS[fault]
    state, pods, job = _gang_case()
    i = 0 if where == "first" else len(pods) - 1
    plant(state, pods, i)
    assert (_raises_alike(monkeypatch, state, job, pods)
            == message.format(n=pods[i].node))


def test_earliest_faulty_pod_is_named(monkeypatch):
    """With faults in pods 2 and 5, the message names pod 2's."""
    state, pods, job = _gang_case()
    _draining(state, pods, 5)
    _busy(state, pods, 2)
    assert (_raises_alike(monkeypatch, state, job, pods)
            == f"GPU already busy on node {pods[2].node}")


def test_job_level_faults(monkeypatch):
    """A placement that does not cover the request, pods all of one
    wrong size, and a job already allocated raise the per-pod path's
    messages."""
    state, pods, job = _gang_case()
    assert (_raises_alike(monkeypatch, state, job, pods[:-1])
            == "placement does not cover the job request")
    wide = [dataclasses.replace(p, gpu_indices=p.gpu_indices + (7, 6, 5, 4))
            for p in pods[:4]]
    assert (_raises_alike(monkeypatch, state, job, wide)
            == "pod placement size mismatch")
    state.allocate(job, TC.Placement(pods=list(pods)))
    assert (_raises_alike(monkeypatch, state, job, pods)
            == f"job {job.uid} already allocated")


def test_index_form_is_built_once_and_refuses_ragged_pods():
    pods = [TC.PodPlacement(node=3, gpu_indices=(0, 1)),
            TC.PodPlacement(node=3, gpu_indices=(2, 3)),
            TC.PodPlacement(node=9, gpu_indices=(5, 4))]
    placement = TC.Placement(pods=pods)
    nodes, slots = placement.index_form()
    assert nodes.dtype == slots.dtype == np.int64
    assert nodes.tolist() == [3, 3, 9]
    assert slots.tolist() == [[0, 1], [2, 3], [5, 4]]
    assert placement.index_form()[0] is nodes
    assert placement == TC.Placement(pods=list(pods))
    # taken off with keep=False, then built anew and not kept
    assert placement.index_form(keep=False)[0] is nodes
    assert "_index" not in vars(placement)
    again = placement.index_form(keep=False)
    assert again[0] is not nodes and again[1].tolist() == slots.tolist()
    assert "_index" not in vars(placement)
    ragged = TC.Placement(pods=pods + [TC.PodPlacement(node=1,
                                                       gpu_indices=(0,))])
    assert ragged.index_form() is None
    assert TC.Placement(pods=[]).index_form() is None
