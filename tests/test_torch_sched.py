"""The port's scheduling cycle against the JAX package's, on the CPU.

Same seeded jobs through ``repro.core`` and ``repro_torch.core`` (with
``device="cpu"``, so the score pass runs the kernels' plain versions):
placements must be byte-identical and metric reports equal.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.core.snapshot import FullSnapshotter as RefFullSnapshotter
from repro_torch.core.bridge import GROUND_TRUTH, topology_fields_of
from repro_torch.core.snapshot import FullSnapshotter

CPU = {"device": "cpu"}


def placement_key(jobs):
    out = []
    for j in sorted(jobs, key=lambda j: j.uid):
        pods = None if j.placement is None else tuple(
            (p.node, tuple(p.gpu_indices)) for p in j.placement.pods)
        out.append((j.uid, j.start_time, pods))
    return out


def matrix_jobs(M, n, max_pods, seed):
    rng = np.random.default_rng(seed)
    return [M.Job(uid=i, tenant=f"t{i % 3}", gpu_type=0,
                  n_pods=int(rng.integers(1, max_pods + 1)),
                  gpus_per_pod=int(rng.choice([1, 2, 4, 8])),
                  duration=float(rng.integers(300, 6000)),
                  submit_time=float(rng.integers(0, 1800)),
                  priority=int(rng.integers(0, 3)),
                  kind=M.JobKind.TRAIN) for i in range(n)]


def run_sim(M, n_nodes, policy, strategy, rsch_kw, n_jobs=48, seed=0):
    topo = M.ClusterTopology(
        n_nodes=n_nodes, gpus_per_node=8, nodes_per_leaf=32,
        leaves_per_spine=4, spines_per_superspine=4, nodes_per_hbd=32)
    state = M.ClusterState.create(topo)
    quota = M.QuotaManager({f"t{i}": {0: 10 ** 9} for i in range(3)})
    rsch = M.RSCH(topo, M.RSCHConfig(
        train_strategy=getattr(M.Strategy, strategy), **rsch_kw))
    qsch = M.QSCH(quota, rsch, M.QSCHConfig(
        policy=getattr(M.QueuePolicy, policy)))
    res = M.Simulator(state, qsch, M.SimConfig()).run(
        matrix_jobs(M, n_jobs, 8, seed))
    return placement_key(res.jobs), res.metrics.report(), res.cycles


@pytest.mark.parametrize("strategy", [s.name for s in R.Strategy])
@pytest.mark.parametrize("policy", [p.name for p in R.QueuePolicy])
def test_simulator_matrix_byte_identical(policy, strategy):
    want = run_sim(R, 64, policy, strategy, {})
    got = run_sim(T, 64, policy, strategy, CPU)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]


def test_simulator_matches_interpret_pallas_backend():
    want = run_sim(R, 128, "BACKFILL", "E_BINPACK",
                   {"score_backend": "interpret"})
    got = run_sim(T, 128, "BACKFILL", "E_BINPACK", CPU)
    assert got == want


@pytest.mark.parametrize("backend", ["kernel", "ref", "np"])
def test_training_cluster_main_path(backend):
    """The paper's §5.1 cluster (1,000 nodes × 8 GPUs) under Backfill +
    E-Binpack, on a shortened trace."""
    def run(M, **kw):
        topo = M.training_cluster_topology(8000)
        qsch = M.QSCH(M.QuotaManager({"t0": {0: 10 ** 6}}),
                      M.RSCH(topo, M.RSCHConfig(**kw)),
                      M.QSCHConfig(policy=M.QueuePolicy.BACKFILL))
        res = M.Simulator(M.ClusterState.create(topo), qsch).run(
            M.training_trace(150, seed=0, arrival_rate_per_hour=300))
        return placement_key(res.jobs), res.metrics.report(), res.cycles
    assert run(T, score_backend=backend, **CPU) == run(R)


def test_training_trace_equal_in_both_packages():
    for kw in ({}, {"gpu_types": [0, 1], "type_probs": [0.7, 0.3],
                    "tenants": ("a", "b")}):
        a = R.training_trace(300, seed=4, **kw)
        b = T.training_trace(300, seed=4, **kw)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert _fields(x) == _fields(y)


def _fields(job):
    """Job fields with the enums (distinct classes per package) as their
    values."""
    return {k: getattr(v, "value", v)
            for k, v in dataclasses.asdict(job).items()}


def _ref_fragmented(n_nodes, seed=0):
    topo = R.ClusterTopology(
        n_nodes=n_nodes, gpus_per_node=8, nodes_per_leaf=32,
        leaves_per_spine=4, spines_per_superspine=4, nodes_per_hbd=32)
    state = R.ClusterState.create(topo)
    rng = np.random.default_rng(seed)
    busy_nodes = rng.random(n_nodes) < 0.6
    busy_count = rng.integers(1, 9, size=n_nodes)
    state.gpu_busy[:] = ((np.arange(8) < busy_count[:, None])
                         & busy_nodes[:, None])
    return state


def _gang(M):
    return M.Job(uid=1, tenant="bench", gpu_type=0, n_pods=64,
                 gpus_per_pod=8, kind=M.JobKind.TRAIN)


def _picks(result):
    assert result.placement is not None
    return [(p.node, p.gpu_indices, p.nic) for p in result.placement.pods]


@pytest.mark.parametrize("rsch_kw", [{}, {"subset_scoring": False},
                                     {"batched_gang": False},
                                     {"slot_engine": "topk_kernel"}])
def test_state_from_arrays_schedules_like_reference(rsch_kw):
    ref_state = _ref_fragmented(10_000)
    ref_state.set_node_health(17, False)
    ref_state.set_gpu_health(23, 0, False)
    ref_state.set_drain(range(40, 48), True)
    ref_snap = RefFullSnapshotter().take(ref_state)
    want = _picks(R.RSCH(ref_state.topology).schedule(_gang(R), ref_snap))

    cols = {name: getattr(ref_state.cols, name) for name in GROUND_TRUTH}
    state = T.state_from_arrays(topology_fields_of(ref_state.topology), cols)
    for f in dataclasses.fields(ref_state.cols):
        np.testing.assert_array_equal(getattr(state.cols, f.name),
                                      getattr(ref_state.cols, f.name))
    snap = FullSnapshotter().take(state)
    got = _picks(T.RSCH(state.topology, T.RSCHConfig(**rsch_kw, **CPU))
                 .schedule(_gang(T), snap))
    assert got == want


def test_state_from_arrays_rejects_bad_columns():
    topo = T.small_topology()
    cols = {name: getattr(T.ClusterState.create(topo).cols, name)
            for name in GROUND_TRUTH}
    fields = topology_fields_of(topo)
    with pytest.raises(ValueError, match="missing"):
        T.state_from_arrays(fields, {k: v for k, v in cols.items()
                                     if k != "gpu_busy"})
    with pytest.raises(ValueError, match="shape"):
        T.state_from_arrays(fields, {**cols, "gpu_busy": cols["gpu_busy"][1:]})


def test_kernel_backend_keeps_subset_scoring(monkeypatch):
    """Subset scoring stays the default path for the kernel backend: the
    full-width batched pass must not run."""
    def boom(*a, **kw):
        raise AssertionError("full-width pass ran with subset scoring on")
    monkeypatch.setattr(T.RSCH, "_select_nodes_batched", boom)
    ref_state = _ref_fragmented(2_000)
    state = T.state_from_arrays(
        topology_fields_of(ref_state.topology),
        {name: getattr(ref_state.cols, name) for name in GROUND_TRUTH})
    res = T.RSCH(state.topology, T.RSCHConfig(**CPU)).schedule(
        _gang(T), FullSnapshotter().take(state))
    assert res.placement is not None


def test_default_device_raises_without_cuda(monkeypatch):
    import torch

    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.RSCH(T.small_topology())
    with pytest.raises(RuntimeError, match="CUDA"):
        T.compute_node_scores(
            np.ones(4, np.int32), np.zeros(4, np.int32), np.ones(4, bool),
            np.zeros(4, np.float32), np.zeros(4, np.float32), 1, 8,
            T.E_BINPACK, backend="kernel")
    assert resolve_device("cpu").type == "cpu"

