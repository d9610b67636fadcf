"""The port's meshes and placement cost model (``launch/mesh.py``,
``launch/cosched.py``) against the JAX package, on the CPU, and the
closed loop: a job scheduled by the port's RSCH trains one step on the
mesh of its placement.

``cosched`` reads ``ICI_BW``, which is the H100's NVLink rate in the
port and the TPU v5e's ICI rate in the reference; the parity tests give
the port the reference's constant and compare exactly.  A test that
starts a process group does it in a fixture that destroys it.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.testing._internal.distributed.fake_pg import FakeStore

import repro.core as ref_core
from repro.core.topology import small_topology as ref_small_topology
from repro.launch import cosched as ref_cosched
from repro.launch import mesh as ref_mesh
import repro_torch.core as core
from repro_torch.configs import get_arch, make_inputs
from repro_torch.core.snapshot import FullSnapshotter
from repro_torch.launch import cosched, mesh
from repro_torch.launch.combo_cache import mesh_key
from repro_torch.models import Model
from repro_torch.sharding import (MeshShape, ShardingRules,
                                  distribute_state_dict)
from repro_torch.sharding.context import gathered, use_activation_sharding
from repro_torch.train import AdamWConfig, adamw_init, make_train_step

TERMS = {"compute": 1.0, "memory": 1.0, "collective": 2.0}


@pytest.fixture
def reference_ici(monkeypatch):
    """The port's cost model at the reference's ICI rate."""
    monkeypatch.setattr(cosched, "ICI_BW", ref_mesh.ICI_BW)


@pytest.fixture
def no_group():
    """No process group before the test; none left after it."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _two_placements(pkg):
    good = pkg.Placement(pods=[pkg.PodPlacement(node=n,
                                                gpu_indices=tuple(range(8)))
                               for n in (0, 1)])          # same leaf
    bad = pkg.Placement(pods=[pkg.PodPlacement(node=n,
                                               gpu_indices=tuple(range(8)))
                              for n in (0, 4)])           # two leaves
    return good, bad


def test_placement_quality_and_step_time(reference_ici):
    """tests/test_integration.py:37, on both packages: equal qualities,
    bandwidths and step times."""
    ref_topo = ref_small_topology(n_nodes=16, gpus_per_node=8,
                                  nodes_per_leaf=4)
    topo = core.small_topology(n_nodes=16, gpus_per_node=8,
                               nodes_per_leaf=4)
    terms = {"compute": 0.1, "memory": 0.2, "collective": 0.3}
    got = []
    for ref_p, p in zip(_two_placements(ref_core), _two_placements(core)):
        want = ref_cosched.placement_quality(ref_p, ref_topo, 16)
        q = cosched.placement_quality(p, topo, 16)
        assert dataclasses.asdict(q) == dataclasses.asdict(want)
        assert cosched.effective_collective_bw(q) == \
            ref_cosched.effective_collective_bw(want)
        assert cosched.estimated_step_time(terms, q) == \
            ref_cosched.estimated_step_time(terms, want)
        got.append(q)
    qg, qb = got
    assert qg.group_dev == 1.0 and qb.group_dev == 2.0
    assert cosched.effective_collective_bw(qg) == ref_mesh.ICI_BW
    assert cosched.effective_collective_bw(qb) < ref_mesh.ICI_BW
    assert cosched.estimated_step_time(terms, qb) > \
        cosched.estimated_step_time(terms, qg)


def _fresh(pkg, jobs):
    return [pkg.Job(uid=j.uid, tenant=j.tenant, gpu_type=j.gpu_type,
                    n_pods=j.n_pods, gpus_per_pod=j.gpus_per_pod,
                    kind=j.kind, gang=j.gang, priority=j.priority,
                    submit_time=j.submit_time, duration=j.duration)
            for j in jobs]


def _estimates(pkg, rsch_cfg, strategy, jobs, topo):
    """Per placed job of >= 16 GPUs: (uid, estimated step time)."""
    state = pkg.ClusterState.create(topo)
    qm = pkg.QuotaManager({"t0": {0: 100000}})
    qsch = pkg.QSCH(qm, pkg.RSCH(topo, rsch_cfg(train_strategy=strategy)),
                    pkg.QSCHConfig(policy=pkg.QueuePolicy.BACKFILL))
    res = pkg.Simulator(state, qsch, pkg.SimConfig()).run(_fresh(pkg, jobs))
    mod = ref_cosched if pkg is ref_core else cosched
    return [(j.uid, mod.estimated_step_time(
        TERMS, mod.placement_quality(j.placement, topo, j.n_gpus)))
        for j in sorted(res.jobs, key=lambda j: j.uid)
        if j.placement is not None and j.n_gpus >= 16]


def test_ebinpack_placements_beat_spread_in_perf_model(reference_ici):
    """tests/test_integration.py:56 on the port, every job's estimate
    equal to the reference's."""
    jobs = [j for j in ref_core.training_trace(
        40, seed=7, arrival_rate_per_hour=240, mean_duration_s=1200.0)
        if j.n_gpus <= 64]
    est = {}
    for strat in ("E_BINPACK", "SPREAD"):
        ref = _estimates(ref_core, ref_core.RSCHConfig,
                         getattr(ref_core.Strategy, strat), jobs,
                         ref_small_topology(n_nodes=16, gpus_per_node=8,
                                            nodes_per_leaf=4))
        got = _estimates(core, lambda **kw: core.RSCHConfig(device="cpu",
                                                            **kw),
                         getattr(core.Strategy, strat), jobs,
                         core.small_topology(n_nodes=16, gpus_per_node=8,
                                             nodes_per_leaf=4))
        assert got == ref and got, strat
        est[strat] = float(np.mean([t for _, t in got]))
    assert est["E_BINPACK"] <= est["SPREAD"] + 1e-9


def test_job_mesh_shape_factorization():
    for n in (64, 8, 6, 1, 12, 256, 7):
        assert cosched.job_mesh_shape(n) == ref_cosched.job_mesh_shape(n)
    assert cosched.job_mesh_shape(64) == (8, 8)
    assert cosched.job_mesh_shape(8) == (1, 8)
    assert cosched.job_mesh_shape(6) == (3, 2)
    assert cosched.job_mesh_shape(1) == (1, 1)


def test_h100_constants():
    """NVIDIA H100 SXM data-sheet figures: dense bf16, HBM3, NVLink 4 per
    GPU one way (half of 900 GB/s)."""
    assert mesh.PEAK_FLOPS_BF16 == 989.4e12
    assert mesh.HBM_BW == 3.35e12
    assert mesh.ICI_BW == 450e9 == 900e9 / 2
    assert cosched.ICI_BW is mesh.ICI_BW


def test_step_time_is_invariant_to_the_ici_constant(monkeypatch):
    """``estimated_step_time`` rescales the collective term by ICI_BW /
    effective bandwidth, so only ``effective_collective_bw`` moves with
    the constant."""
    topo = core.small_topology(n_nodes=16, gpus_per_node=8,
                               nodes_per_leaf=4)
    for p in _two_placements(core):
        q = cosched.placement_quality(p, topo, 16)
        h100 = (cosched.effective_collective_bw(q),
                cosched.estimated_step_time(TERMS, q))
        monkeypatch.setattr(cosched, "ICI_BW", ref_mesh.ICI_BW)
        v5e = (cosched.effective_collective_bw(q),
               cosched.estimated_step_time(TERMS, q))
        monkeypatch.undo()
        assert math.isclose(h100[1], v5e[1], rel_tol=1e-12, abs_tol=0)
        assert math.isclose(h100[0] / v5e[0], mesh.ICI_BW / ref_mesh.ICI_BW,
                            rel_tol=1e-12)


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod", (False, True))
def test_production_mesh_over_a_fake_group(multi_pod, no_group):
    n = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), world_size=n, rank=0)
    m = mesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    want = ((("pod", 2),) if multi_pod else ()) + (("data", 16),
                                                   ("model", 16))
    assert mesh_key(m) == want
    assert m.size() == n
    with pytest.raises(ValueError, match=f"world size {n}"):
        mesh.make_production_mesh(multi_pod=not multi_pod, device="cpu")


def test_production_mesh_needs_a_group(no_group):
    with pytest.raises(RuntimeError, match="256 ranks"):
        mesh.make_production_mesh(device="cpu")


def test_cpu_mesh_starts_a_world_of_one(no_group):
    m = mesh.make_cpu_mesh(device="cpu")
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert m.device_type == "cpu"
    assert mesh_key(m) == (("data", 1), ("model", 1))
    with pytest.raises(ValueError, match="world size 1"):
        mesh.make_cpu_mesh(2, 1, device="cpu")


def test_cpu_mesh_defaults_to_cuda(no_group, monkeypatch):
    """Without a card, the default device raises before any group
    starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        mesh.make_cpu_mesh()
    assert not dist.is_initialized()


def test_mesh_key_of_a_device_mesh_and_a_mesh_shape(no_group):
    """The repaired ``mesh_key``: a DeviceMesh (``mesh_dim_names`` and a
    tuple ``shape``) and a MeshShape key as the reference keys its
    mesh."""
    shape = MeshShape(("data", "model"), (16, 16))
    assert mesh_key(shape) == (("data", 16), ("model", 16))
    dist.init_process_group("fake", store=FakeStore(), world_size=256,
                            rank=0)
    m = mesh.make_production_mesh(device="cpu")
    assert isinstance(m.shape, tuple)
    assert mesh_key(m) == mesh_key(shape)
    from jax.sharding import AbstractMesh
    from repro.launch.combo_cache import mesh_key as ref_mesh_key
    assert mesh_key(m) == ref_mesh_key(AbstractMesh((16, 16),
                                                    ("data", "model")))


# ---------------------------------------------------------------------------
# The closed loop (tests/test_integration.py:84)
# ---------------------------------------------------------------------------
def _train_step(cfg, batch, sharded_mesh=None):
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    if sharded_mesh is not None:
        distribute_state_dict(model, ShardingRules(sharded_mesh))
    step = make_train_step(model, AdamWConfig(), remat=False)
    with use_activation_sharding(sharded_mesh):
        opt = adamw_init(dict(model.named_parameters()))
        _, metrics = step(opt, batch)
    return {k: float(gathered(v)) for k, v in metrics.items()}, model


def test_scheduled_job_trains_on_its_mesh_like_the_unsharded_step(no_group):
    """Schedule a job with the port's RSCH, build the mesh of its
    placement (``job_mesh_shape``, ``make_cpu_mesh``), distribute the
    glm4-9b smoke model and take one train step under the activation
    context: loss and grad norm equal the unsharded step's at rtol 1e-5,
    and every updated weight is a DTensor equal to the unsharded one."""
    topo = core.small_topology(n_nodes=4, gpus_per_node=1)
    state = core.ClusterState.create(topo)
    rsch = core.RSCH(topo, core.RSCHConfig(device="cpu"))
    job = core.Job(uid=1, tenant="t0", gpu_type=0, n_pods=1,
                   gpus_per_pod=1, kind=core.JobKind.TRAIN)
    res = rsch.schedule(job, FullSnapshotter().take(state))
    assert res.placement is not None
    data, model_par = cosched.job_mesh_shape(res.placement.n_gpus)
    assert (data, model_par) == (1, 1)
    m = mesh.make_cpu_mesh(data, model_par, device="cpu")
    cfg = get_arch("glm4-9b", smoke=True)
    batch = make_inputs(cfg, batch=2, seq=16, kind="train")
    want, plain = _train_step(cfg, batch)
    got, sharded = _train_step(cfg, batch, m)
    assert np.isfinite(got["loss"])
    for key in ("loss", "grad_norm"):
        assert math.isclose(got[key], want[key], rel_tol=1e-5), key
    for (name, p), q in zip(sharded.named_parameters(), plain.parameters()):
        assert isinstance(p, DTensor), name
        torch.testing.assert_close(p.full_tensor(), q, rtol=1e-5, atol=1e-7)
