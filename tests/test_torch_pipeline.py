"""The port's cycle pipelining against the JAX package's, on the CPU.

Ports of the pipelining tests of ``tests/test_scale.py``: the same seeded
trace through ``repro.core`` and ``repro_torch.core`` (``device="cpu"``,
so the speculative and the live score passes run the kernels' plain
versions through the seam) must give byte-identical placements, equal
reports and equal speculation statistics.  Then the port's own rule:
an error raised on the device path propagates out of a speculation,
while a plugin's error is counted, as the reference counts it.
"""

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro_torch.core import pipeline, scoring
from repro_torch.kernels import ops


def rsch_config(M, **kw):
    return M.RSCHConfig(**kw, **({"device": "cpu"} if M is T else {}))


def sim_jobs(M, rng, n):
    return [M.Job(uid=i, tenant=f"t{i % 3}", gpu_type=0,
                  n_pods=int(rng.integers(1, 6)),
                  gpus_per_pod=int(rng.choice([4, 8])),
                  duration=float(rng.integers(600, 8000)),
                  submit_time=float(rng.integers(0, 600)),
                  priority=int(rng.integers(0, 3)),
                  kind=M.JobKind.TRAIN) for i in range(n)]


def placements(jobs):
    return [(j.uid, j.start_time,
             None if j.placement is None else
             tuple((p.node, tuple(p.gpu_indices)) for p in j.placement.pods))
            for j in sorted(jobs, key=lambda j: j.uid)]


def stats_of(res):
    """The pipeline's counters, without its wall time."""
    if res.pipeline is None:
        return None
    return {k: v for k, v in res.pipeline.items() if k != "spec_seconds"}


def run_sim(M, policy, pipelined, seed=5, profiles=None, **rsch_kw):
    rng = np.random.default_rng(seed)
    topo = M.small_topology(n_nodes=24, gpus_per_node=8, nodes_per_leaf=8)
    state = M.ClusterState.create(topo)
    quota = M.QuotaManager({f"t{i}": {0: 10 ** 6} for i in range(3)})
    rsch = M.RSCH(topo, rsch_config(M, **rsch_kw), profiles=profiles)
    qsch = M.QSCH(quota, rsch,
                  M.QSCHConfig(policy=getattr(M.QueuePolicy, policy)))
    sim = M.Simulator(state, qsch, M.SimConfig(pipelined_cycles=pipelined))
    res = sim.run(sim_jobs(M, rng, 40))
    return (placements(res.jobs), res.metrics.report(), res.cycles,
            stats_of(res))


def held(*args, **kw):
    want = run_sim(R, *args, **kw)
    got = run_sim(T, *args, **kw)
    assert got == want
    return got


@pytest.mark.parametrize("policy", [p.name for p in R.QueuePolicy])
def test_pipelined_cycles_byte_identical(policy):
    a = held(policy, False)
    b = held(policy, True)
    assert a[:3] == b[:3]
    assert a[3] is None
    stats = b[3]
    # Every speculation is eventually accounted: conflicted at arm
    # time, hit/missed at consume time — except at most one still in
    # flight when the run drains.
    drained = stats["hits"] + stats["misses"] + stats["conflicts"]
    assert 0 <= stats["speculated"] - drained <= 1
    assert stats["errors"] == 0


def test_pipeline_hits_under_contention():
    """A fragmentation-blocked head is re-scored every cycle; the
    speculation must be consumed (hit), not recomputed."""
    a = held("BACKFILL", False, seed=6)
    b = held("BACKFILL", True, seed=6)
    assert a[:3] == b[:3]
    assert b[3]["speculated"] > 0
    assert b[3]["hits"] > 0
    assert b[3]["errors"] == 0


@pytest.mark.parametrize("batched_gang", [True, False])
def test_pipeline_same_on_every_score_backend(batched_gang, monkeypatch):
    """The speculation guards see the same snapshot whatever the score
    backend: the plain versions through the seam and host numpy give
    the same placements, speculation counts and score passes."""
    passes = {"seam": 0}
    staged = scoring._staged_pass

    def counted(*args, **kw):
        passes["seam"] += 1
        return staged(*args, **kw)

    monkeypatch.setattr(scoring, "_staged_pass", counted)
    kernel = run_sim(T, "BACKFILL", True, seed=6, batched_gang=batched_gang)
    seam_passes = passes["seam"]
    host = run_sim(T, "BACKFILL", True, seed=6, batched_gang=batched_gang,
                   score_backend="np")
    assert kernel == host
    assert passes["seam"] == seam_passes > 0
    assert kernel[3]["errors"] == 0 and kernel[3]["hits"] > 0


def test_pipeline_requires_incremental_snapshots():
    for M in (R, T):
        topo = M.small_topology(n_nodes=16, gpus_per_node=8,
                                nodes_per_leaf=4)
        qsch = M.QSCH(M.QuotaManager({"t0": {0: 1024}}),
                      M.RSCH(topo, rsch_config(M)),
                      incremental_snapshots=False)
        with pytest.raises(ValueError):
            qsch.enable_pipeline()


def test_pipeline_off_is_default():
    for M in (R, T):
        topo = M.small_topology(n_nodes=16, gpus_per_node=8,
                                nodes_per_leaf=4)
        qsch = M.QSCH(M.QuotaManager({"t0": {0: 1024}}),
                      M.RSCH(topo, rsch_config(M)))
        M.Simulator(M.ClusterState.create(topo), qsch)
        assert qsch.pipeline is None
        assert M.SimConfig().pipelined_cycles is False


# ----------------------------------------------------------------------
# Errors in a speculation: the device path's propagate, a plugin's count
# ----------------------------------------------------------------------
def needs_live_cycle_profiles(M):
    """Profiles whose train pass scores with a plugin that reads the
    cycle clock, which a speculation's plain context does not have."""
    F = M.framework

    class NowScore(F.ScorePlugin):
        name = "NowScoreTestOnly"

        def score(self, job, snap, pool, ctx):
            if not hasattr(ctx, "now"):
                raise RuntimeError("needs the live cycle's clock")
            return None

    plan = F.single_pass_plan(F.PlacementPass(
        scorers=(F.create_plugin("BinpackScore"), NowScore())))
    return F.ProfileSet(train=F.make_profile("t", plan),
                        inference=F.make_profile("i", plan),
                        best_effort=F.make_profile("b", plan))


def test_plugin_error_in_speculation_is_counted_like_the_reference():
    want = run_sim(R, "BACKFILL", True, seed=6,
                   profiles=needs_live_cycle_profiles(R))
    got = run_sim(T, "BACKFILL", True, seed=6,
                  profiles=needs_live_cycle_profiles(T))
    assert got == want
    assert got[3]["errors"] > 0 and got[3]["speculated"] == 0
    unpipelined = run_sim(T, "BACKFILL", False, seed=6,
                          profiles=needs_live_cycle_profiles(T))
    assert got[:3] == unpipelined[:3]


def pending_pipeline():
    topo = T.small_topology(n_nodes=16, gpus_per_node=8, nodes_per_leaf=4)
    state = T.ClusterState.create(topo)
    qsch = T.QSCH(T.QuotaManager({"t0": {0: 1024}}),
                  T.RSCH(topo, rsch_config(T)))
    pipe = qsch.enable_pipeline()
    qsch.snapshotter.take(state)         # as the cycle before would have
    qsch.submit(T.Job(uid=1, tenant="t0", gpu_type=0, n_pods=2,
                      gpus_per_pod=8, kind=T.JobKind.TRAIN))
    return state, pipe


@pytest.mark.parametrize("where", [(ops, "node_scores_and_slots"),
                                   (scoring, "_staging_for")],
                         ids=["kernel-wrapper", "seam"])
def test_device_error_in_speculation_propagates(where, monkeypatch):
    def launch_fails(*args, **kw):
        raise RuntimeError("node_scores_slots_launch failed: CUDA error 700")

    monkeypatch.setattr(*where, launch_fails)
    state, pipe = pending_pipeline()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        pipe.end_cycle(state, 0.0)
    assert pipe.errors == 0 and pipe.speculated == 0


def test_plugin_runtime_error_in_speculation_is_counted():
    """The same exception type from a plugin, outside the device path,
    aborts only the speculation."""
    state, pipe = pending_pipeline()
    pipe.qsch.rsch.profiles = needs_live_cycle_profiles(T)
    pipe.end_cycle(state, 0.0)
    assert pipe.errors == 1 and pipe.speculated == 0


def test_raised_on_device_path_reads_the_traceback():
    def raise_in(fn):
        try:
            fn()
        except Exception as exc:       # noqa: BLE001 - the object is tested
            return exc
        raise AssertionError("did not raise")

    seam = raise_in(lambda: scoring.compute_node_scores_and_slots(
        np.ones(4, np.int32), np.zeros(4, np.int32), np.ones(4, bool),
        np.zeros(4, np.float32), np.zeros(4, np.float32), 1, 8,
        T.E_BINPACK, backend="no-such-backend", device="cpu"))
    assert pipeline.raised_on_device_path(seam)
    assert not pipeline.raised_on_device_path(
        raise_in(lambda: {}["missing"]))
