"""The port's elastic training against the JAX package's, on the CPU.

Each test is a port of one test of ``tests/test_elastic.py``: the same
scenario runs through ``repro.core`` and ``repro_torch.core`` (with
``device="cpu"``, so the score pass runs the kernels' plain versions).
The scenario makes the reference test's checks on both packages and
returns what it observed — placements, job accounting, active plans,
metric reports, plan-cache counters — which must be equal.
"""

import math

import pytest

import repro.core as R
import repro.launch.combo_cache as R_combo
import repro_torch.core as T
import repro_torch.launch.combo_cache as T_combo

from test_torch_dynamics import held, rsch_config

COMBO = {R: R_combo, T: T_combo}


def cluster(M):
    topo = M.small_topology(n_nodes=16, gpus_per_node=8, nodes_per_leaf=4)
    return topo, M.ClusterState.create(topo)


def make_spec(M):
    """Ideal 8x8 (64 GPUs), shrinkable to 4x8 at 0.6 and 2x8 at 0.3."""
    return M.ElasticSpec(plans=(M.ParallelismPlan(8, 8, 1.0),
                                M.ParallelismPlan(4, 8, 0.6),
                                M.ParallelismPlan(2, 8, 0.3)))


def elastic_job(M, uid=1, duration=3600.0, submit=0.0, spec=None,
                tenant="t0"):
    spec = spec or make_spec(M)
    ideal = spec.ideal()
    return M.Job(uid=uid, tenant=tenant, gpu_type=0, n_pods=ideal.n_pods,
                 gpus_per_pod=ideal.gpus_per_pod, submit_time=submit,
                 duration=duration, preemptible=True, elastic=spec)


def rigid_job(M, uid, n_pods, duration, submit=0.0, priority=50):
    return M.Job(uid=uid, tenant="t0", gpu_type=0, n_pods=n_pods,
                 gpus_per_pod=8, submit_time=submit, duration=duration,
                 priority=priority, preemptible=True)


def make_elastic_sim(M, topo, state, *, dynamics=None, horizon=None,
                     manager=None):
    qm = M.QuotaManager({"t0": {0: 1024}})
    qsch = M.QSCH(qm, M.RSCH(topo, rsch_config(M)), M.QSCHConfig(),
                  elastic=manager or M.ElasticManager())
    return M.Simulator(state, qsch,
                       M.SimConfig(tick_interval=30.0, sample_interval=300.0,
                                   binding_latency=0.0, horizon=horizon,
                                   dynamics=dynamics))


def plan_key(plan):
    return None if plan is None else (plan.n_pods, plan.gpus_per_pod,
                                      plan.throughput, plan.name)


def job_key(j):
    pods = None if j.placement is None else tuple(
        (p.node, tuple(p.gpu_indices)) for p in j.placement.pods)
    return (j.uid, j.state.name, j.start_time, j.end_time, j.run_time, pods,
            j.attempt, j.interrupt_count, j.reshape_count, j.n_gpus,
            plan_key(j.active_plan), j.checkpointed_progress, j.lost_work,
            j.work_rate)


def outcome(res):
    m = res.metrics
    return {"jobs": [job_key(j) for j in sorted(res.jobs,
                                                key=lambda j: j.uid)],
            "report": m.report(),
            "reshape": (m.reshapes, m.reshape_gpu_seconds,
                        m.lost_gpu_seconds, m.overhead_gpu_seconds,
                        m.useful_gpu_seconds),
            "counts": (res.end_time, res.cycles, res.failures,
                       res.interrupts)}


# ----------------------------------------------------------------------
# Spec contract
# ----------------------------------------------------------------------
def test_spec_ordering_and_lookup():
    def scenario(M):
        spec = make_spec(M)
        assert spec.ideal().shape == (8, 8)
        assert [p.n_gpus for p in spec.by_throughput()] == [64, 32, 16]
        assert spec.plan_for(4, 8).throughput == 0.6
        assert spec.plan_for(3, 8) is None
        assert spec.min_gpus() == 16
        return ([plan_key(p) for p in spec.by_throughput()],
                spec.min_gpus())
    held(scenario)


def test_spec_rejects_duplicates_and_bad_plans():
    def scenario(M):
        errors = []
        for make in (lambda: M.ElasticSpec(plans=(
                         M.ParallelismPlan(2, 8, 1.0),
                         M.ParallelismPlan(2, 8, 0.5))),
                     lambda: M.ParallelismPlan(0, 8, 1.0),
                     lambda: M.ParallelismPlan(2, 8, 0.0),
                     lambda: M.ElasticSpec(plans=())):
            with pytest.raises(ValueError) as exc:
                make()
            errors.append(str(exc.value))
        return errors
    held(scenario)


def test_spec_validates_job_at_construction():
    def scenario(M):
        spec = make_spec(M)
        errors = []
        # Shape must equal the ideal plan's shape.
        with pytest.raises(ValueError) as exc:
            M.Job(uid=1, tenant="t0", gpu_type=0, n_pods=4, gpus_per_pod=8,
                  duration=100.0, elastic=spec)
        errors.append(str(exc.value))
        # Gang-scheduled training only.
        with pytest.raises(ValueError) as exc:
            M.Job(uid=1, tenant="t0", gpu_type=0, n_pods=8, gpus_per_pod=8,
                  duration=100.0, kind=M.JobKind.INFER, gang=False,
                  elastic=spec)
        errors.append(str(exc.value))
        return errors
    held(scenario)


def test_from_throughputs_packs_at_node_granularity():
    def scenario(M):
        spec = M.ElasticSpec.from_throughputs([(64, 1.0), (32, 0.6),
                                               (4, 0.1)])
        assert spec.plan_for(8, 8).throughput == 1.0
        assert spec.plan_for(4, 8).throughput == 0.6
        assert spec.plan_for(1, 4).throughput == 0.1
        with pytest.raises(ValueError) as exc:
            M.ElasticSpec.from_throughputs([(12, 0.5)])  # not a node multiple
        return [plan_key(p) for p in spec.plans], str(exc.value)
    held(scenario)


def test_job_work_rate_defaults():
    def scenario(M):
        job = rigid_job(M, uid=1, n_pods=2, duration=100.0)
        assert job.work_rate == 1.0
        assert job.ideal_n_gpus == 16
        ej = elastic_job(M)
        assert ej.work_rate == 1.0                   # ideal until shrunk
        assert ej.ideal_n_gpus == 64
        ej.apply_plan(ej.elastic.plan_for(4, 8))
        assert ej.work_rate == 0.6
        assert ej.n_gpus == 32
        assert ej.ideal_n_gpus == 64                 # yardstick unchanged
        seen = (ej.work_rate, ej.n_gpus, ej.ideal_n_gpus)
        ej.state = M.JobState.RUNNING
        with pytest.raises(ValueError) as exc:
            ej.apply_plan(ej.elastic.ideal())
        return seen, str(exc.value)
    held(scenario)


# ----------------------------------------------------------------------
# Rate-scaled checkpoint recovery
# ----------------------------------------------------------------------
def test_recovery_scales_progress_by_work_rate():
    def scenario(M):
        model = M.CheckpointModel(interval_s=600.0, restart_overhead_s=120.0)
        job = elastic_job(M, duration=3600.0)
        job.apply_plan(job.elastic.plan_for(4, 8))   # rate 0.6
        job.run_time = 0.0
        remaining, lost, overhead = model.on_interrupt(job, 1450.0)
        # 1200 wall = 720 work survive and 250 wall is lost.
        assert job.checkpointed_progress == pytest.approx(720.0)
        assert lost == pytest.approx(250.0)
        assert overhead == 120.0
        assert remaining == pytest.approx((3600.0 - 720.0) / 0.6 + 120.0)
        assert (job.original_duration - job.checkpointed_progress) / 1.0 \
            + 120.0 == pytest.approx(3000.0)
        return remaining, lost, overhead, job.checkpointed_progress
    held(scenario)


def test_recovery_caps_progress_at_remaining_work():
    def scenario(M):
        model = M.CheckpointModel(interval_s=600.0, restart_overhead_s=120.0)
        spec = M.ElasticSpec(plans=(M.ParallelismPlan(4, 8, 1.0),
                                    M.ParallelismPlan(2, 8, 0.5)))
        job = M.Job(uid=1, tenant="t0", gpu_type=0, n_pods=4,
                    gpus_per_pod=8, duration=600.0, elastic=spec)
        job.apply_plan(spec.plan_for(2, 8))          # rate 0.5
        job.run_time = 0.0
        remaining, lost, _ = model.on_interrupt(job, 1450.0)
        assert job.checkpointed_progress == pytest.approx(600.0)
        assert lost == 0.0
        assert remaining == pytest.approx(120.0)
        return remaining, lost, job.checkpointed_progress
    held(scenario)


def test_recovery_rate_one_matches_rigid_math():
    def scenario(M):
        model = M.CheckpointModel(interval_s=600.0, restart_overhead_s=120.0)
        job = elastic_job(M, duration=3600.0)
        job.apply_plan(job.elastic.ideal())
        job.run_time = 0.0
        remaining, lost, _ = model.on_interrupt(job, 1450.0)
        assert job.checkpointed_progress == 1200.0
        assert lost == 250.0
        assert remaining == 3600.0 - 1200.0 + 120.0
        return remaining, lost, job.checkpointed_progress
    held(scenario)


def test_failure_restart_at_smaller_gpu_count():
    def scenario(M):
        topo, state = cluster(M)
        events = [(650.0, M.EventKind.NODE_FAIL, {"node": n})
                  for n in range(10)]
        events += [(100_000.0, M.EventKind.NODE_RECOVER, {"node": n})
                   for n in range(10)]

        class Scripted(M.framework.DynamicsPlugin):
            name = "ScriptedElastic"

            def schedule(self, engine, rng):
                return events

        dyn = M.DynamicsConfig(
            plugins=[Scripted()],
            recovery=M.CheckpointModel(interval_s=600.0,
                                       restart_overhead_s=120.0))
        sim = make_elastic_sim(M, topo, state, dynamics=dyn)
        job = elastic_job(M, duration=3600.0)
        result = sim.run([job])
        assert job.state is M.JobState.COMPLETED
        assert job.interrupt_count == 1 and job.attempt == 1
        assert job.checkpointed_progress == 600.0
        assert job.n_gpus == 32                      # finished shrunk
        assert job.active_plan.throughput == 0.6
        assert job.end_time - job.run_time == pytest.approx(
            120.0 + 3000.0 / 0.6)
        assert result.metrics.useful_gpu_seconds == 3600.0 * 64
        assert result.metrics.reshapes == 0          # forced, not chosen
        state.check_invariants()
        return outcome(result)
    held(scenario)


# ----------------------------------------------------------------------
# Shrink: start now in fragmented capacity instead of queueing
# ----------------------------------------------------------------------
def test_shrinks_into_fragmented_capacity():
    def scenario(M):
        topo, state = cluster(M)
        sim = make_elastic_sim(M, topo, state)
        blocker = rigid_job(M, uid=1, n_pods=12, duration=10_000.0,
                            priority=90)             # leaves 4 nodes free
        job = elastic_job(M, uid=2, duration=3600.0)
        res = sim.run([blocker, job])
        assert job.state is M.JobState.COMPLETED
        assert job.start_time == blocker.start_time, "no queueing"
        assert job.n_gpus == 32 and job.active_plan.throughput == 0.6
        assert job.end_time - job.run_time == pytest.approx(3600.0 / 0.6)
        state.check_invariants()
        return outcome(res)
    held(scenario)


def test_min_rate_floor_queues_instead_of_crawling():
    def scenario(M):
        topo, state = cluster(M)
        manager = M.ElasticManager(M.ElasticConfig(
            policy=M.GreedyElastic(min_rate=0.5)))
        sim = make_elastic_sim(M, topo, state, manager=manager)
        blocker = rigid_job(M, uid=1, n_pods=14, duration=2000.0,
                            priority=90)
        job = elastic_job(M, uid=2, duration=600.0)
        res = sim.run([blocker, job])
        assert job.state is M.JobState.COMPLETED
        assert job.n_gpus == 64, "waited for the ideal shape"
        assert job.run_time >= 2000.0
        state.check_invariants()
        return outcome(res)
    held(scenario)


# ----------------------------------------------------------------------
# Grow: reshape back toward the ideal plan at a checkpoint boundary
# ----------------------------------------------------------------------
def test_grows_at_checkpoint_boundary_when_capacity_frees():
    def scenario(M):
        topo, state = cluster(M)
        sim = make_elastic_sim(M, topo, state)
        blocker = rigid_job(M, uid=1, n_pods=12, duration=650.0,
                            priority=90)
        job = elastic_job(M, uid=2, duration=7200.0)
        result = sim.run([blocker, job])
        m = result.metrics
        assert job.state is M.JobState.COMPLETED
        assert job.n_gpus == 64, "grew back to the ideal plan"
        assert job.reshape_count == 1
        assert m.reshapes == 1
        assert m.reshape_gpu_seconds > 0
        assert m.reshape_gpu_seconds == pytest.approx(
            m.lost_gpu_seconds + m.overhead_gpu_seconds)
        assert m.mttr() == 0.0
        assert job.lost_work < 600.0
        assert m.useful_gpu_seconds == 650.0 * 96 + 7200.0 * 64
        state.check_invariants()
        return outcome(result)
    held(scenario)


def test_no_grow_without_payback():
    def scenario(M):
        topo, state = cluster(M)
        manager = M.ElasticManager(M.ElasticConfig(
            policy=M.GreedyElastic(grow_payback=2.0)))
        sim = make_elastic_sim(M, topo, state, manager=manager)
        blocker = rigid_job(M, uid=1, n_pods=12, duration=650.0,
                            priority=90)
        job = elastic_job(M, uid=2, duration=400.0)
        result = sim.run([blocker, job])
        assert job.state is M.JobState.COMPLETED
        assert job.reshape_count == 0
        assert result.metrics.reshapes == 0
        assert job.n_gpus == 32, "finished at the shrunk plan"
        return outcome(result)
    held(scenario)


def test_scratch_recovery_never_grows():
    def scenario(M):
        topo, state = cluster(M)
        manager = M.ElasticManager(M.ElasticConfig(
            recovery=M.CheckpointModel(interval_s=600.0,
                                       restart_overhead_s=120.0,
                                       mode="scratch")))
        sim = make_elastic_sim(M, topo, state, manager=manager)
        blocker = rigid_job(M, uid=1, n_pods=12, duration=650.0,
                            priority=90)
        job = elastic_job(M, uid=2, duration=7200.0)
        result = sim.run([blocker, job])
        assert job.state is M.JobState.COMPLETED
        assert job.reshape_count == 0 and result.metrics.reshapes == 0
        return outcome(result)
    held(scenario)


# ----------------------------------------------------------------------
# Byte-identity: no ElasticSpec -> the rigid path, exactly
# ----------------------------------------------------------------------
def test_manager_without_specs_is_byte_identical():
    def scenario(M):
        topo, _ = cluster(M)

        def run(with_manager):
            st = M.ClusterState.create(topo)
            if with_manager:
                sim = make_elastic_sim(M, topo, st)
            else:
                qsch = M.QSCH(M.QuotaManager({"t0": {0: 1024}}),
                              M.RSCH(topo, rsch_config(M)),
                              M.QSCHConfig(policy=M.QueuePolicy.BACKFILL))
                sim = M.Simulator(st, qsch,
                                  M.SimConfig(tick_interval=30.0,
                                              sample_interval=300.0,
                                              binding_latency=0.0))
            jobs = [j for j in M.training_trace(40, seed=3,
                                                arrival_rate_per_hour=900,
                                                mean_duration_s=900.0)
                    if j.n_gpus <= 64]
            res = sim.run(jobs)
            return ([(j.uid, j.start_time, j.end_time,
                      tuple((p.node, p.gpu_indices)
                            for p in j.placement.pods))
                     for j in res.jobs if j.placement],
                    res.metrics.report())

        managed = run(True)
        assert managed == run(False)
        return managed
    held(scenario)


# ----------------------------------------------------------------------
# Promoted waiting_percentile
# ----------------------------------------------------------------------
def test_waiting_percentile_promoted_and_reexported():
    def scenario(M):
        assert M.federation.waiting_percentile is M.waiting_percentile
        jobs = [rigid_job(M, uid=i, n_pods=1, duration=10.0)
                for i in range(4)]
        for i, j in enumerate(jobs[:3]):
            j.start_time = j.submit_time + 100.0 * i     # waits 0/100/200
        p50 = M.waiting_percentile(jobs, 50.0)
        assert p50 == pytest.approx(100.0)
        empty = M.waiting_percentile([], 90.0)
        assert math.isnan(empty)
        return p50, empty
    held(scenario)


# ----------------------------------------------------------------------
# Combo cache + plan estimation
# ----------------------------------------------------------------------
def test_combo_cache_counters():
    def scenario(M):
        c = COMBO[M].ComboCache("t")
        seen = []
        assert c.get("k") is None
        seen.append(c.stats())
        assert seen[-1] == {"name": "t", "hits": 0, "misses": 1, "size": 0}
        c.put("k", 5)
        assert c.get("k") == 5 and c.hits == 1
        assert c.get_or("j", lambda: 7) == 7         # miss + compute
        assert c.get_or("j", lambda: 0) == 7         # hit, not recomputed
        assert len(c) == 2 and "j" in c
        seen.append(c.stats())
        c.clear()
        seen.append(c.stats())
        assert seen[-1] == {"name": "t", "hits": 0, "misses": 0, "size": 0}
        return seen
    held(scenario)


def test_mesh_key_duck_typed():
    class FakeMesh:
        axis_names = ("data", "model")
        shape = {"data": 16, "model": 8}

    def scenario(M):
        key = COMBO[M].mesh_key(FakeMesh())
        assert key == (("data", 16), ("model", 8))
        return key
    held(scenario)


def test_step_time_and_scaling_artifacts():
    def scenario(M):
        E = M.elastic
        arts = E.scaling_artifacts("gpt", "small", [32, 64, 128],
                                   base_step_s=1.0, alpha=0.85)
        by_chips = {a["chips"]: a for a in arts}
        assert E.step_time_from_terms(by_chips[128]) == pytest.approx(1.0)
        t64 = 1.0 / E.step_time_from_terms(by_chips[64])
        t128 = 1.0 / E.step_time_from_terms(by_chips[128])
        assert t64 < t128 < 2.0 * t64
        with pytest.raises(ValueError) as exc:
            E.step_time_from_terms({"compute_term_s": 0.0})
        return arts, (t64, t128), str(exc.value)
    held(scenario)


def test_spec_from_artifacts_memoized():
    def scenario(M):
        cache = M.elastic.plan_cache()
        cache.clear()
        arts = M.scaling_artifacts("llama", "small", [32, 64, 128])
        a = M.spec_from_artifacts(arts)
        assert cache.stats()["misses"] == 1
        b = M.spec_from_artifacts(list(reversed(arts)))  # order-insensitive
        assert b is a
        assert cache.stats()["hits"] == 1
        assert a.ideal().n_gpus == 128
        with pytest.raises(ValueError) as exc:
            M.spec_from_artifacts(arts + M.scaling_artifacts("gpt", "small",
                                                             [32]))
        job = M.Job(uid=9, tenant="t0", gpu_type=0, n_pods=16,
                    gpus_per_pod=8, duration=100.0, elastic=a)
        assert job.work_rate == 1.0
        return ([plan_key(p) for p in a.plans], M.elastic.plan_cache_stats(),
                str(exc.value))
    held(scenario)


# ----------------------------------------------------------------------
# Port side: the plan cache is the port's own, and elastic jobs place
# the same on every score backend and gang path
# ----------------------------------------------------------------------
def test_plan_caches_are_separate_objects():
    assert T.elastic.plan_cache() is not R.elastic.plan_cache()
    assert type(T.elastic.plan_cache()).__module__ == \
        "repro_torch.launch.combo_cache"
    names = T_combo.cache_stats()
    assert "elastic-plans" in names


@pytest.mark.parametrize("backend,batched", [("kernel", True),
                                             ("kernel", False),
                                             ("np", False)])
def test_elastic_shrink_and_grow_equal_across_backends(backend, batched):
    """A shrink and a later grow decide the same on the plain torch path
    (the kernels' CPU version), on either gang path, as on numpy."""
    def run(backend, batched):
        topo, state = cluster(T)
        qsch = T.QSCH(T.QuotaManager({"t0": {0: 1024}}),
                      T.RSCH(topo, T.RSCHConfig(device="cpu",
                                                score_backend=backend,
                                                batched_gang=batched)),
                      T.QSCHConfig(), elastic=T.ElasticManager())
        sim = T.Simulator(state, qsch, T.SimConfig(
            tick_interval=30.0, sample_interval=300.0, binding_latency=0.0))
        blocker = rigid_job(T, uid=1, n_pods=12, duration=650.0,
                            priority=90)
        job = elastic_job(T, uid=2, duration=7200.0)
        res = sim.run([blocker, job])
        assert job.reshape_count == 1
        return outcome(res)
    assert run(backend, batched) == run("np", True)


def test_core_exports_what_the_reference_exports():
    """``repro_torch.core`` exports every name ``repro.core`` does, each
    the port's own object, with elastic, federation and tuning among
    them."""
    assert set(R.__all__) <= set(T.__all__)
    for name in ("ElasticManager", "spec_from_artifacts", "make_member",
                 "FederatedSimulator", "GSCH", "TuningManager",
                 "HillClimbController", "StarvationEscalator"):
        assert name in T.__all__
    for name in R.__all__:
        obj = getattr(T, name)
        mod = getattr(obj, "__module__", None)
        assert mod is None or not mod.startswith("repro."), (name, mod)
