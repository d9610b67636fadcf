"""The port's cluster dynamics against the JAX package's, on the CPU.

Each test is a port of one test of ``tests/test_dynamics.py``: the same
seeded scenario runs through ``repro.core`` and ``repro_torch.core``
(with ``device="cpu"``, so the score pass runs the kernels' plain
versions).  The scenario makes the reference test's checks on both
packages and returns what it observed — placements, metric reports,
dynamics summaries, event traces, job accounting — which must be equal.
"""

import dataclasses
import math

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T


def canon(x):
    """A comparable copy of ``x``: NaN as a string, numpy scalars as
    Python numbers, enums by name, sequences as tuples."""
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    if isinstance(x, np.ndarray):
        return canon(x.tolist())
    if isinstance(x, np.generic):
        x = x.item()
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if hasattr(x, "name") and hasattr(x, "value") and not isinstance(
            x, (int, float, str)):
        return x.name
    return x


def held(scenario, *args):
    """Run ``scenario`` on the reference, then on the port; the port's
    observations must equal the reference's."""
    want = canon(scenario(R, *args))
    got = canon(scenario(T, *args))
    assert got == want
    return got


def rsch_config(M, **kw):
    return M.RSCHConfig(**kw, **({"device": "cpu"} if M is T else {}))


def cluster(M):
    topo = M.small_topology(n_nodes=16, gpus_per_node=8, nodes_per_leaf=4)
    return topo, M.ClusterState.create(topo)


def make_qsch(M, topo, *, quota=None, incremental=True):
    qm = M.QuotaManager(quota or {"t0": {0: 1024}},
                        mode=M.QuotaMode.ISOLATED)
    return M.QSCH(qm, M.RSCH(topo, rsch_config(M)),
                  M.QSCHConfig(policy=M.QueuePolicy.BACKFILL),
                  incremental_snapshots=incremental)


def make_sim(M, topo, state, *, dynamics=None, horizon=None, binding=0.0,
             quota=None, tick=30.0):
    return M.Simulator(state, make_qsch(M, topo, quota=quota),
                       M.SimConfig(tick_interval=tick, sample_interval=300.0,
                                   binding_latency=binding, horizon=horizon,
                                   dynamics=dynamics))


def train_job(M, uid=1, n_pods=2, gpus_per_pod=8, duration=3600.0,
              submit=0.0, priority=50, preemptible=True, tenant="t0"):
    return M.Job(uid=uid, tenant=tenant, gpu_type=0, n_pods=n_pods,
                 gpus_per_pod=gpus_per_pod, submit_time=submit,
                 duration=duration, priority=priority,
                 preemptible=preemptible)


def scripted(M, events):
    """A dynamics plugin that replays a fixed event trace."""
    class Scripted(M.framework.DynamicsPlugin):
        name = "ScriptedEvents"

        def schedule(self, engine, rng):
            return events
    return Scripted()


def job_key(j):
    pods = None if j.placement is None else tuple(
        (p.node, tuple(p.gpu_indices)) for p in j.placement.pods)
    return (j.uid, j.state.name, j.start_time, j.end_time, j.run_time, pods,
            j.attempt, j.interrupt_count, j.preempt_count,
            j.checkpointed_progress, j.lost_work, j.restart_overhead)


def outcome(res):
    """Everything a run reports: placements and job accounting, the
    metric report, the loop's counters and the dynamics summary."""
    return {"jobs": [job_key(j) for j in sorted(res.jobs,
                                                key=lambda j: j.uid)],
            "report": res.metrics.report(),
            "counts": (res.end_time, res.cycles, res.preemptions,
                       res.admit_rejected, res.infeasible, res.requeues,
                       res.failures, res.interrupts, res.drains,
                       res.scale_events),
            "dynamics": None if res.dynamics is None
            else res.dynamics.as_dict()}


def demand_log(scaler):
    return [dataclasses.astuple(s) for s in scaler.demand_log]


# ----------------------------------------------------------------------
# Event bus
# ----------------------------------------------------------------------
def test_event_bus_same_timestamp_order():
    def scenario(M):
        bus = M.EventBus()
        seen = []
        K = M.EventKind
        for kind in (K.SAMPLE, K.TICK, K.NODE_FAIL, K.END, K.SUBMIT):
            bus.subscribe(kind, lambda ev: seen.append(ev.kind))
            bus.push(10.0, kind)
        while len(bus):
            bus.dispatch(bus.pop())
        assert seen == [K.SUBMIT, K.END, K.NODE_FAIL, K.TICK, K.SAMPLE]
        return [k.name for k in seen]
    held(scenario)


def test_event_bus_pending_counters():
    def scenario(M):
        K = M.EventKind
        bus = M.EventBus()
        bus.push(1.0, K.SUBMIT)
        bus.push(2.0, K.SUBMIT)
        bus.push(1.5, K.TICK)
        before = bus.pending(K.SUBMIT)
        bus.pop()
        after = (bus.pending(K.SUBMIT), bus.pending(K.TICK),
                 bus.pending(K.NODE_FAIL))
        assert (before, after) == (2, (1, 1, 0))
        return before, after
    held(scenario)


# ----------------------------------------------------------------------
# Failure injectors: seeded, reproducible traces
# ----------------------------------------------------------------------
class _FakeEngine:
    def __init__(self, state, horizon):
        self.state = state
        self.horizon = horizon


def _trace(trace):
    return [(t, kind.name, payload) for t, kind, payload in trace]


def test_node_injector_deterministic():
    def scenario(M):
        _, state = cluster(M)
        eng = _FakeEngine(state, horizon=86400.0)
        inj = M.NodeFailureInjector(mtbf_s=6 * 3600.0, repair_s=1800.0,
                                    shape=1.2)
        a = inj.schedule(eng, np.random.default_rng(7))
        b = inj.schedule(eng, np.random.default_rng(7))
        c = inj.schedule(eng, np.random.default_rng(8))
        assert a == b and a != c and a
        fails = [e for e in a if e[1] is M.EventKind.NODE_FAIL]
        recovers = [e for e in a if e[1] is M.EventKind.NODE_RECOVER]
        assert len(fails) == len(recovers)
        assert all(t <= 86400.0 for t, _, _ in fails)
        return _trace(a), _trace(c)
    held(scenario)


def test_gpu_injector_bounds():
    def scenario(M):
        _, state = cluster(M)
        eng = _FakeEngine(state, horizon=86400.0)
        inj = M.GpuFailureInjector(rate_per_gpu_hour=0.001)
        trace = inj.schedule(eng, np.random.default_rng(0))
        for _, kind, payload in trace:
            assert 0 <= payload["node"] < state.n_nodes
            assert 0 <= payload["gpu"] < state.gpus_per_node
        return _trace(trace)
    held(scenario)


# ----------------------------------------------------------------------
# Checkpoint model math
# ----------------------------------------------------------------------
def _interrupts(model_kw, duration, steps, kind=None):
    """Scenario: interrupt one job at each (run_time, attempt, now) of
    ``steps``; returns each (remaining, lost, overhead) and the job's
    accounting after each."""
    def scenario(M):
        model = M.CheckpointModel(**model_kw)
        job = train_job(M, duration=duration)
        if kind is not None:
            job.kind = getattr(M.JobKind, kind)
        out = []
        for run_time, attempt, now in steps:
            job.run_time = run_time
            job.attempt = attempt
            out.append((model.on_interrupt(job, now),
                        job.checkpointed_progress, job.lost_work,
                        job.restart_overhead))
        return out
    return held(scenario)


CKPT = {"interval_s": 600.0, "restart_overhead_s": 120.0}


def test_checkpoint_model_partial_progress():
    (res, ckpt, _, _), = _interrupts(CKPT, 3600.0, [(0.0, 0, 1450.0)])
    # 1450s of progress -> last checkpoint at 1200s, 250s recomputed.
    assert ckpt == 1200.0
    assert res == (3600.0 - 1200.0 + 120.0, 250.0, 120.0)


def test_checkpoint_model_second_failure_accounts_overhead():
    _, (res, ckpt, lost, overhead) = _interrupts(
        CKPT, 3600.0, [(0.0, 0, 1450.0), (2000.0, 1, 2850.0)])
    # Second attempt runs 2000..2850: 850 elapsed minus 120 restore =
    # 730 progress -> one more 600s checkpoint, 130 lost.
    assert ckpt == 1800.0
    assert res[:2] == (3600.0 - 1800.0 + 120.0, 130.0)
    assert lost == 250.0 + 130.0
    assert overhead == 240.0


def test_checkpoint_model_scratch_loses_everything():
    (res, ckpt, _, _), = _interrupts({**CKPT, "mode": "scratch"}, 3600.0,
                                     [(0.0, 0, 1450.0)])
    assert ckpt == 0.0
    assert res[:2] == (3600.0 + 120.0, 1450.0)


def test_checkpoint_model_stateless_service():
    (res, _, _, _), = _interrupts(
        {"interval_s": 600.0, "restart_overhead_s": 60.0}, 7200.0,
        [(0.0, 0, 1000.0)], kind="INFER")
    assert res[:2] == (7200.0 - 1000.0 + 60.0, 0.0)  # serving not redone


def test_checkpoint_model_killed_during_binding():
    # run_time 500 > now 400: the container was not yet running.
    (res, ckpt, _, _), = _interrupts(CKPT, 3600.0, [(500.0, 0, 400.0)])
    assert ckpt == 0.0
    assert res[:2] == (3600.0 + 120.0, 0.0)


# ----------------------------------------------------------------------
# Failure -> kill -> requeue -> recover, end to end
# ----------------------------------------------------------------------
def _whole_cluster(M, n_nodes, fail_at, recover_at):
    K = M.EventKind
    return ([(fail_at, K.NODE_FAIL, {"node": n}) for n in range(n_nodes)]
            + [(recover_at, K.NODE_RECOVER, {"node": n})
               for n in range(n_nodes)])


def test_node_fail_kills_requeues_and_recovers():
    def scenario(M):
        topo, state = cluster(M)
        dyn = M.DynamicsConfig(
            plugins=[scripted(M, _whole_cluster(M, state.n_nodes, 650.0,
                                                1200.0))],
            recovery=M.CheckpointModel(**CKPT))
        job = train_job(M, duration=3600.0)
        result = make_sim(M, topo, state, dynamics=dyn).run([job])
        assert job.state is M.JobState.COMPLETED
        assert job.interrupt_count == 1 and job.attempt == 1
        # 650s elapsed -> the checkpoint at 600 survives; the second
        # attempt is 3600 - 600 + 120 = 3120s long.
        assert job.checkpointed_progress == 600.0
        assert job.lost_work == 50.0
        assert job.end_time == pytest.approx(job.run_time + 3120.0)
        assert result.failures == state.n_nodes
        assert result.interrupts == 1
        assert state.node_healthy.all()
        assert state.total_allocated() == 0
        state.check_invariants()
        assert result.metrics.mttr() >= 1200.0 - 650.0
        assert result.metrics.lost_gpu_seconds == 50.0 * job.n_gpus
        return outcome(result)
    held(scenario)


def test_gpu_fail_kills_only_resident_job():
    def scenario(M):
        topo, state = cluster(M)
        K = M.EventKind
        sim = make_sim(M, topo, state, dynamics=M.DynamicsConfig(plugins=[
            scripted(M, [(500.0, K.GPU_FAIL, {"node": 0, "gpu": 0}),
                         (2000.0, K.GPU_RECOVER, {"node": 0, "gpu": 0})])]))
        # Binpack fills node 0 first: job a lands there, job b elsewhere.
        a = train_job(M, uid=1, n_pods=1, duration=3000.0)
        b = train_job(M, uid=2, n_pods=1, duration=3000.0)
        result = sim.run([a, b])
        assert a.state is b.state is M.JobState.COMPLETED
        assert len([j for j in (a, b) if j.interrupt_count]) == 1
        assert result.failures == 1
        state.check_invariants()
        return outcome(result)
    held(scenario)


def test_stale_end_event_ignored_after_interrupt():
    def scenario(M):
        topo, state = cluster(M)
        dyn = M.DynamicsConfig(plugins=[scripted(
            M, _whole_cluster(M, state.n_nodes, 650.0, 700.0))])
        job = train_job(M, duration=3600.0)
        result = make_sim(M, topo, state, dynamics=dyn).run([job])
        assert job.state is M.JobState.COMPLETED
        # The killed attempt's END (~3600) must not end the restart.
        assert job.end_time > 3600.0
        return outcome(result)
    held(scenario)


# ----------------------------------------------------------------------
# Drain windows
# ----------------------------------------------------------------------
def test_drain_excludes_new_placements_keeps_running():
    def scenario(M):
        topo, state = cluster(M)
        dyn = M.DynamicsConfig(plugins=[
            M.DrainWindow(nodes=range(8), start=1000.0, duration=4000.0)])
        a = train_job(M, uid=1, n_pods=8, duration=3000.0)
        b = train_job(M, uid=2, n_pods=4, duration=1000.0, submit=1500.0)
        result = make_sim(M, topo, state, dynamics=dyn).run([a, b])
        assert a.state is b.state is M.JobState.COMPLETED
        assert a.interrupt_count == 0, "no-evict drain keeps jobs running"
        assert all(p.node >= 8 for p in b.placement.pods)
        assert not state.node_draining.any()
        state.check_invariants()
        return outcome(result)
    held(scenario)


def test_drain_evict_checkpoint_restarts():
    def scenario(M):
        topo, state = cluster(M)
        K = M.EventKind
        nodes = list(range(16))
        dyn = M.DynamicsConfig(
            plugins=[scripted(M, [
                (700.0, K.DRAIN_START, {"nodes": nodes, "evict": True}),
                (1300.0, K.DRAIN_END, {"nodes": nodes, "evict": True})])],
            recovery=M.CheckpointModel(**CKPT))
        job = train_job(M, duration=3600.0)
        result = make_sim(M, topo, state, dynamics=dyn).run([job])
        assert job.state is M.JobState.COMPLETED
        assert job.interrupt_count == 1
        assert result.dynamics.drain_evictions == 1
        assert job.checkpointed_progress == 600.0
        return outcome(result)
    held(scenario)


def test_overlapping_drain_windows_refcount():
    # A:[100,600) over {0,1}; B:[200,1000) over {1,2}.  Node 1 must stay
    # drained until BOTH windows close.
    def scenario(M, horizon):
        topo, state = cluster(M)
        dyn = M.DynamicsConfig(plugins=[
            M.DrainWindow(nodes=[0, 1], start=100.0, duration=500.0),
            M.DrainWindow(nodes=[1, 2], start=200.0, duration=800.0)])
        result = make_sim(M, topo, state, dynamics=dyn,
                          horizon=horizon).run([train_job(M, duration=50.0)])
        return outcome(result), state.node_draining.copy()
    _, draining = held(scenario, 2000.0)
    assert not any(draining), "every window closed before the horizon"
    _, draining = held(scenario, 700.0)
    assert not draining[0], "A closed at 600"
    assert draining[1], "B still holds node 1"
    assert draining[2]


def test_recovery_past_trace_horizon_not_dropped():
    def scenario(M):
        topo, state = cluster(M)
        dyn = M.DynamicsConfig(
            plugins=[scripted(M, _whole_cluster(M, state.n_nodes, 500.0,
                                                3000.0))],
            trace_horizon=1000.0)
        job = train_job(M, duration=2000.0)
        result = make_sim(M, topo, state, dynamics=dyn).run([job])
        assert job.state is M.JobState.COMPLETED
        assert state.node_healthy.all()
        assert result.end_time > 3000.0
        return outcome(result)
    held(scenario)


# ----------------------------------------------------------------------
# Mid-cycle health changes must invalidate snapshot caches
# ----------------------------------------------------------------------
def test_apply_health_refreshes_rows_and_drops_caches():
    def scenario(M):
        _, state = cluster(M)
        snap = M.IncrementalSnapshotter().take(state)
        pool = snap.candidate_pool(0)           # populate the caches
        snap.derived["group_cap"] = np.ones(3)
        assert pool[3]
        state.set_node_health(3, False)
        snap.apply_health(state, [3])
        after = snap.candidate_pool(0)
        assert not after[3]
        assert snap.free_gpus[3] == 0
        assert not snap.derived, "derived arrays must be dropped"
        return pool, after, snap.free_gpus.copy(), snap.mut_count
    held(scenario)


def test_mid_cycle_node_fail_not_placed_on():
    def scenario(M):
        F = M.framework

        class FailFirstNodeOnBind(F.PostBindPlugin):
            """Fails the first placement's anchor node mid-cycle,
            through the sanctioned sync path."""
            name = "FailFirstNodeOnBind"
            failed_node = None

            def post_bind(self, job, placement, ctx):
                if self.failed_node is None:
                    self.failed_node = placement.pods[0].node
                    ctx.state.set_node_health(self.failed_node, False)
                    ctx.sched.sync_health(ctx.state, [self.failed_node])

        topo, state = cluster(M)
        hook = FailFirstNodeOnBind()
        plan = F.single_pass_plan(F.ebinpack_pass(2.0))
        profiles = F.ProfileSet(
            train=F.make_profile("t", plan, post_bind=(hook,)),
            inference=F.make_profile("i", plan),
            best_effort=F.make_profile("b", plan))
        qsch = M.QSCH(M.QuotaManager({"t0": {0: 1024}}),
                      M.RSCH(topo, rsch_config(M), profiles=profiles),
                      M.QSCHConfig())
        # Without the sync, E-Binpack would pile the second 4-GPU pod
        # onto the same (now dead) node and the bind would explode.
        a = train_job(M, uid=1, n_pods=1, gpus_per_pod=4)
        b = train_job(M, uid=2, n_pods=1, gpus_per_pod=4)
        qsch.submit(a)
        qsch.submit(b)
        result = qsch.cycle(state, 0.0)
        assert len(result.scheduled) == 2
        assert b.placement.pods[0].node != hook.failed_node
        state.check_invariants()
        return [job_key(j) for j in (a, b)], hook.failed_node
    held(scenario)


def test_structurally_unplaceable_job_does_not_thrash():
    # A 16-GPU pod can never fit an 8-GPU node: the preemption engine
    # must not evict anything for it, ever.
    def scenario(M):
        topo, state = cluster(M)
        sim = M.Simulator(state, make_qsch(M, topo),
                          M.SimConfig(tick_interval=30.0, horizon=600.0))
        victim = train_job(M, uid=1, n_pods=4, duration=10_000.0,
                           priority=M.PRIO_LOW)
        giant = train_job(M, uid=2, n_pods=1, gpus_per_pod=16,
                          duration=100.0, priority=M.PRIO_HIGH,
                          submit=100.0)
        result = sim.run([victim, giant])
        assert result.preemptions == 0
        assert victim.preempt_count == 0
        return outcome(result)
    held(scenario)


# ----------------------------------------------------------------------
# Tidal autoscaling
# ----------------------------------------------------------------------
def test_diurnal_curve_shape():
    def scenario(M):
        curve = (M.diurnal_demand(14 * 3600.0, 2, 16),
                 M.diurnal_demand(2 * 3600.0, 2, 16))
        assert curve == pytest.approx((16.0, 2.0))
        svc = M.TidalService(name="s", min_replicas=2, max_replicas=16)
        targets = (svc.target_replicas(14 * 3600.0),
                   svc.target_replicas(2 * 3600.0))
        assert targets == (16, 2)
        return curve, targets
    held(scenario)


def test_tidal_scales_fleet_and_preempts_backfill():
    def scenario(M):
        topo, state = cluster(M)
        svc = M.TidalService(name="s", tenant="svc", gpus_per_replica=4,
                             min_replicas=1, max_replicas=8, peak_hour=14.0)
        scaler = M.TidalAutoscaler([svc], interval_s=900.0)
        sim = make_sim(M, topo, state,
                       dynamics=M.DynamicsConfig(plugins=[scaler]),
                       horizon=86_400.0,
                       quota={"svc": {0: 1024}, "batch": {0: 1024}})
        rng = np.random.default_rng(0)
        backlog = [M.Job(uid=i, tenant="batch", gpu_type=0, n_pods=2,
                         gpus_per_pod=8, priority=M.PRIO_LOW,
                         preemptible=True,
                         submit_time=float(rng.uniform(0, 1800.0)),
                         duration=float(rng.uniform(3.0, 5.0)) * 3600.0)
                   for i in range(40)]
        result = sim.run(backlog)
        assert scaler.replicas_started >= svc.max_replicas
        assert scaler.replicas_retired > 0, "evening ebb must retire"
        assert result.preemptions > 0, "the ramp reclaims backfill GPUs"
        assert scaler.satisfaction() > 0.9
        peak = [s for s in scaler.demand_log
                if 13.5 * 3600 <= s.t <= 14.5 * 3600]
        night = [s for s in scaler.demand_log if s.t <= 2 * 3600]
        assert max(s.fleet for s in peak) >= 7
        assert min(s.fleet for s in night) <= 2
        state.check_invariants()
        return (outcome(result), demand_log(scaler),
                scaler.replicas_started, scaler.replicas_retired,
                scaler.satisfaction())
    held(scenario)


def test_two_autoscalers_do_not_amplify_each_other():
    # Each autoscaler owns its SCALE_DECISION chain: with two of them
    # the event count is the SUM of their cadences, not 2^generations.
    def scenario(M):
        topo, state = cluster(M)
        a = M.TidalAutoscaler([M.TidalService(
            name="a", tenant="svc", min_replicas=0, max_replicas=1)],
            interval_s=900.0)
        b = M.TidalAutoscaler([M.TidalService(
            name="b", tenant="svc", min_replicas=0, max_replicas=1)],
            interval_s=1800.0)
        sim = make_sim(M, topo, state,
                       quota={"t0": {0: 1024}, "svc": {0: 1024}},
                       horizon=4 * 3600.0,
                       dynamics=M.DynamicsConfig(plugins=[a, b]))
        result = sim.run([train_job(M, duration=100.0)])
        assert result.scale_events == (4 * 3600.0 // 900.0 + 1) + (
            4 * 3600.0 // 1800.0 + 1)
        assert len(a.demand_log) == 4 * 3600.0 // 900.0 + 1
        assert len(b.demand_log) == 4 * 3600.0 // 1800.0 + 1
        return outcome(result), demand_log(a), demand_log(b)
    held(scenario)


def test_retired_replica_credits_pre_interruption_serving():
    # A replica serves, a failure interrupts it, it serves again: its
    # checkpointed (stateless) serving may not be lost.
    def scenario(M):
        topo, state = cluster(M)
        svc = M.TidalService(name="s", tenant="svc", gpus_per_replica=4,
                             min_replicas=1, max_replicas=1)
        scaler = M.TidalAutoscaler([svc], interval_s=600.0)
        dyn = M.DynamicsConfig(
            plugins=[scaler, scripted(M, _whole_cluster(
                M, state.n_nodes, 1800.0, 1900.0))],
            recovery=M.CheckpointModel(interval_s=600.0,
                                       restart_overhead_s=100.0))
        sim = make_sim(M, topo, state,
                       quota={"t0": {0: 1024}, "svc": {0: 1024}},
                       horizon=7200.0, dynamics=dyn)
        result = sim.run([])
        assert result.metrics.lost_gpu_seconds == 0.0
        assert result.interrupts == 1
        assert result.metrics.useful_gpu_seconds >= 0.0
        running = [job_key(j) for j in sim.qsch.running.values()]
        return outcome(result), demand_log(scaler), running
    held(scenario)


def test_retire_after_interrupt_unit():
    # retire_job sums checkpointed serving and the current attempt
    # (minus the restore overhead).
    def scenario(M):
        topo, state = cluster(M)
        sim = M.Simulator(state, make_qsch(M, topo), M.SimConfig())
        eng = M.dynamics.engine.ClusterDynamics(M.DynamicsConfig(
            recovery=M.CheckpointModel(interval_s=600.0,
                                       restart_overhead_s=100.0)))
        eng.attach(sim)
        job = M.Job(uid=1, tenant="t0", gpu_type=0, n_pods=1,
                    gpus_per_pod=4, kind=M.JobKind.INFER, gang=False,
                    duration=100_000.0)
        job.checkpointed_progress = 7200.0      # served 2h before a failure
        job.attempt = 1
        sim.qsch.submit(job)
        sim.qsch.cycle(state, 0.0)
        job.run_time = 0.0
        eng.retire_job(job, 3700.0)             # 3700 elapsed - 100 restore
        assert job.state is M.JobState.COMPLETED
        assert job.original_duration == 7200.0 + 3600.0
        assert sim.metrics.useful_gpu_seconds == (7200.0 + 3600.0) * 4
        return (job_key(job), job.original_duration,
                sim.metrics.useful_gpu_seconds, eng.summary.as_dict())
    held(scenario)


def test_scale_decision_revives_dead_tick_chain():
    # All training is done long before the autoscaler wants replicas:
    # the SCALE_DECISION must restart the tick chain.
    def scenario(M):
        topo, state = cluster(M)
        svc = M.TidalService(name="s", tenant="svc", gpus_per_replica=4,
                             min_replicas=0, max_replicas=4, peak_hour=6.0)
        scaler = M.TidalAutoscaler([svc], interval_s=3600.0)
        sim = make_sim(M, topo, state,
                       dynamics=M.DynamicsConfig(plugins=[scaler]),
                       horizon=8 * 3600.0,
                       quota={"t0": {0: 1024}, "svc": {0: 1024}})
        short = train_job(M, duration=120.0)
        result = sim.run([short])
        assert short.state is M.JobState.COMPLETED
        assert [s for s in scaler.demand_log if s.running > 0], \
            "replicas submitted after idle must still get scheduled"
        return outcome(result), demand_log(scaler)
    held(scenario)


# ----------------------------------------------------------------------
# Parity: disabled dynamics changes nothing
# ----------------------------------------------------------------------
def test_empty_dynamics_is_byte_identical():
    def scenario(M, empty):
        topo, state = cluster(M)
        sim = make_sim(M, topo, state, binding=10.0,
                       dynamics=M.DynamicsConfig() if empty else None)
        jobs = [j for j in M.training_trace(40, seed=3,
                                            arrival_rate_per_hour=900,
                                            mean_duration_s=900.0)
                if j.n_gpus <= 64]
        res = sim.run(jobs)
        return ([job_key(j) for j in res.jobs if j.placement],
                res.metrics.report())
    assert held(scenario, True) == held(scenario, False)
