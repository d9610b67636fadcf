"""The port's self-tuning against the JAX package's, on the CPU.

Each test is a port of one test of ``tests/test_tuning.py``: the same
scenario runs through ``repro.core`` and ``repro_torch.core`` (with
``device="cpu"``, so the score pass runs the kernels' plain versions).
The scenario makes the reference test's checks on both packages and
returns what it observed — placements, metric reports, sample series,
the whole param-change log, controller counters — which must be equal.

Two reference tests need ``repro.obs`` (the registry gauge, the audit
and the trace of a parameter change) and wait for its port:
``test_param_change_reaches_registry_audit_and_trace`` and
``test_scoped_param_change_labels_member``.

The port-side tests at the end run a climb over every handle (score
weights included) across the score backends and gang paths, and follow
a weight write into the next score pass.
"""

import dataclasses
import json
import types

import numpy as np
import pytest

import repro_torch.core as T
import repro_torch.core.rsch as T_rsch

from test_torch_dynamics import held, rsch_config


def small(M):
    return M.small_topology(n_nodes=16, gpus_per_node=8, nodes_per_leaf=4)


def trace(M, n, seed):
    """Placeable trace for the 16-node test topology."""
    return [j for j in M.training_trace(n, seed=seed,
                                        arrival_rate_per_hour=400,
                                        mean_duration_s=1200.0)
            if j.n_gpus <= 64]


def make_qsch(M, topo, *, policy=None, rsch_cfg=None):
    qm = M.QuotaManager({"t0": {0: 1024}}, mode=M.QuotaMode.ISOLATED)
    return M.QSCH(qm, M.RSCH(topo, rsch_cfg or rsch_config(M)),
                  M.QSCHConfig(policy=policy or M.QueuePolicy.BACKFILL),
                  incremental_snapshots=True)


def make_sim(M, topo, *, policy=None, strategy=None, horizon=None, **kw):
    state = M.ClusterState.create(topo)
    cfg = rsch_config(M, train_strategy=strategy or M.Strategy.E_BINPACK,
                      **kw)
    qsch = make_qsch(M, topo, policy=policy, rsch_cfg=cfg)
    return M.Simulator(state, qsch, M.SimConfig(horizon=horizon))


def placement_fingerprint(jobs):
    return [(j.uid, j.start_time, j.end_time,
             tuple((p.node, tuple(p.gpu_indices)) for p in j.placement.pods)
             if j.placement else None)
            for j in jobs]


def changes(space):
    return [dataclasses.astuple(c) for c in space.changes]


def run_outcome(res):
    return {"jobs": placement_fingerprint(res.jobs),
            "report": res.metrics.report(),
            "samples": [dataclasses.astuple(s) for s in res.metrics.samples],
            "cycles": res.cycles}


# ----------------------------------------------------------------------
# ParamSpace contract
# ----------------------------------------------------------------------
def make_space(M, lo=0.0, hi=10.0, step=1.0, integer=False, init=5.0):
    space = M.ParamSpace()
    box = {"v": init}
    space.register("p", lambda: box["v"],
                   lambda v: box.__setitem__("v", v),
                   lo=lo, hi=hi, max_step=step, integer=integer)
    return space, box


def test_set_clamps_to_bounds_and_rate_limit():
    def scenario(M):
        space, box = make_space(M)
        got = [space.set("p", 10.0)]
        assert got[-1] == 6.0 and box["v"] == 6.0
        got.append(space.set("p", 99.0, force=True))
        assert got[-1] == 10.0
        got.append(space.set("p", -99.0, force=True))
        assert got[-1] == 0.0
        got.append(space.set("p", 5.0))
        assert got[-1] == 1.0
        return got, changes(space)
    held(scenario)


def test_integer_handles_round():
    def scenario(M):
        space, box = make_space(M, integer=True, step=4.0)
        got = space.set("p", 7.4)
        assert got == 7.0 and box["v"] == 7.0
        return got, changes(space)
    held(scenario)


def test_noop_write_records_nothing():
    def scenario(M):
        space, _ = make_space(M)
        seen = []
        space.on_change = seen.append
        assert space.set("p", 5.0) == 5.0
        assert space.changes == [] and seen == []
        space.set("p", 5.5)
        assert len(space.changes) == 1 and len(seen) == 1
        ch = space.changes[0]
        assert (ch.param, ch.previous, ch.value) == ("p", 5.0, 5.5)
        return changes(space), [dataclasses.astuple(c) for c in seen]
    held(scenario)


def test_apply_skips_unknown_and_forces():
    def scenario(M):
        space, box = make_space(M)
        skipped = space.apply({"p": 9.0, "ghost": 1.0})
        assert skipped == ["ghost"]
        assert box["v"] == 9.0
        assert space.changes[0].source == "warm-start"
        return skipped, changes(space)
    held(scenario)


def test_duplicate_registration_raises():
    def scenario(M):
        space, _ = make_space(M)
        with pytest.raises(ValueError) as exc:
            space.register("p", lambda: 0.0, lambda v: None,
                           lo=0.0, hi=1.0, max_step=0.1)
        return str(exc.value)
    held(scenario)


def test_bind_profile_weights_discovers_fused_terms():
    def scenario(M):
        space = M.ParamSpace()
        names = M.tuning.bind_profile_weights(
            space, M.framework.default_profiles(small(M)))
        assert "train-e-binpack.BinpackScore.used" in names
        assert "inference-e-spread.SpreadScore.used" in names
        pos = space.param("train-e-binpack.BinpackScore.used")
        assert pos.lo == 0.0 and pos.hi > 0
        neg = space.param("inference-e-spread.SpreadScore.used")
        assert neg.hi == 0.0 and neg.lo < 0
        space.set("train-e-binpack.BinpackScore.used", 1.25, force=True)
        assert space.get("train-e-binpack.BinpackScore.used") == 1.25
        return names, [(n, space.param(n).lo, space.param(n).hi,
                        space.param(n).max_step) for n in names], \
            space.snapshot()
    held(scenario)


# ----------------------------------------------------------------------
# Controller parity: attached-but-silent == detached
# ----------------------------------------------------------------------
@pytest.mark.parametrize("policy,strategy", [
    ("BACKFILL", "E_BINPACK"),
    ("STRICT_FIFO", "BINPACK"),
    ("BEST_EFFORT_FIFO", "E_SPREAD"),
])
def test_noop_controller_byte_identity(policy, strategy):
    def scenario(M):
        jobs = trace(M, 40, seed=7)

        def run(attach):
            sim = make_sim(M, small(M), policy=M.QueuePolicy[policy],
                           strategy=M.Strategy[strategy])
            mgr = None
            if attach:
                mgr = M.TuningManager([M.NoOpController()])
                mgr.attach(sim)
            res = sim.run([dataclasses.replace(j) for j in jobs])
            return res, mgr

        res_a, _ = run(attach=False)
        res_b, mgr = run(attach=True)
        assert placement_fingerprint(res_a.jobs) == \
            placement_fingerprint(res_b.jobs)
        assert [dataclasses.asdict(s) for s in res_a.metrics.samples] == \
            [dataclasses.asdict(s) for s in res_b.metrics.samples]
        assert repr(res_a.metrics.report()) == repr(res_b.metrics.report())
        assert mgr.controllers[0].ticks_seen == res_b.cycles
        assert mgr.space.changes == []
        return run_outcome(res_b), mgr.controllers[0].ticks_seen, \
            mgr.space.names()
    held(scenario)


# ----------------------------------------------------------------------
# Hill climb: hysteresis + revert-on-regression
# ----------------------------------------------------------------------
def window_scoring(M, value):
    w = M.TuningWindow(t0=0.0, t1=1800.0)
    w.samples.append(M.metrics.Sample(t=0.0, gar=value, gfr=0.0,
                                      allocated=0, capacity=0,
                                      queue_depth=0))
    return w


def climb_fixture(M, seed=0):
    space, box = make_space(M, lo=0.0, hi=10.0, step=1.0, init=5.0)
    ctl = M.HillClimbController(objective=M.ObjectiveWeights(), seed=seed,
                                epsilon=0.0, hysteresis=0.05)
    mgr = M.TuningManager([ctl])
    ctl.bind(space, mgr)
    return ctl, space, box


def climb_state(ctl, space, box):
    return (ctl.baseline, ctl.moves, ctl.accepts, ctl.reverts, box["v"],
            changes(space))


def test_hill_climb_reverts_on_regression():
    def scenario(M):
        ctl, space, box = climb_fixture(M)
        ctl.control(window_scoring(M, 0.6), space)
        assert ctl.baseline == pytest.approx(0.6)
        assert ctl.moves == 1
        assert box["v"] != 5.0
        ctl.control(window_scoring(M, 0.4), space)
        assert ctl.reverts == 1 and ctl.accepts == 0
        assert box["v"] == 5.0
        assert ctl.baseline == pytest.approx(0.6)
        assert space.changes[-1].source.endswith(":revert")
        return climb_state(ctl, space, box)
    held(scenario)


def test_hill_climb_accepts_improvement_beyond_hysteresis():
    def scenario(M):
        ctl, space, box = climb_fixture(M)
        ctl.control(window_scoring(M, 0.6), space)
        probed = box["v"]
        ctl.control(window_scoring(M, 0.9), space)
        assert ctl.accepts == 1 and ctl.reverts == 0
        assert box["v"] == probed
        assert ctl.baseline == pytest.approx(0.9)
        return climb_state(ctl, space, box)
    held(scenario)


def test_hill_climb_hysteresis_blocks_noise():
    def scenario(M):
        ctl, space, box = climb_fixture(M)
        ctl.control(window_scoring(M, 0.6), space)
        ctl.control(window_scoring(M, 0.62), space)
        assert ctl.reverts == 1
        assert box["v"] == 5.0
        return climb_state(ctl, space, box)
    held(scenario)


def test_warm_start_seeds_baseline():
    def scenario(M):
        ctl, space, box = climb_fixture(M)
        prof = M.TuningProfile(name="donor", params={"p": 8.0},
                               objective=0.7)
        mgr = M.TuningManager([ctl])
        mgr.space = space
        space.on_change = mgr._emit_change
        mgr.warm_start(prof)
        assert space.get("p") == 8.0
        assert ctl.baseline == pytest.approx(0.7)
        return climb_state(ctl, space, box)
    held(scenario)


# ----------------------------------------------------------------------
# Starvation escalator
# ----------------------------------------------------------------------
def test_escalator_boosts_and_caps():
    def scenario(M):
        topo = small(M)
        qsch = make_qsch(M, topo)
        esc = M.StarvationEscalator(wait_threshold_s=3600.0, boost=30,
                                    escalation_period_s=1800.0)
        space = M.ParamSpace()
        esc.bind(space, M.TuningManager())
        assert "escalator.wait_threshold_s" in space
        jobs = [M.Job(uid=1, tenant="t0", gpu_type=0, n_pods=1,
                      gpus_per_pod=8, submit_time=0.0),
                M.Job(uid=2, tenant="t0", gpu_type=0, n_pods=1,
                      gpus_per_pod=8, submit_time=5000.0)]
        for j in jobs:
            qsch.submit(j)
        seen = []
        for now, want0, want1 in (
                (3599.0, M.PRIO_NORMAL, M.PRIO_NORMAL),
                (3600.0, M.PRIO_NORMAL + 30, M.PRIO_NORMAL),
                (4000.0, M.PRIO_NORMAL + 30, M.PRIO_NORMAL),
                (5400.0, M.PRIO_HIGH, M.PRIO_NORMAL),
                (9000.0, M.PRIO_HIGH, M.PRIO_NORMAL + 30)):
            esc.on_tick(now, qsch, space)
            assert (jobs[0].priority, jobs[1].priority) == (want0, want1)
            seen.append((jobs[0].priority, jobs[1].priority))
        assert esc.escalations == 3
        return seen, esc.escalations
    held(scenario)


def test_escalator_threshold_is_tunable():
    def scenario(M):
        esc = M.StarvationEscalator(wait_threshold_s=3600.0)
        space = M.ParamSpace()
        esc.bind(space, M.TuningManager())
        space.set("escalator.wait_threshold_s", 1200.0, force=True)
        assert esc.wait_threshold_s == 1200.0
        return esc.wait_threshold_s, changes(space)
    held(scenario)


# ----------------------------------------------------------------------
# Profile serialization + transfer
# ----------------------------------------------------------------------
def test_profile_json_round_trip(tmp_path):
    def scenario(M):
        prof = M.TuningProfile(name="tuned-a", params={"x": 1.5, "y": -2.0},
                               objective=0.42, meta={"scope": "dc-a"})
        clone = M.TuningProfile.from_json(prof.to_json())
        assert clone == prof
        path = str(tmp_path / f"prof-{M.__name__}.json")
        prof.save(path)
        assert M.TuningProfile.load(path) == prof
        assert json.loads(prof.to_json())["params"]["y"] == -2.0
        return prof.to_json()
    held(scenario)


def test_manager_export_and_warm_start_round_trip():
    def scenario(M):
        sim = make_sim(M, small(M))
        mgr = M.TuningManager([M.HillClimbController(seed=3)])
        mgr.attach(sim)
        res = sim.run(trace(M, 30, seed=2))
        prof = mgr.export_profile("donor")
        assert prof.params.keys() == set(mgr.space.names())

        sim2 = make_sim(M, small(M))
        mgr2 = M.TuningManager([M.HillClimbController(seed=4)])
        mgr2.attach(sim2)
        skipped = mgr2.warm_start(prof)
        assert skipped == []
        assert mgr2.space.snapshot() == prof.params
        return (run_outcome(res), prof.to_json(), changes(mgr.space),
                changes(mgr2.space))
    held(scenario)


# ----------------------------------------------------------------------
# Registry diagnostics + ControllerPlugin slot
# ----------------------------------------------------------------------
def test_create_plugin_unknown_name_suggests_and_lists():
    def scenario(M):
        msgs = []
        with pytest.raises(KeyError) as exc:
            M.framework.create_plugin("BinPackScore")
        msgs.append(str(exc.value))
        assert "BinpackScore" in msgs[-1]
        assert "registered:" in msgs[-1]
        with pytest.raises(KeyError) as exc:
            M.framework.create_plugin("HillClimbControler")
        assert "HillClimbController" in str(exc.value)
        # The lists name what each package registered; the suggestions
        # must agree.
        return [m.split("registered:")[0] for m in msgs]
    held(scenario)


def test_controllers_are_registered_plugins():
    def scenario(M):
        names = []
        for name in ("NoOpController", "HillClimbController",
                     "StarvationEscalator"):
            assert name in M.framework.available_plugins()
            plugin = M.framework.create_plugin(name)
            assert plugin.name == name
            assert type(plugin).__module__.startswith(
                M.__name__.split(".")[0] + ".core.tuning")
            names.append(plugin.name)
        return names
    held(scenario)


# ----------------------------------------------------------------------
# Semantic soft-affinity contrib plugin
# ----------------------------------------------------------------------
def running_job(M, uid, node, tenant="t0", metadata=None):
    j = M.Job(uid=uid, tenant=tenant, gpu_type=0, n_pods=1, gpus_per_pod=8,
              kind=M.JobKind.TRAIN, metadata=metadata)
    j.placement = M.Placement(pods=[M.PodPlacement(node=node,
                                                   gpu_indices=(0, 1))])
    return j


def test_token_similarity():
    def scenario(M):
        sim = M.framework.token_similarity
        a = frozenset({"llama70b", "sft", "ads"})
        b = frozenset({"llama70b", "dpo", "ads"})
        got = (sim(a, b), sim(a, frozenset()))
        assert got[0] == pytest.approx(2 / 4)
        assert got[1] == 0.0
        return got
    held(scenario)


def test_semantic_affinity_pulls_toward_similar_groups():
    def scenario(M):
        plugin = M.framework.SemanticSoftAffinity(small(M), weight=2.0)
        running = {
            1: running_job(M, 1, 0, metadata="llama70b sft ads"),
            2: running_job(M, 2, 12, metadata="resnet vision batch"),
        }
        ctx = types.SimpleNamespace(running=running)
        job = M.Job(uid=9, tenant="t1", gpu_type=0, n_pods=1,
                    gpus_per_pod=8, metadata="llama70b dpo ads")
        per_group = plugin.group_score(job, None, np.ones(16, bool), ctx)
        assert per_group[0] == pytest.approx(2.0 * 0.5)
        assert per_group[3] == 0.0
        node_scores = plugin.score(job, None, np.ones(16, bool), ctx)
        assert node_scores[0] > node_scores[12]
        return per_group, node_scores
    held(scenario)


def test_semantic_affinity_tenant_fallback_and_anti():
    def scenario(M):
        plugin = M.framework.SemanticSoftAffinity(
            small(M), weight=1.0, anti_weight=0.5, anti_threshold=0.1)
        running = {1: running_job(M, 1, 0, tenant="ads"),
                   2: running_job(M, 2, 12, tenant="search")}
        ctx = types.SimpleNamespace(running=running)
        job = M.Job(uid=9, tenant="ads", gpu_type=0, n_pods=1,
                    gpus_per_pod=8)
        per_group = plugin.group_score(job, None, np.ones(16, bool), ctx)
        assert per_group[0] == pytest.approx(1.0)
        assert per_group[3] == pytest.approx(-0.5)
        empty = plugin.group_score(job, None, np.ones(16, bool),
                                   types.SimpleNamespace(running={}))
        assert empty is None
        return per_group
    held(scenario)


# ----------------------------------------------------------------------
# End-to-end: manager windows the run and the climb stays bounded
# ----------------------------------------------------------------------
def test_manager_windows_and_bounded_climb():
    def scenario(M):
        sim = make_sim(M, small(M))
        mgr = M.TuningManager([M.HillClimbController(seed=1),
                               M.StarvationEscalator(wait_threshold_s=600.0)])
        mgr.attach(sim)
        res = sim.run(trace(M, 60, seed=3))
        assert mgr.periods == len(mgr.history) > 0
        for ch in mgr.space.changes:
            p = mgr.space.param(ch.param)
            assert p.lo <= ch.value <= p.hi
        started = {(j.uid, j.start_time) for j in sim.qsch.running.values()}
        assert mgr._seen_starts >= started
        assert len(mgr._seen_starts) > 0
        return (run_outcome(res), mgr.history, changes(mgr.space),
                sorted(mgr._seen_starts), mgr.period_snapshots)
    held(scenario)


def test_frontier_objective_nan_safe():
    def scenario(M):
        w = M.TuningWindow(t0=0.0, t1=10.0)
        got = M.tuning.frontier_objective(w)
        assert got == 0.0
        return got
    held(scenario)


# ----------------------------------------------------------------------
# Port side: a climb over every handle, across backends and gang paths
# ----------------------------------------------------------------------
WEIGHT_FIELDS = (".used", ".fit", ".group", ".topo")


def weight_changes(space):
    return [c for c in space.changes if c.param.endswith(WEIGHT_FIELDS)]


def all_handle_run(backend, batched, seed=3):
    """A climb over every handle (``params=None``), so score-weight
    handles move mid-run, on a contended smoke trace."""
    sim = make_sim(T, small(T), score_backend=backend, batched_gang=batched)
    mgr = T.TuningManager([T.HillClimbController(seed=seed, epsilon=0.5),
                           T.StarvationEscalator(wait_threshold_s=600.0)],
                          control_period_s=900.0)
    mgr.attach(sim)
    calls = []
    orig = T_rsch.compute_node_scores_and_slots

    def seam(*args, **kw):
        calls.append(args[7])
        return orig(*args, **kw)

    T_rsch.compute_node_scores_and_slots = seam
    try:
        res = sim.run(trace(T, 90, seed=4))
    finally:
        T_rsch.compute_node_scores_and_slots = orig
    return res, mgr, calls


@pytest.mark.parametrize("batched", [True, False])
def test_all_handle_climb_equal_across_backends(batched):
    """Weight handles move mid-run; the plain torch path (the kernels'
    CPU version) on either gang path decides what numpy decides, and
    its param-change log is the same."""
    res, mgr, calls = all_handle_run("kernel", batched)
    res_np, mgr_np, _ = all_handle_run("np", True)
    moved = weight_changes(mgr.space)
    assert any(c.param.startswith("train-") for c in moved), \
        "the climb never moved a training score weight"
    assert run_outcome(res) == run_outcome(res_np)
    assert changes(mgr.space) == changes(mgr_np.space)
    assert mgr.history == mgr_np.history
    if batched:
        # Weights after the first weight change reach the seam.
        assert len(set(calls)) > 1


def test_weight_write_reaches_next_score_pass():
    """A write to a score-weight handle changes the weights the next
    ``compute_node_scores_and_slots`` call carries, and the scores."""
    topo = small(T)
    state = T.ClusterState.create(topo)
    state.gpu_busy[::3, :5] = True
    rsch = T.RSCH(topo, T.RSCHConfig(device="cpu"))
    space = T.ParamSpace()
    names = T.tuning.bind_profile_weights(space, rsch.profiles)
    name = "train-e-binpack.BinpackScore.used"
    assert name in names
    job = T.Job(uid=1, tenant="t0", gpu_type=0, n_pods=2, gpus_per_pod=2,
                kind=T.JobKind.TRAIN)
    seen = []
    orig = T_rsch.compute_node_scores_and_slots

    def seam(*args, **kw):
        out = orig(*args, **kw)
        seen.append((args[7], out[0].copy()))
        return out

    T_rsch.compute_node_scores_and_slots = seam
    try:
        snap = T.FullSnapshotter().take(state)
        rsch.schedule(job, snap)
        before = space.get(name)
        space.set(name, before * 3.0, force=True)
        rsch.schedule(job, T.FullSnapshotter().take(state))
    finally:
        T_rsch.compute_node_scores_and_slots = orig
    (w0, s0), (w1, s1) = seen[0], seen[-1]
    assert w1.used == pytest.approx(w0.used + 2.0 * before)
    assert (w1.fit, w1.group, w1.topo) == (w0.fit, w0.group, w0.topo)
    assert not np.array_equal(s0, s1)
