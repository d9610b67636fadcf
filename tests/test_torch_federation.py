"""The port's federation against the JAX package's, on the CPU.

Each test is a port of one test of ``tests/test_federation.py``: the
same scenario runs through ``repro.core`` and ``repro_torch.core`` (its
members built with ``make_member(..., device="cpu")``, so the score pass
runs the kernels' plain versions).  The scenario makes the reference
test's checks on both packages and returns what it observed — routing
decisions, summary matrices, placements, routing stats, federated and
per-member reports — which must be equal.

The port-side tests at the end hold the members' score backends and
gang paths against each other, and two members of different widths
against each other on one device's staging.
"""

import dataclasses
import functools

import numpy as np
import pytest

import repro_torch.core as T
import repro_torch.core.scoring as T_scoring

from test_torch_dynamics import held, rsch_config


def member(M, name, **kw):
    """``make_member`` on either package; the port's on the host."""
    if M is T:
        kw.setdefault("device", "cpu")
    return M.make_member(name, **kw)


def _job(M, uid=0, gpus=4, gpu_type=0, tenant="t0", region=None, pods=None,
         submit=0.0, duration=600.0, priority=50):
    n_pods = pods if pods is not None else 1
    per_pod = gpus // n_pods
    return M.Job(uid=uid, tenant=tenant, gpu_type=gpu_type, n_pods=n_pods,
                 gpus_per_pod=per_pod, submit_time=submit,
                 duration=duration, region=region, priority=priority)


def _two_members(M, **kw):
    return M.FederatedCluster([
        member(M, "a", gpu_pools=((0, 4),), region="r0", **kw),
        member(M, "b", gpu_pools=((0, 4), (1, 4)), region="r1", **kw),
    ])


def summary_of(s):
    return {"gpu_types": list(s.gpu_types), "free": s.free,
            "capacity": s.capacity, "max_node_cap": s.max_node_cap,
            "queue_depth": s.queue_depth,
            "pending_gang_gpus": s.pending_gang_gpus, "frag": s.frag}


def placement_fp(jobs):
    return [(j.uid, j.start_time, j.end_time,
             tuple((p.node, tuple(p.gpu_indices))
                   for p in (j.placement.pods if j.placement else ())))
            for j in jobs]


def samples(metrics):
    return [dataclasses.astuple(s) for s in metrics.samples]


def fed_outcome(res):
    """Everything a federated run reports: placements, routing stats,
    the federated report and each member's report and samples."""
    return {"jobs": placement_fp(res.jobs),
            "states": [j.state.name for j in res.jobs],
            "routing": dataclasses.astuple(res.routing),
            "report": res.report(),
            "counts": (res.end_time, res.cycles, res.preemptions,
                       res.spills, [j.uid for j in res.unrouted]),
            "members": [{"jobs": placement_fp(m.jobs),
                         "report": m.metrics.report(),
                         "samples": samples(m.metrics),
                         "failures": m.failures, "cycles": m.cycles}
                        for m in res.members]}


# ----------------------------------------------------------------------
# Summary matrix
# ----------------------------------------------------------------------
class TestSummary:
    def test_matrix_shapes_and_pools(self):
        def scenario(M):
            fed = _two_members(M)
            s = M.federation.summarize(fed.members, 0.0)
            assert s.gpu_types == [0, 1]
            assert s.free.shape == (2, 2)
            assert s.capacity[0, 1] == 0
            assert s.capacity[0, 0] == 4 * 8
            assert s.capacity[1, 0] == 4 * 8 and s.capacity[1, 1] == 4 * 8
            assert s.max_node_cap[0, 0] == 8
            return summary_of(s)
        held(scenario)

    def test_structural_vs_immediate_fit(self):
        def scenario(M):
            fed = _two_members(M)
            s = M.federation.summarize(fed.members, 0.0)
            seen = []
            j = _job(M, gpus=16, pods=2)
            seen.append(s.structural_fit(j).tolist())
            assert seen[-1] == [True, True]
            seen.append(s.structural_fit(_job(M, gpus=8,
                                              gpu_type=1)).tolist())
            assert seen[-1] == [False, True]
            big = _job(M, gpus=32, pods=4)
            assert s.immediate_fit(big).tolist() == [True, True]
            s.commit(0, _job(M, uid=1, gpus=8))
            seen.append(s.immediate_fit(big).tolist())
            assert seen[-1] == [False, True]
            seen.append(s.structural_fit(big).tolist())
            assert seen[-1] == [True, True]
            return seen, summary_of(s)
        held(scenario)

    def test_queue_depth_and_pending_gangs(self):
        def scenario(M):
            fed = _two_members(M)
            fed[0].qsch.submit(_job(M, uid=1, gpus=8))
            fed[0].qsch.submit(_job(M, uid=2, gpus=16, pods=2))
            s = M.federation.summarize(fed.members, 0.0)
            assert s.queue_depth.tolist() == [2, 0]
            assert s.pending_gang_gpus.tolist() == [24, 0]
            return summary_of(s)
        held(scenario)

    def test_unknown_gpu_type_never_fits(self):
        def scenario(M):
            fed = _two_members(M)
            s = M.federation.summarize(fed.members, 0.0)
            fits = s.structural_fit(_job(M, gpu_type=7))
            assert not fits.any()
            return fits
        held(scenario)


# ----------------------------------------------------------------------
# ClusterSelect plugins + GSCH selection
# ----------------------------------------------------------------------
class TestRouting:
    def test_least_loaded_prefers_emptier_member(self):
        def scenario(M):
            fed = _two_members(M)
            st = fed[0].state
            st.allocate(_job(M, uid=9, gpus=8), M.Placement(pods=[
                M.PodPlacement(node=0, gpu_indices=tuple(range(8)))]))
            F = M.federation
            gsch = F.GSCH(fed, M.GSCHConfig(select=(F.LeastLoadedSelect(),),
                                            immediate_fit_bonus=0.0))
            target = gsch.route(_job(M, uid=1, gpus=4), 0.0)
            assert target == 1
            return target, dataclasses.astuple(gsch.stats)
        held(scenario)

    def test_locality_prefers_home_region(self):
        def scenario(M):
            fed = _two_members(M)
            F = M.federation
            gsch = F.GSCH(fed, M.GSCHConfig(
                select=(F.LocalityAffinitySelect(weight=5.0),),
                immediate_fit_bonus=0.0))
            got = [gsch.route(_job(M, uid=1, region="r1"), 0.0),
                   gsch.route(_job(M, uid=2, region="r0"), 0.0),
                   gsch.route(_job(M, uid=3), 0.0)]
            assert got == [1, 0, 0]
            return got, dataclasses.astuple(gsch.stats)
        held(scenario)

    def test_capability_cost_routes_to_cheapest(self):
        def scenario(M):
            F = M.federation
            fed = M.FederatedCluster([
                member(M, "pricey", gpu_pools=((0, 4),),
                       cost_per_gpu_hour={0: 4.0}, capability={0: 1.0}),
                member(M, "cheap", gpu_pools=((0, 4),),
                       cost_per_gpu_hour={0: 1.0}, capability={0: 1.0}),
            ])
            gsch = F.GSCH(fed, M.GSCHConfig(
                select=(F.CapabilityCostSelect(),), immediate_fit_bonus=0.0))
            first = gsch.route(_job(M, uid=1), 0.0)
            assert first == 1
            fed[1].capability[0] = 0.2
            gsch2 = F.GSCH(fed, M.GSCHConfig(
                select=(F.CapabilityCostSelect(min_capability=0.5),),
                immediate_fit_bonus=0.0))
            second = gsch2.route(_job(M, uid=2), 0.0)
            assert second == 0
            return first, second
        held(scenario)

    def test_quota_fit_vetoes_non_admitting_member(self):
        def scenario(M):
            F = M.federation
            fed = M.FederatedCluster([
                member(M, "a", gpu_pools=((0, 4),), tenants=("alice",)),
                member(M, "b", gpu_pools=((0, 4),), tenants=("bob",)),
            ])
            gsch = F.GSCH(fed, M.GSCHConfig(select=(F.QuotaFitSelect(),),
                                            immediate_fit_bonus=0.0))
            got = [gsch.route(_job(M, uid=1, tenant="bob"), 0.0),
                   gsch.route(_job(M, uid=2, tenant="alice"), 0.0)]
            assert got == [1, 0]
            return got
        held(scenario)

    def test_gfr_aware_sign_by_job_shape(self):
        def scenario(M):
            fed = _two_members(M)
            s = M.federation.summarize(fed.members, 0.0)
            s.frag = np.asarray([0.5, 0.1])
            plug = M.federation.GfrAwareSelect(weight=1.0)
            small = plug.score(_job(M, gpus=2), s)
            gang = plug.score(_job(M, gpus=32, pods=4), s)
            assert small[0] > small[1]
            assert gang[0] < gang[1]
            return small, gang
        held(scenario)

    def test_structural_misfit_parks_at_biggest_pool(self):
        def scenario(M):
            fed = _two_members(M)
            gsch = M.federation.GSCH(fed, M.GSCHConfig())
            target = gsch.route(_job(M, uid=1, gpus=96, pods=12, gpu_type=1),
                                0.0)
            assert target == 1
            return target
        held(scenario)

    def test_routing_is_o_members_per_job(self):
        def scenario(M):
            fed = _two_members(M)
            gsch = M.federation.GSCH(fed, M.GSCHConfig(
                summary_max_age_s=15.0))
            routes = [gsch.route(_job(M, uid=i, gpus=1), float(i) * 0.1)
                      for i in range(50)]
            assert gsch.stats.summary_refreshes == 1
            return routes, dataclasses.astuple(gsch.stats)
        held(scenario)


# ----------------------------------------------------------------------
# Federated simulation: lockstep, spillover, quotas, dynamics
# ----------------------------------------------------------------------
class TestFederatedSimulator:
    def test_routes_and_completes_across_members(self):
        def scenario(M):
            fed = _two_members(M)
            jobs = [_job(M, uid=i, gpus=8, submit=float(i))
                    for i in range(8)]
            res = M.FederatedSimulator(fed).run(jobs)
            assert all(j.state is M.JobState.COMPLETED for j in res.jobs)
            assert sum(res.routing.routed) == 8
            assert all(n > 0 for n in res.routing.routed)
            assert res.report()["balance_index"] > 0.8
            return fed_outcome(res)
        held(scenario)

    def test_spillover_rescues_starving_job(self):
        def scenario(M):
            fed = _two_members(M)
            cfg = M.GSCHConfig(
                select=(M.federation.LocalityAffinitySelect(weight=100.0),),
                immediate_fit_bonus=0.0, spill_deadline_s=120.0,
                forward_delay_s=30.0, locality_penalty_s=60.0)
            blocker = _job(M, uid=1, gpus=32, pods=4, region="r0",
                           duration=20_000.0)
            starver = _job(M, uid=2, gpus=8, region="r0", submit=10.0,
                           duration=600.0)
            res = M.FederatedSimulator(fed, cfg).run([blocker, starver])
            assert res.spills == 1
            assert res.routing.cross_region_forwards == 1
            assert starver.state is M.JobState.COMPLETED
            assert res.members[1].jobs == [starver]
            assert starver.start_time >= 120.0 + 30.0 + 60.0
            assert starver.end_time < blocker.end_time
            return fed_outcome(res)
        held(scenario)

    def test_no_spillover_when_disabled(self):
        def scenario(M):
            fed = _two_members(M)
            cfg = M.GSCHConfig(
                select=(M.federation.LocalityAffinitySelect(weight=100.0),),
                immediate_fit_bonus=0.0, spillover=False)
            blocker = _job(M, uid=1, gpus=32, pods=4, region="r0",
                           duration=20_000.0)
            starver = _job(M, uid=2, gpus=8, region="r0", submit=10.0,
                           duration=600.0)
            res = M.FederatedSimulator(fed, cfg, horizon=30_000.0).run(
                [blocker, starver])
            assert res.spills == 0
            assert starver.start_time > blocker.end_time - 1.0
            return fed_outcome(res)
        held(scenario)

    def test_federation_quota_backlog_layered_over_members(self):
        def scenario(M):
            fed = _two_members(M)
            fq = M.QuotaManager({"t0": {0: 8}})
            cfg = M.GSCHConfig(federation_quota=fq)
            first = _job(M, uid=1, gpus=8, duration=600.0)
            second = _job(M, uid=2, gpus=8, submit=1.0, duration=600.0)
            res = M.FederatedSimulator(fed, cfg).run([first, second])
            assert res.routing.backlogged == 1
            assert all(j.state is M.JobState.COMPLETED for j in res.jobs)
            assert second.start_time >= first.end_time
            assert fq.total_used(0) == 0
            return fed_outcome(res)
        held(scenario)

    def test_lockstep_samples_align_while_loaded(self):
        def scenario(M):
            fed = _two_members(M)
            jobs = [_job(M, uid=i, gpus=4, submit=1.0 + i, duration=2000.0)
                    for i in range(6)]
            res = M.FederatedSimulator(fed).run(jobs)
            t0 = [s.t for s in res.members[0].metrics.samples]
            t1 = [s.t for s in res.members[1].metrics.samples]
            assert t0[0] == t1[0] == 1.0
            shared = min(len(t0), len(t1)) - 1
            assert t0[:shared] == t1[:shared]
            return fed_outcome(res)
        held(scenario)

    def test_member_dynamics_compose(self):
        def scenario(M):
            members = [
                member(M, "a", gpu_pools=((0, 4),)),
                member(M, "b", gpu_pools=((0, 4),),
                       sim_config=M.SimConfig(dynamics=M.DynamicsConfig(
                           plugins=[M.NodeFailureInjector(
                               mtbf_s=1800.0, repair_s=600.0)],
                           seed=1))),
            ]
            fed = M.FederatedCluster(members)
            jobs = [_job(M, uid=i, gpus=8, submit=float(i), duration=4000.0)
                    for i in range(8)]
            res = M.FederatedSimulator(fed, horizon=6 * 3600.0).run(jobs)
            assert res.members[1].failures > 0
            assert res.members[0].failures == 0
            out = fed_outcome(res)
            out["dynamics"] = [None if m.dynamics is None
                               else m.dynamics.as_dict()
                               for m in res.members]
            return out
        held(scenario)

    def test_jain_index(self):
        def scenario(M):
            jain = M.federation.jain_index
            got = [jain([1.0, 1.0, 1.0]), jain([1.0, 0.0, 0.0]), jain([])]
            assert got[0] == pytest.approx(1.0)
            assert got[1] == pytest.approx(1 / 3)
            assert got[2] == 1.0
            return got
        held(scenario)

    def test_waiting_percentile(self):
        def scenario(M):
            jobs = [_job(M, uid=i) for i in range(10)]
            for i, j in enumerate(jobs):
                j.start_time = float(i)
            p90 = M.federation.waiting_percentile(jobs, 90.0)
            assert p90 == pytest.approx(8.1)
            return p90
        held(scenario)


# ----------------------------------------------------------------------
# Single-member degenerate case == plain Simulator
# ----------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["BACKFILL", "STRICT_FIFO"])
def test_single_member_parity(policy):
    def scenario(M):
        pol = M.QueuePolicy[policy]
        jobs = M.training_trace(60, seed=11, arrival_rate_per_hour=600,
                                mean_duration_s=1500.0)
        jobs = [j for j in jobs if j.n_gpus <= 64]

        def clone():
            return [M.Job(uid=j.uid, tenant=j.tenant, gpu_type=j.gpu_type,
                          n_pods=j.n_pods, gpus_per_pod=j.gpus_per_pod,
                          submit_time=j.submit_time, duration=j.duration)
                    for j in jobs]

        solo = member(M, "solo", gpu_pools=((0, 16),), nodes_per_leaf=4,
                      policy=pol)
        topo = solo.topology
        state = M.ClusterState.create(topo)
        qsch = M.QSCH(M.QuotaManager({"t0": {0: 10 ** 6}}),
                      M.RSCH(topo, rsch_config(M)), M.QSCHConfig(policy=pol))
        base = M.Simulator(state, qsch, M.SimConfig()).run(clone())
        fedres = M.FederatedSimulator(M.FederatedCluster([solo])).run(
            clone())
        assert placement_fp(base.jobs) == placement_fp(fedres.jobs)
        assert base.metrics.report() == fedres.members[0].metrics.report()
        return fed_outcome(fedres)
    held(scenario)


# ----------------------------------------------------------------------
# Workload satellite: heterogeneous + multi-region traces
# ----------------------------------------------------------------------
def trace_key(jobs):
    return [(j.uid, j.tenant, j.gpu_type, j.n_pods, j.gpus_per_pod,
             j.submit_time, j.duration, j.region) for j in jobs]


class TestHeterogeneousTrace:
    def test_gpu_types_mix(self):
        def scenario(M):
            jobs = M.training_trace(300, seed=2, gpu_types=(0, 1, 3),
                                    type_probs=(0.5, 0.3, 0.2))
            assert {j.gpu_type for j in jobs} == {0, 1, 3}
            frac0 = sum(j.gpu_type == 0 for j in jobs) / len(jobs)
            assert 0.35 < frac0 < 0.65
            return trace_key(jobs)
        held(scenario)

    def test_default_stream_unchanged_by_new_knobs(self):
        def scenario(M):
            base = M.training_trace(50, seed=7)
            hetero = M.training_trace(50, seed=7, gpu_types=(0, 1))
            for a, b in zip(base, hetero):
                assert (a.n_pods, a.gpus_per_pod, a.submit_time, a.duration,
                        a.tenant) == (b.n_pods, b.gpus_per_pod,
                                      b.submit_time, b.duration, b.tenant)
            assert all(j.gpu_type == 0 for j in base)
            return trace_key(base), trace_key(hetero)
        held(scenario)

    def test_tenant_regions_stamped(self):
        def scenario(M):
            jobs = M.training_trace(40, seed=3, tenants=("x", "y"),
                                    tenant_regions={"x": "r0", "y": "r1"})
            assert all(j.region == {"x": "r0", "y": "r1"}[j.tenant]
                       for j in jobs)
            assert all(j.region is None
                       for j in M.training_trace(5, seed=3))
            return trace_key(jobs)
        held(scenario)


# ----------------------------------------------------------------------
# Port side: score backends, gang paths, shared staging
# ----------------------------------------------------------------------
REGIONS = {"tA": "r0", "tB": "r1", "tC": "r2"}


def _busy_fed(backend, batched):
    """Three members of different widths, node counts and GPU types
    under a load that queues gangs and spills."""
    kw = dict(tenants=tuple(REGIONS), device="cpu", score_backend=backend)
    fed = T.FederatedCluster([
        T.make_member("east", region="r0", gpu_pools=((0, 12),), **kw),
        T.make_member("west", region="r1", gpu_pools=((0, 4), (1, 6)), **kw),
        T.make_member("west4", region="r2", gpu_pools=((1, 10),),
                      gpus_per_node=4, **kw),
    ])
    for m in fed.members:
        m.qsch.rsch.config.batched_gang = batched
    return fed


@functools.lru_cache(maxsize=None)
def _busy_run(backend, batched):
    fed = _busy_fed(backend, batched)
    jobs = [j for j in T.training_trace(
        120, seed=5, arrival_rate_per_hour=600, mean_duration_s=3000.0,
        tenants=tuple(REGIONS), tenant_regions=REGIONS,
        gpu_types=(0, 1), type_probs=(0.6, 0.4)) if j.n_gpus <= 32]
    cfg = T.GSCHConfig(
        select=(T.federation.QuotaFitSelect(),
                T.federation.LocalityAffinitySelect(weight=100.0)),
        immediate_fit_bonus=0.0, spill_deadline_s=600.0,
        forward_delay_s=60.0, locality_penalty_s=120.0)
    res = T.FederatedSimulator(fed, cfg, horizon=8 * 3600.0).run(jobs)
    for m in fed.members:
        m.state.check_invariants()
    return fed_outcome(res)


@pytest.mark.parametrize("backend,batched", [("kernel", True),
                                             ("kernel", False),
                                             ("np", False)])
def test_federation_equal_across_backends_and_gang_paths(backend, batched):
    """Routing, spills, placements and member reports do not depend on
    where the members score: the plain torch path (the kernels' CPU
    version) on either gang path decides what numpy decides."""
    want = _busy_run("np", True)
    assert want["routing"][1] > 0, "the scenario must spill"
    assert _busy_run(backend, batched) == want


def test_make_member_passes_device_and_backend():
    m = T.make_member("m", gpu_pools=((0, 4),), device="cpu",
                      score_backend="np")
    assert m.qsch.rsch.config.device == "cpu"
    assert m.qsch.rsch.config.score_backend == "np"
    assert str(m.qsch.rsch.device) == "cpu"
    assert T.make_member("k", gpu_pools=((0, 4),),
                         device="cpu").qsch.rsch.config.score_backend \
        == "kernel"


def test_members_of_different_widths_get_owned_scores_on_one_staging():
    """Two members of different widths interleave on one device's
    staging: each pass returns arrays the next pass (which regrows or
    reuses the buffers) leaves untouched."""
    rng = np.random.default_rng(0)

    def table(n, g):
        free = rng.integers(0, g + 1, size=n).astype(np.int32)
        used = (g - free).astype(np.int32)
        return (free, used, rng.random(n) < 0.9,
                rng.random(n).astype(np.float32),
                rng.random(n).astype(np.float32))

    wide, narrow = table(3000, 8), table(700, 4)
    staging = T_scoring._staging_for("cpu")
    outs = []
    for cols, req, g in ((wide, 2, 8), (narrow, 1, 4), (wide, 4, 8),
                         (narrow, 2, 4)):
        s, sl = T.compute_node_scores_and_slots(
            *cols, req, g, T.E_BINPACK, backend="kernel", device="cpu")
        outs.append(((s, sl), (s.copy(), sl.copy()), cols, req, g))
    assert T_scoring._staging_for("cpu") \
        is staging
    for (s, sl), (s0, sl0), cols, req, g in outs:
        assert np.array_equal(s.view(np.int32), s0.view(np.int32))
        assert np.array_equal(sl, sl0)
        want = T.node_scores_np(*cols, req, g, T.E_BINPACK)
        assert np.array_equal(s.view(np.int32), want.view(np.int32))
        assert np.array_equal(sl, np.where(cols[2] & (cols[0] >= req),
                                           cols[0] // req, 0))
    assert not np.shares_memory(outs[0][0][0], outs[2][0][0])
