"""The port's serving fabric against the JAX package's, on the CPU.

Ports of the router, pool, request and demand-export tests of
``tests/test_serving.py``: each scenario runs through ``repro`` and
``repro_torch`` (``device="cpu"``) and what it observes — routing
decisions, request outcomes, serving metrics to the last bit, the
autoscaler's demand log and the simulator's placements — must be equal.
Then ``Replica.build_engine`` on smoke configs: the port's engine, on
weights carried across by ``models/bridge.py``, emits the reference
engine's greedy tokens.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest

import repro.core as RC
import repro.serve as RS
import repro_torch.core as TC
import repro_torch.serve as TS
from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro_torch import configs
from repro_torch.models.bridge import params_from_reference

REF, PORT = (RC, RS), (TC, TS)


def canon(x):
    """A comparable copy of ``x``: dataclasses as tuples, NaN as a
    string, numpy scalars as Python numbers, sequences as tuples."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + canon(dataclasses.astuple(x))
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
    return x


def held(scenario, *args):
    """Run ``scenario`` on the reference's (core, serve), then on the
    port's; the port's observations must equal the reference's."""
    want = canon(scenario(*REF, *args))
    got = canon(scenario(*PORT, *args))
    assert got == want
    return got


def req(C, qclass, uid=0, t=0.0, prompt=100, out=50):
    return C.ServeRequest(uid=uid, qclass=qclass, arrival_s=t,
                          prompt_tokens=prompt, output_tokens=out)


def replica(S, cap=0.5, cost=1.0, prefill=5000.0, decode=50.0, slots=2,
            name="r"):
    return S.Replica(S.ReplicaSpec(name, capability=cap,
                                   cost_per_1k_tokens=cost,
                                   prefill_tokens_per_s=prefill,
                                   decode_tokens_per_s=decode, slots=slots))


def metrics_of(m):
    return (m.report(), m.by_class(), m.replica_share(), m.outcomes)


# ----------------------------------------------------------------------
# Router policies
# ----------------------------------------------------------------------
def test_round_robin_cycles():
    def scenario(C, S):
        reps = [replica(S, name=f"r{i}") for i in range(3)]
        pol = S.RoundRobinRouter()
        r = req(C, C.DEFAULT_QUERY_CLASSES[0])
        picks = [pol.select(r, reps, 0.0) for _ in range(6)]
        assert picks == [0, 1, 2, 0, 1, 2]
        return picks
    held(scenario)


def test_least_loaded_prefers_empty_replica():
    def scenario(C, S):
        reps = [replica(S, name="busy"), replica(S, name="idle")]
        first = reps[0].admit(req(C, C.DEFAULT_QUERY_CLASSES[0], out=500),
                              0.0, 0)
        pick = S.LeastLoadedRouter().select(
            req(C, C.DEFAULT_QUERY_CLASSES[0], uid=1), reps, 0.0)
        assert pick == 1
        return first, pick
    held(scenario)


def test_capcost_rejects_slo_infeasible_request():
    """No replica decodes fast enough for the SLO: reject (None) rather
    than knowingly miss; with reject_infeasible=False the request
    degrades to the fastest capable replica."""
    def scenario(C, S):
        tight = C.QueryClass("tight", quality_floor=0.0, latency_slo_s=1.0)
        slow = replica(S, decode=10.0, name="slow")     # 500 tok -> 50 s
        slower = replica(S, decode=5.0, name="slower")
        r = req(C, tight, out=500)
        strict = S.CapabilityCostRouter().select(r, [slow, slower], 0.0)
        loose = S.CapabilityCostRouter(reject_infeasible=False).select(
            r, [slower, slow], 0.0)
        assert strict is None and loose == 1           # fastest capable
        return strict, loose
    held(scenario)


def test_capcost_rejects_when_no_replica_meets_quality_floor():
    def scenario(C, S):
        hard = C.QueryClass("hard", quality_floor=0.9, latency_slo_s=100.0)
        reps = [replica(S, cap=0.4), replica(S, cap=0.6)]
        picks = (S.CapabilityCostRouter().select(req(C, hard), reps, 0.0),
                 # reject_infeasible relaxes the SLO stage, never quality.
                 S.CapabilityCostRouter(reject_infeasible=False).select(
                     req(C, hard), reps, 0.0))
        assert picks == (None, None)
        return picks
    held(scenario)


def test_capcost_picks_cheapest_feasible_and_breaks_ties_on_latency():
    def scenario(C, S):
        easy = C.QueryClass("easy", quality_floor=0.5, latency_slo_s=100.0)
        reps = [replica(S, cap=0.9, cost=8.0, name="pricey"),
                replica(S, cap=0.6, cost=1.0, decode=25.0,
                        name="cheap-slow"),
                replica(S, cap=0.6, cost=1.0, decode=50.0,
                        name="cheap-fast"),
                replica(S, cap=0.3, cost=0.1, name="too-weak")]
        pick = S.CapabilityCostRouter().select(req(C, easy), reps, 0.0)
        assert pick == 2
        return pick
    held(scenario)


def test_capcost_online_learning_routes_around_misdeclared_replica():
    def scenario(C, S):
        cls = C.QueryClass("c", quality_floor=0.5, latency_slo_s=100.0)
        pol = S.CapabilityCostRouter(learn=True, learn_rate=1.0)
        reps = [replica(S, cap=0.9, cost=0.5, name="liar"),
                replica(S, cap=0.9, cost=2.0, name="honest")]
        before = pol.select(req(C, cls), reps, 0.0)      # cheapest prior
        pol.observe(S.RequestOutcome(uid=0, qclass="c", replica=0,
                                     rejected=False, quality_ok=False))
        after = pol.select(req(C, cls, uid=1), reps, 0.0)
        assert (before, after) == (0, 1)                 # routed around
        return before, after
    held(scenario)


def test_router_policies_in_plugin_registry():
    names = TC.framework.available_plugins()
    for n in ("RoundRobinRouter", "LeastLoadedRouter",
              "CapabilityCostRouter"):
        assert n in names
        factory = TC.framework.registry._REGISTRY[n]
        assert factory is getattr(TS, n)
    pol = TC.framework.create_plugin("CapabilityCostRouter", slo_margin=0.5)
    assert isinstance(pol, TS.CapabilityCostRouter)
    assert pol.slo_margin == 0.5


def test_custom_router_policy_registers_and_routes():
    """An out-of-tree policy plugs into the pool through the shared
    framework registry."""
    def scenario(C, S):
        F = C.framework
        router_name = "CheapestRouterPortTestOnly"
        if router_name not in F.available_plugins():
            @F.register
            class CheapestRouter(F.RouterPolicyPlugin):
                name = router_name

                def select(self, request, replicas, now):
                    return min(range(len(replicas)), key=lambda i:
                               replicas[i].spec.cost_per_1k_tokens)
        specs = [S.ReplicaSpec("a", capability=1.0, cost_per_1k_tokens=5.0),
                 S.ReplicaSpec("b", capability=1.0, cost_per_1k_tokens=1.0)]
        pool = S.ReplicaPool(specs, F.create_plugin(router_name))
        out = pool.route(req(C, C.DEFAULT_QUERY_CLASSES[0]))
        assert out.replica == 1
        return out
    held(scenario)


# ----------------------------------------------------------------------
# Request trace + pool metrics
# ----------------------------------------------------------------------
def test_request_trace_is_sorted_mixed_and_reproducible():
    def scenario(C, S):
        t1 = C.request_trace(300, seed=7, period_s=1800.0)
        t2 = C.request_trace(300, seed=7, period_s=1800.0)
        arr = [r.arrival_s for r in t1]
        assert arr == [r.arrival_s for r in t2]
        assert arr == sorted(arr) and arr[0] > 0.0
        assert {"chat", "code"} <= {r.qclass.name for r in t1}
        assert all(r.prompt_tokens >= 4 and r.output_tokens >= 1
                   for r in t1)
        return [(r.uid, r.qclass.name, r.arrival_s, r.prompt_tokens,
                 r.output_tokens) for r in t1]
    held(scenario)


def test_pool_books_rejection_as_slo_miss():
    def scenario(C, S):
        hard = C.QueryClass("hard", quality_floor=0.99, latency_slo_s=10.0)
        pool = S.ReplicaPool([S.ReplicaSpec("weak", capability=0.2,
                                            cost_per_1k_tokens=1.0)],
                             S.CapabilityCostRouter())
        out = pool.route(req(C, hard))
        assert out.rejected and not out.slo_ok and out.cost == 0.0
        assert pool.metrics.slo_attainment() == 0.0
        assert pool.metrics.rejected() == 1
        return out, metrics_of(pool.metrics)
    held(scenario)


def test_to_engine_request_is_deterministic_and_clipped():
    def scenario(C, S):
        r = C.ServeRequest(uid=5, qclass=C.DEFAULT_QUERY_CLASSES[0],
                           arrival_s=0.0, prompt_tokens=500,
                           output_tokens=999)
        a = S.to_engine_request(r, vocab=512, seed=3, max_prompt=32,
                                max_new=8)
        b = S.to_engine_request(r, vocab=512, seed=3, max_prompt=32,
                                max_new=8)
        assert np.array_equal(a.prompt, b.prompt)
        assert a.prompt.dtype == np.int32
        assert len(a.prompt) == 32 and a.max_new_tokens == 8
        assert a.qclass == "chat"
        return (a.uid, a.prompt.tolist(), a.max_new_tokens, a.qclass,
                a.deadline_steps)
    held(scenario)


FABRIC_ARCHS = ("rwkv6-3b", "hymba-1.5b")


def test_from_arch_specs_match_reference():
    for arch in configs.ARCH_IDS:
        for smoke in (False, True):
            assert canon(TS.ReplicaSpec.from_arch(arch, smoke=smoke)) \
                == canon(RS.ReplicaSpec.from_arch(arch, smoke=smoke))


def route_fabric(C, S, router, n=600):
    """The chip smoke's fabric pool, FULL-config specs, on a shorter
    trace: every outcome and metric of one router."""
    pool = S.ReplicaPool([S.ReplicaSpec.from_arch(a) for a in
                          FABRIC_ARCHS], getattr(S, router)())
    pool.route_trace(C.request_trace(n, seed=0))
    span = max(pool._arrivals) * pool.demand_bucket_s
    demand = [pool.replica_demand(t)
              for t in np.arange(0.0, span + 1.0, 60.0)]
    return metrics_of(pool.metrics), demand, pool.mean_service_s()


@pytest.mark.parametrize("router", ["RoundRobinRouter", "LeastLoadedRouter",
                                    "CapabilityCostRouter"])
def test_pool_metrics_equal_reference_for_each_router(router):
    (report, *_), demand, _ = held(route_fabric, router)
    assert report["requests"] == 600.0
    assert max(demand) > 0.0


class FakeRegistry:
    """The duck-typed surface ``bind_registry`` uses."""

    def __init__(self):
        self.collectors, self.values = [], {}

    def add_collector(self, fn):
        self.collectors.append(fn)

    def gauge(self, name, help_text):
        values = self.values

        class Gauge:
            def set(self, value, **labels):
                values[(name,) + tuple(sorted(labels.items()))] = value
        return Gauge()

    def collect(self):
        for fn in self.collectors:
            fn(self)
        return self.values


def test_bind_registry_publishes_like_the_reference():
    def scenario(C, S):
        pool = S.ReplicaPool([S.ReplicaSpec.from_arch(a)
                              for a in FABRIC_ARCHS], S.LeastLoadedRouter())
        pool.route_trace(C.request_trace(200, seed=1))
        reg = FakeRegistry()
        pool.bind_registry(reg, name="fabric")
        values = reg.collect()
        assert values[("serving_replicas", ("pool", "fabric"))] == 2
        return sorted(values.items())
    held(scenario)


# ----------------------------------------------------------------------
# Demand export round-trip: pool -> TidalService -> autoscaler -> sim
# ----------------------------------------------------------------------
def test_demand_export_roundtrip_through_autoscaler():
    def scenario(C, S):
        # Low rates so the trace spans most of the compressed diurnal
        # cycle, single-slot replicas so the demand signal swings across
        # several integer replica counts.
        trace = C.request_trace(3000, seed=0, period_s=1800.0, base_rps=0.3,
                                peak_rps=5.0, burst_rate_per_hour=1.0,
                                burst_multiplier=2.0)
        pool = S.ReplicaPool([S.ReplicaSpec("m", capability=0.9,
                                            cost_per_1k_tokens=1.0,
                                            prefill_tokens_per_s=6000.0,
                                            decode_tokens_per_s=60.0,
                                            slots=1)],
                             S.LeastLoadedRouter(), demand_bucket_s=300.0)
        pool.route_trace(trace)
        svc = S.demand_service(pool, min_replicas=1, max_replicas=8,
                               gpus_per_replica=4, tenant="svc")
        assert type(svc) is C.dynamics.tidal.TidalService
        span = trace[-1].arrival_s
        targets = [svc.target_replicas(t) for t in np.arange(0, span, 60.0)]
        assert max(targets) > min(targets), "targets must track the load"
        assert all(1 <= x <= 8 for x in targets)
        scaler = C.TidalAutoscaler([svc], interval_s=60.0)
        topo = C.small_topology(n_nodes=16, gpus_per_node=8,
                                nodes_per_leaf=4)
        state = C.ClusterState.create(topo)
        cfg = {} if C is RC else {"device": "cpu"}
        qsch = C.QSCH(C.QuotaManager({"svc": {0: 1024}},
                                     mode=C.QuotaMode.ISOLATED),
                      C.RSCH(topo, C.RSCHConfig(**cfg)),
                      C.QSCHConfig(policy=C.QueuePolicy.BACKFILL))
        res = C.Simulator(state, qsch, C.SimConfig(
            tick_interval=30.0, sample_interval=300.0, horizon=span,
            dynamics=C.DynamicsConfig(plugins=[scaler]))).run([])
        assert scaler.replicas_started >= max(targets), \
            "fleet must ramp to the observed peak"
        assert {s.target for s in scaler.demand_log} == {
            svc.target_replicas(s.t) for s in scaler.demand_log}
        assert scaler.satisfaction() > 0.7
        state.check_invariants()
        return (targets, scaler.demand_log, scaler.replicas_started,
                scaler.replicas_retired, scaler.satisfaction(),
                res.metrics.report(), res.dynamics.as_dict(),
                sorted((j.uid, j.start_time, j.end_time,
                        tuple(p.node for p in j.placement.pods))
                       for j in res.jobs if j.placement is not None))
    held(scenario)


# ----------------------------------------------------------------------
# Token-level fidelity: Replica.build_engine on smoke configs
# ----------------------------------------------------------------------
_ZOO = {}


def ref_params(arch):
    if arch not in _ZOO:
        cfg = ref_configs.get_arch(arch, smoke=True)
        params = RefModel(cfg).init(jax.random.PRNGKey(0))
        _ZOO[arch] = (params, jax.tree.map(np.asarray, params))
    return _ZOO[arch]


def first_requests(C, S, arch, n=4):
    """The first ``n`` requests the round-robin router sent to ``arch``'s
    replica, as engine requests."""
    pool = S.ReplicaPool([S.ReplicaSpec.from_arch(a) for a in FABRIC_ARCHS],
                         S.RoundRobinRouter())
    idx = FABRIC_ARCHS.index(arch)
    sent = [r for r in C.request_trace(40, seed=0)
            if pool.route(r).replica == idx][:n]
    vocab = configs.get_arch(arch, smoke=True).vocab
    return [S.to_engine_request(r, vocab=vocab, max_prompt=12, max_new=4)
            for r in sent]


def serve(engine, requests):
    for r in requests:
        engine.submit(r)
    return {r.uid: list(r.generated) for r in engine.run_until_drained()}


@pytest.mark.parametrize("arch", FABRIC_ARCHS)
def test_build_engine_serves_the_reference_engines_tokens(arch):
    params, tree = ref_params(arch)
    spec = TS.ReplicaSpec.from_arch(arch, slots=2)
    ref_engine = RS.Replica(RS.ReplicaSpec.from_arch(arch, slots=2)
                            ).build_engine(params, max_seq=64, smoke=True)
    want = serve(ref_engine, first_requests(RC, RS, arch))
    state_dict = params_from_reference(configs.get_arch(arch, smoke=True),
                                       tree, device="cpu")
    engine = TS.Replica(spec).build_engine(state_dict, max_seq=64,
                                           smoke=True, device="cpu")
    assert isinstance(engine, TS.ServeEngine) and engine.B == 2
    assert engine.device.type == "cpu"
    got = serve(engine, first_requests(TC, TS, arch))
    assert got == want and len(got) == 4
    assert engine.stats() == ref_engine.stats()
    solo = TS.Replica(dataclasses.replace(spec, slots=1)).build_engine(
        state_dict, max_seq=64, smoke=True, device="cpu")
    assert {r.uid: serve(solo, [r])[r.uid]
            for r in first_requests(TC, TS, arch)} == got


def test_build_engine_needs_an_arch():
    for S in (RS, TS):
        rep = S.Replica(S.ReplicaSpec("anon", capability=0.5,
                                      cost_per_1k_tokens=1.0))
        with pytest.raises(ValueError, match="no arch id"):
            rep.build_engine({})
