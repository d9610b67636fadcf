"""The port's contrib Score plugins against the JAX package's, on the CPU.

Ports of the contrib tests of ``tests/test_framework.py`` and
``tests/test_tuning.py``, each run through ``repro.core`` and
``repro_torch.core`` (``device="cpu"``).  Contrib terms are added on the
host, outside the fused filter+score pass, so parity across the score
backends and the gang paths is a matter of placements: they are
compared, not scores.
"""

import types

import numpy as np
import pytest

import repro.core as R
import repro.obs  # noqa: F401 - registers the reference's DecisionAudit
import repro.serve  # noqa: F401 - registers the reference's router plugins
import repro_torch.core as T
import repro_torch.obs  # noqa: F401 - registers the port's DecisionAudit
import repro_torch.serve  # noqa: F401 - registers the port's router plugins
from repro.core.framework import registry as ref_registry
from repro_torch.core.framework import registry as port_registry

#: Port variants of the score pass: (score_backend, batched_gang).
VARIANTS = [("kernel", True), ("kernel", False), ("np", True), ("np", False)]


def rsch_config(M, backend="kernel", batched=True, **kw):
    if M is R:
        return M.RSCHConfig(batched_gang=batched, **kw)
    return M.RSCHConfig(score_backend=backend, batched_gang=batched,
                        device="cpu", **kw)


def cluster(M):
    topo = M.small_topology(n_nodes=16, gpus_per_node=8, nodes_per_leaf=4)
    return topo, M.ClusterState.create(topo)


def snap_of(M, state):
    return M.FullSnapshotter().take(state)


def job(M, uid=0, n_pods=1, gpus=8, tenant="t0"):
    return M.Job(uid=uid, tenant=tenant, gpu_type=0, n_pods=n_pods,
                 gpus_per_pod=gpus, kind=M.JobKind.TRAIN)


def pods(result):
    if result.placement is None:
        return None
    return [(p.node, tuple(p.gpu_indices)) for p in result.placement.pods]


def spread_profiles(M, plugin):
    F = M.framework
    spread = F.make_profile("s", F.single_pass_plan(F.spread_pass()))
    return F.ProfileSet(
        train=F.make_profile("t", F.single_pass_plan(F.PlacementPass(
            scorers=(F.create_plugin("SpreadScore"), plugin)))),
        inference=spread, best_effort=spread)


# ----------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------
def shipped(registry, package):
    """Names registered by ``package``'s own modules (not by tests)."""
    return {name for name, factory in registry._REGISTRY.items()
            if factory.__module__.startswith(package + ".")}


def test_registry_has_builtins_and_contrib():
    names = T.framework.available_plugins()
    for expected in ("QuotaAdmit", "DynamicFeasibility", "GpuTypeFilter",
                     "HealthFilter", "BinpackScore", "SpreadScore",
                     "GroupConsolidation", "TopoAnchor", "ColocateBonus",
                     "QuotaReserve", "PriorityPreempt",
                     "QuotaReclaimPreempt", "BackfillHeadTimeout",
                     "StrictFIFO", "BestEffortFIFO", "Backfill",
                     "DefaultQueueSort", "GfrAwareScore",
                     "TenantSoftAffinity", "SemanticSoftAffinity"):
        assert expected in names
    port = shipped(port_registry, "repro_torch")
    assert port == shipped(ref_registry, "repro")
    assert port <= set(names)
    # Each ported plugin is its own class, made from the port's modules.
    for name in port:
        assert port_registry._REGISTRY[name].__module__.startswith(
            "repro_torch.")


# ----------------------------------------------------------------------
# GFR-aware fragmentation score
# ----------------------------------------------------------------------
def gfr_scenario(M, backend="kernel", batched=True):
    topo, state = cluster(M)
    state.gpu_busy[3, :4] = True       # node 3: an exact 4-GPU hole
    F = M.framework
    rsch = M.RSCH(topo, rsch_config(M, backend, batched),
                  profiles=spread_profiles(M, F.GfrAwareScore(weight=10.0)))
    healed = pods(rsch.schedule(job(M, 1, gpus=4), snap_of(M, state)))
    baseline = M.RSCH(topo, rsch_config(M, backend, batched,
                                        train_strategy=M.Strategy.SPREAD))
    spread = pods(baseline.schedule(job(M, 1, gpus=4), snap_of(M, state)))
    # Spread alone avoids node 3; the GFR term overrides it.
    assert healed[0][0] == 3
    assert spread[0][0] != 3
    return healed, spread


@pytest.mark.parametrize("backend,batched", VARIANTS)
def test_gfr_aware_score_heals_fragmented_node(backend, batched):
    assert gfr_scenario(T, backend, batched) == gfr_scenario(R)


# ----------------------------------------------------------------------
# Tenant soft affinity
# ----------------------------------------------------------------------
def tenant_scenario(M, backend="kernel", batched=True):
    topo, state = cluster(M)
    plain = M.RSCH(topo, rsch_config(M, backend, batched))
    running = {}
    for uid, tenant in ((10, "a"), (11, "b")):
        j = job(M, uid, gpus=2, tenant=tenant)
        r = plain.schedule(j, snap_of(M, state))
        state.allocate(j, r.placement)
        j.placement = r.placement
        running[uid] = j
    group_of = {j.tenant: int(topo.leaf_id[j.placement.pods[0].node])
                for j in running.values()}
    affinity = M.framework.TenantSoftAffinity(topo, weight=50.0,
                                              anti_weight=50.0)
    rsch = M.RSCH(topo, rsch_config(M, backend, batched),
                  profiles=spread_profiles(M, affinity))
    ctx = M.framework.SchedulingContext(running=running)
    ra = rsch.schedule(job(M, 1, gpus=2, tenant="a"), snap_of(M, state), ctx)
    assert int(topo.leaf_id[ra.placement.pods[0].node]) == group_of["a"]
    # The per-schedule cache is keyed by the tenant and the running set.
    assert affinity._cache[0] == ("a", (10, 11))
    cached = affinity._cache[1].tolist()
    # Without context the term vanishes (no crash, spread behavior).
    rn = rsch.schedule(job(M, 2, gpus=2, tenant="a"), snap_of(M, state))
    assert rn.placement is not None
    return ([pods(j) for j in (ra, rn)], group_of, cached,
            [(u, tuple(j.placement.nodes)) for u, j in running.items()])


@pytest.mark.parametrize("backend,batched", VARIANTS)
def test_tenant_soft_affinity_groups_tenant(backend, batched):
    assert tenant_scenario(T, backend, batched) == tenant_scenario(R)


# ----------------------------------------------------------------------
# Semantic soft affinity
# ----------------------------------------------------------------------
def running_job(M, uid, node, topo, tenant="t0", metadata=None):
    j = M.Job(uid=uid, tenant=tenant, gpu_type=0, n_pods=1, gpus_per_pod=8,
              kind=M.JobKind.TRAIN, metadata=metadata)
    j.placement = M.Placement(pods=[M.PodPlacement(node=node,
                                                   gpu_indices=(0, 1))])
    return j


def test_token_similarity():
    a = frozenset({"llama70b", "sft", "ads"})
    b = frozenset({"llama70b", "dpo", "ads"})
    for F in (T.framework, R.framework):
        assert F.token_similarity(a, b) == pytest.approx(2 / 4)
        assert F.token_similarity(a, frozenset()) == 0.0
    assert T.framework.token_similarity(a, b) \
        == R.framework.token_similarity(a, b)


def semantic_pull(M):
    # 16 nodes, 4 a leaf: node 0 in group 0, node 12 in group 3.
    topo, _ = cluster(M)
    plugin = M.framework.SemanticSoftAffinity(topo, weight=2.0)
    ctx = types.SimpleNamespace(running={
        1: running_job(M, 1, 0, topo, metadata="llama70b sft ads"),
        2: running_job(M, 2, 12, topo, metadata="resnet vision batch")})
    j = M.Job(uid=9, tenant="t1", gpu_type=0, n_pods=1, gpus_per_pod=8,
              metadata="llama70b dpo ads")
    per_group = plugin.group_score(j, None, np.ones(16, bool), ctx)
    assert per_group[0] == pytest.approx(2.0 * 0.5)   # 2/4 token overlap
    assert per_group[3] == 0.0                        # unrelated
    node_scores = plugin.score(j, None, np.ones(16, bool), ctx)
    assert node_scores[0] > node_scores[12]
    return per_group.tolist(), node_scores.tolist()


def test_semantic_affinity_pulls_toward_similar_groups():
    assert semantic_pull(T) == semantic_pull(R)


def semantic_fallback(M):
    topo, _ = cluster(M)
    plugin = M.framework.SemanticSoftAffinity(topo, weight=1.0,
                                              anti_weight=0.5,
                                              anti_threshold=0.1)
    ctx = types.SimpleNamespace(running={
        1: running_job(M, 1, 0, topo, tenant="ads"),
        2: running_job(M, 2, 12, topo, tenant="search")})
    j = M.Job(uid=9, tenant="ads", gpu_type=0, n_pods=1, gpus_per_pod=8)
    per_group = plugin.group_score(j, None, np.ones(16, bool), ctx)
    assert per_group[0] == pytest.approx(1.0)    # same tenant token
    assert per_group[3] == pytest.approx(-0.5)   # occupied, unrelated
    # Empty cluster: the term vanishes instead of crashing.
    assert plugin.group_score(j, None, np.ones(16, bool),
                              types.SimpleNamespace(running={})) is None
    return per_group.tolist()


def test_semantic_affinity_tenant_fallback_and_anti():
    assert semantic_fallback(T) == semantic_fallback(R)


# ----------------------------------------------------------------------
# All three in one profile, through the simulator
# ----------------------------------------------------------------------
def contrib_sim(M, backend="kernel", batched=True):
    topo = M.small_topology(n_nodes=32, gpus_per_node=8, nodes_per_leaf=4)
    state = M.ClusterState.create(topo)
    F = M.framework
    affinity = F.TenantSoftAffinity(topo, weight=2.0, anti_weight=1.0)
    plan = F.single_pass_plan(F.PlacementPass(scorers=(
        F.create_plugin("BinpackScore"), F.GfrAwareScore(weight=1.5),
        affinity, F.SemanticSoftAffinity(topo, weight=1.0))))
    profiles = F.ProfileSet(train=F.make_profile("t", plan),
                            inference=F.make_profile("i", plan),
                            best_effort=F.make_profile("b", plan))
    rng = np.random.default_rng(11)
    tags = ("llama sft ads", "llama dpo ads", "resnet vision", None)
    jobs = [M.Job(uid=i, tenant=f"t{i % 3}", gpu_type=0,
                  n_pods=int(rng.integers(1, 4)),
                  gpus_per_pod=int(rng.choice([1, 2, 4, 8])),
                  duration=float(rng.integers(300, 5000)),
                  submit_time=float(rng.integers(0, 1800)),
                  kind=M.JobKind.TRAIN, metadata=tags[i % 4])
            for i in range(48)]
    qsch = M.QSCH(M.QuotaManager({f"t{i}": {0: 10 ** 6} for i in range(3)}),
                  M.RSCH(topo, rsch_config(M, backend, batched),
                         profiles=profiles))
    res = M.Simulator(state, qsch, M.SimConfig()).run(jobs)
    return ([(j.uid, j.start_time, pods(j)) for j in
             sorted(res.jobs, key=lambda j: j.uid)],
            res.metrics.report(), res.cycles)


@pytest.mark.parametrize("backend,batched", VARIANTS)
def test_contrib_profile_placements_match_reference(backend, batched):
    assert contrib_sim(T, backend, batched) == contrib_sim(R, "np", batched)
