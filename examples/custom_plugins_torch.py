"""Extending Kant without touching scheduler internals (framework demo),
on the PyTorch/CUDA port.

The counterpart of ``examples/custom_plugins.py`` through
``repro_torch``: RSCH's fused filter+score pass runs in the node-score
CUDA kernel (``--device cpu``: its plain version on the host), and every
extra Score plugin's term is added to the kernel's scores.  Four
extensions, each a plugin dropped into a profile — no QSCH/RSCH changes
(see ``docs/plugins.md`` for the contract):

1. **GfrAwareScore** (contrib): multi-objective fragmentation-aware
   scoring at node AND NodeNetGroup granularity.  Added to an HA-style
   Spread profile it cuts mean GFR (§4.3) at unchanged SOR.
2. **TenantSoftAffinity** (contrib): pull each tenant's pods toward
   NodeNetGroups the tenant already occupies.
3. A ~10-line custom Score plugin written inline (the docs' worked
   example), registered and exercised through the same machinery.
4. **SemanticSoftAffinity** (contrib): token overlap over free-form
   ``Job.metadata`` — jobs of one workload family co-locate across
   tenants.

Usage::

    PYTHONPATH=src python examples/custom_plugins_torch.py               # card
    PYTHONPATH=src python examples/custom_plugins_torch.py --device cpu  # host
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np

from repro_torch.core import (ClusterState, Job, JobKind, QSCH,
                              QuotaManager, QuotaMode, RSCH, RSCHConfig,
                              SimConfig, Simulator)
from repro_torch.core.framework import (BackfillPolicy, GfrAwareScore,
                                        PlacementPass, ProfileSet,
                                        ScorePlugin, SemanticSoftAffinity,
                                        SpreadScore, TenantSoftAffinity,
                                        default_profiles, ebinpack_pass,
                                        make_profile, register,
                                        single_pass_plan, spread_pass)
from repro_torch.core.snapshot import FullSnapshotter
from repro_torch.core.topology import ClusterTopology
from repro_torch.device import resolve_device


def topology():
    return ClusterTopology(n_nodes=64, gpus_per_node=8, nodes_per_leaf=8,
                           leaves_per_spine=4, spines_per_superspine=2,
                           nodes_per_hbd=8, nvlink_island=8, numa_split=4)


WORKLOAD_FAMILIES = ("llama3 finetune checkpointed",
                     "bert serving latency-bound",
                     "diffusion train image-batches")


def fragmenting_trace(n=260, seed=5, rate_per_hour=300.0,
                      mean_duration_s=1500.0,
                      tenants=("ads", "search", "ranker")):
    """Sub-node jobs that fragment nodes unless the scorer fights it.

    The ~60% steady-state load leaves the scheduler real placement
    freedom.  Each job carries a workload-family description in
    ``metadata`` that cuts ACROSS the tenant rotation, so semantic
    affinity has signal tenant affinity cannot see.
    """
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(3600.0 / rate_per_hour, size=n))
    jobs = []
    for i in range(n):
        gpus = int(rng.choice([1, 2, 3, 4, 6, 8],
                              p=[.2, .22, .13, .25, .1, .1]))
        jobs.append(Job(uid=i, tenant=tenants[i % len(tenants)],
                        gpu_type=0, n_pods=1, gpus_per_pod=gpus,
                        kind=JobKind.TRAIN,
                        submit_time=float(arrivals[i]),
                        duration=float(
                            rng.exponential(mean_duration_s) + 300.0),
                        metadata=WORKLOAD_FAMILIES[
                            (i * 7 + i // 3) % len(WORKLOAD_FAMILIES)]))
    return jobs


def run(profiles: ProfileSet, jobs, device=None,
        score_backend: str = "kernel"):
    """A fresh copy of ``jobs`` through the simulator under
    ``profiles``; returns (topology, result)."""
    topo = topology()
    state = ClusterState.create(topo)
    qm = QuotaManager({t: {0: 10**6} for t in ("ads", "search", "ranker")},
                      mode=QuotaMode.SHARED)
    rsch = RSCH(topo, RSCHConfig(device=device, score_backend=score_backend),
                profiles=profiles)
    qsch = QSCH(qm, rsch, queue_policy=BackfillPolicy(head_timeout=900.0))
    sim = Simulator(state, qsch, SimConfig(tick_interval=30.0,
                                           sample_interval=120.0))
    result = sim.run([Job(uid=j.uid, tenant=j.tenant, gpu_type=j.gpu_type,
                          n_pods=j.n_pods, gpus_per_pod=j.gpus_per_pod,
                          kind=j.kind, submit_time=j.submit_time,
                          duration=j.duration, metadata=j.metadata)
                      for j in jobs])
    return topo, result


# The docs' worked example: a complete custom Score plugin in ~10
# lines.  Registered at module scope — the registry rejects duplicate
# names, so load this module once per process.
@register
class RackFirstScore(ScorePlugin):
    """Prefer low node indices ('near the rack door')."""

    name = "RackFirstScore"

    def __init__(self, weight=0.01):
        self.weight = weight

    def score(self, job, snap, pool, ctx):
        n = snap.free_gpus.shape[0]
        return self.weight * np.linspace(1.0, 0.0, n, dtype=np.float32)


def tenant_group_spans(topo, result):
    spans = {}
    for j in result.jobs:
        if j.placement is None:
            continue
        spans.setdefault(j.tenant, set()).update(
            int(topo.leaf_id[p.node]) for p in j.placement.pods)
    return {t: len(g) for t, g in sorted(spans.items())}


def family_group_spans(topo, result):
    """LeafGroups spanned per workload family (first metadata token)."""
    spans = {}
    for j in result.jobs:
        if j.placement is None or not j.metadata:
            continue
        fam = j.metadata.split()[0]
        spans.setdefault(fam, set()).update(
            int(topo.leaf_id[p.node]) for p in j.placement.pods)
    return {f: len(g) for f, g in sorted(spans.items())}


def _uniform(name, pass_):
    p = make_profile(name, single_pass_plan(pass_))
    return ProfileSet(train=p, inference=p, best_effort=p)


def gfr_section(jobs, device=None, score_backend: str = "kernel") -> dict:
    """§1: HA Spread with and without GfrAwareScore.  Returns both
    results and the mean GFR and SOR the section prints."""
    print("== 1. GFR-aware fragmentation scoring " + "=" * 26)
    topo = topology()
    # An HA-flavored cluster spreads every pod -> fragments every node.
    # The GFR objective rides along as one extra Score plugin.
    spread_only = _uniform("ha-spread", spread_pass())
    spread_gfr = _uniform("ha-spread-gfr", PlacementPass(
        scorers=(SpreadScore(),
                 GfrAwareScore(weight=0.5, topology=topo)),
        spread=True))
    _, base = run(spread_only, jobs, device, score_backend)
    _, plug = run(spread_gfr, jobs, device, score_backend)
    out = {"base": base, "plug": plug, "gfr": base.metrics.mean_gfr(),
           "gfr_plugin": plug.metrics.mean_gfr(), "sor": base.metrics.sor(),
           "sor_plugin": plug.metrics.sor()}
    g0, g1 = out["gfr"], out["gfr_plugin"]
    print(f"  HA Spread           mean GFR {g0:.3f}  SOR {out['sor']:.3f}")
    print(f"  + GfrAwareScore     mean GFR {g1:.3f}  "
          f"SOR {out['sor_plugin']:.3f}")
    print(f"  fragmentation delta: {(g0 - g1) / max(g0, 1e-9) * 100:+.1f}%"
          f"  (spread HA semantics kept)")
    assert g1 < g0
    return out


def affinity_section(jobs, device=None, score_backend: str = "kernel"
                     ) -> dict:
    """§2: E-Binpack with and without TenantSoftAffinity.  Returns both
    results and LeafGroups spanned per tenant."""
    print("\n== 2. Tenant soft affinity " + "=" * 37)
    topo = topology()
    default = default_profiles()
    affinity = ProfileSet(
        train=make_profile("train-affinity", single_pass_plan(
            ebinpack_pass(colocate=2.0, extra_scorers=(
                TenantSoftAffinity(topo, weight=0.6, anti_weight=0.3),)))),
        inference=default.inference,
        best_effort=default.best_effort,
    )
    _, ebp = run(default_profiles(), jobs, device, score_backend)
    _, aff = run(affinity, jobs, device, score_backend)
    span_base = tenant_group_spans(topo, ebp)
    span_aff = tenant_group_spans(topo, aff)
    print(f"  LeafGroups spanned per tenant (E-Binpack): {span_base}")
    print(f"  LeafGroups spanned per tenant (affinity):  {span_aff}")
    assert sum(span_aff.values()) < sum(span_base.values()), \
        "soft affinity should consolidate each tenant into fewer groups"
    return {"ebinpack": ebp, "affinity": aff, "spans": span_base,
            "spans_affinity": span_aff}


def rack_first_section(device=None, score_backend: str = "kernel"
                       ) -> List[int]:
    """§3: one 4-pod gang under RackFirstScore on the empty cluster;
    returns its nodes."""
    print("\n== 3. Write your own Score plugin (10 lines) " + "=" * 19)
    topo = topology()
    custom = ProfileSet(
        train=make_profile("train-rack-first", single_pass_plan(
            PlacementPass(scorers=(RackFirstScore(weight=5.0),)))),
        inference=make_profile("i", single_pass_plan(spread_pass())),
        best_effort=make_profile("b", single_pass_plan(spread_pass())),
    )
    state = ClusterState.create(topo)
    rsch = RSCH(topo, RSCHConfig(device=device, score_backend=score_backend),
                profiles=custom)
    job = Job(uid=1, tenant="ads", gpu_type=0, n_pods=4, gpus_per_pod=8,
              kind=JobKind.TRAIN)
    res = rsch.schedule(job, FullSnapshotter().take(state))
    nodes = [p.node for p in res.placement.pods]
    print(f"  RackFirstScore placed the 4-pod gang on nodes {nodes}")
    assert max(nodes) <= 3
    return nodes


def semantic_section(jobs, ebinpack, device=None,
                     score_backend: str = "kernel") -> dict:
    """§4: SemanticSoftAffinity against ``ebinpack`` (§2's E-Binpack
    result).  Returns its result and LeafGroups spanned per family."""
    print("\n== 4. Semantic soft affinity (job metadata) " + "=" * 20)
    # Workload families rotate out of phase with the tenant rotation:
    # tenant affinity cannot consolidate them, token overlap over
    # Job.metadata can.
    topo = topology()
    default = default_profiles()
    semantic = ProfileSet(
        train=make_profile("train-semantic", single_pass_plan(
            ebinpack_pass(colocate=2.0, extra_scorers=(
                SemanticSoftAffinity(topo, weight=0.8,
                                     anti_weight=0.3),)))),
        inference=default.inference,
        best_effort=default.best_effort,
    )
    _, sem = run(semantic, jobs, device, score_backend)
    fam_base = family_group_spans(topo, ebinpack)
    fam_sem = family_group_spans(topo, sem)
    print(f"  LeafGroups spanned per family (E-Binpack): {fam_base}")
    print(f"  LeafGroups spanned per family (semantic):  {fam_sem}")
    assert sum(fam_sem.values()) < sum(fam_base.values()), \
        "semantic affinity should consolidate workload families"
    return {"semantic": sem, "spans": fam_base, "spans_semantic": fam_sem}


def tour(device=None, score_backend: str = "kernel") -> Dict[str, object]:
    """All four sections on one trace; returns each section's result by
    name (``gfr``, ``affinity``, ``rack_first``, ``semantic``)."""
    jobs = fragmenting_trace()
    gfr = gfr_section(jobs, device, score_backend)
    aff = affinity_section(jobs, device, score_backend)
    nodes = rack_first_section(device, score_backend)
    sem = semantic_section(jobs, aff["ebinpack"], device, score_backend)
    return {"gfr": gfr, "affinity": aff, "rack_first": nodes,
            "semantic": sem}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the host)")
    args = ap.parse_args(argv)
    tour(resolve_device(args.device))
    print("custom_plugins complete")


if __name__ == "__main__":
    main()
