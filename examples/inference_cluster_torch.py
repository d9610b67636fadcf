"""Multi-tenant inference cluster (paper §5.2) + real serving path, on
the PyTorch/CUDA port.

The counterpart of ``examples/inference_cluster.py`` through
``repro_torch``.  Part 1 reproduces the §5.2 scenario shape: a
sub-thousand-GPU heterogeneous cluster (two GPU types), three tenants
with per-type quotas, an E-Spread inference dedicated zone, and a mixed
fleet of small HA inference services plus a few multi-node
distributed-inference jobs; RSCH's Level-2 pass runs in the node-score
CUDA kernel.  It prints GAR / SOR / GFR and the per-tenant quota
picture.

Part 2 *serves* one of those placed services: the ServeEngine runs
continuous batching (prefill + decode with a KV cache) over a reduced
glm4-9b on the card.  It stays on the *legacy whole-batch shim*
(``per_slot=False``) on purpose, as the reference does: every request
shares one token budget, so slots turn over in lock-step waves and the
shim pins the original engine semantics as an executable regression
reference (docs/serving.md has the per-slot path).

Usage::

    PYTHONPATH=src python examples/inference_cluster_torch.py               # card
    PYTHONPATH=src python examples/inference_cluster_torch.py --device cpu  # host
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from repro_torch.core import (ClusterState, Job, JobKind, QSCH, QSCHConfig,
                              QueuePolicy, QuotaManager, QuotaMode, RSCH,
                              RSCHConfig, SimConfig, Simulator, Strategy)
from repro_torch.core.topology import ClusterTopology
from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve_demo

QUOTA = {"search": {0: 160, 1: 64}, "chat": {0: 256, 1: 96},
         "api": {0: 96, 1: 96}}


def build_jobs(rng: np.random.Generator, n_small: int = 60,
               n_large: int = 4):
    """Small HA replica services + DeepSeek-V3-style multi-node EP jobs."""
    jobs, uid = [], 0
    tenants = ["search", "chat", "api"]
    for i in range(n_small):
        gpus = int(rng.choice([1, 2, 4], p=[0.5, 0.3, 0.2]))
        replicas = int(rng.integers(2, 5))
        for _ in range(replicas):
            jobs.append(Job(
                uid=uid, tenant=tenants[i % 3],
                gpu_type=int(rng.random() < 0.3),
                n_pods=1, gpus_per_pod=gpus, kind=JobKind.INFER,
                gang=False, submit_time=float(rng.uniform(0, 1800)),
                duration=float(rng.uniform(3600, 7200))))
            uid += 1
    for _ in range(n_large):       # 8-node x 8-GPU EP inference (gang)
        jobs.append(Job(uid=uid, tenant="chat", gpu_type=0, n_pods=8,
                        gpus_per_pod=8, kind=JobKind.INFER, gang=True,
                        submit_time=float(rng.uniform(600, 2400)),
                        duration=7200.0))
        uid += 1
    jobs.sort(key=lambda j: j.submit_time)
    return jobs


def schedule_cluster(device=None, score_backend: str = "kernel"
                     ) -> Dict[str, object]:
    """Part 1: one simulated hour on the 96-node heterogeneous cluster.
    Returns the result, its report, GPUs used per tenant and type
    (``usage``: tenant -> [Type-L, Type-A]) and the small inference jobs
    placed wholly inside the E-Spread zone (``zone_jobs``)."""
    print("== Part 1: Kant on a heterogeneous inference cluster ==")
    # 96 nodes x 8 GPUs = 768 GPUs; nodes 64.. are GPU type 1 ("Type-A"),
    # the rest type 0 ("Type-L").  16 nodes form the E-Spread zone.
    topo = ClusterTopology(n_nodes=96, gpus_per_node=8, nodes_per_leaf=8,
                           leaves_per_spine=4, spines_per_superspine=3,
                           nodes_per_hbd=8, nvlink_island=8, numa_split=4)
    gpu_types = np.zeros(96, np.int32)
    gpu_types[64:] = 1
    state = ClusterState.create(topo, gpu_type=gpu_types,
                                inference_zone_nodes=16)
    qm = QuotaManager(QUOTA, mode=QuotaMode.SHARED)
    rsch = RSCH(topo, RSCHConfig(train_strategy=Strategy.E_BINPACK,
                                 infer_strategy=Strategy.E_SPREAD,
                                 device=device, score_backend=score_backend))
    qsch = QSCH(qm, rsch, QSCHConfig(policy=QueuePolicy.BACKFILL))
    sim = Simulator(state, qsch, SimConfig(tick_interval=15.0,
                                           sample_interval=120.0,
                                           horizon=3600.0))
    rng = np.random.default_rng(11)
    result = sim.run(build_jobs(rng))
    rep = result.metrics.report()
    print(f"  GAR(median)={rep['median_gar']:.3f}  SOR={rep['sor']:.3f}  "
          f"GFR(mean)={rep['mean_gfr']:.3f}")
    placed = [j for j in result.jobs if j.placement is not None]
    by_tenant = {}
    for j in placed:
        by_tenant.setdefault(j.tenant, [0, 0])
        by_tenant[j.tenant][j.gpu_type] += j.n_gpus
    for t, (l_gpus, a_gpus) in sorted(by_tenant.items()):
        q = QUOTA[t]
        print(f"  tenant {t:7s} used Type-L {l_gpus:4d}/{q[0]:4d}  "
              f"Type-A {a_gpus:3d}/{q[1]:3d}")
    zone_jobs = sum(1 for j in placed if not j.gang and j.placement and
                    all(p.node < 16 for p in j.placement.pods))
    print(f"  small inference pods fully inside the E-Spread zone: "
          f"{zone_jobs}")
    return {"result": result, "report": rep, "usage": by_tenant,
            "zone_jobs": zone_jobs}


def serve_placed(device=None):
    """Part 2: 10 requests through the legacy whole-batch shim; returns
    the finished requests."""
    print("\n== Part 2: serve a placed model (continuous batching) ==")
    # Legacy shim on purpose — see the module docstring for why.
    finished = serve_demo("glm4-9b", requests=10, batch_size=4, max_new=6,
                          per_slot=False, device=device)
    assert len(finished) == 10
    return finished


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    schedule_cluster(dev)
    serve_placed(dev)
    print("inference_cluster complete")


if __name__ == "__main__":
    main()
