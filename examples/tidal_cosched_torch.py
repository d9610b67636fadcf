"""Tidal train/inference co-scheduling over two simulated days, on the
PyTorch/CUDA port.

The counterpart of ``examples/tidal_cosched.py`` through ``repro_torch``;
RSCH's Level-2 pass runs in the node-score CUDA kernel (``--device
cpu``: its plain version on the host).  The cluster runs four
autoscaled inference services over a deep backlog of low-priority
training.  Overnight the tide goes out — the autoscaler retires surplus
replicas and training backfills the reclaimed GPUs; at the morning ramp
new high-priority replicas preempt the backfill through the framework's
Preempt chain (PriorityPreempt) and take the GPUs back.  A seeded
node-failure injector runs throughout, so interrupted jobs also
demonstrate checkpoint-restart recovery.

Usage::

    PYTHONPATH=src python examples/tidal_cosched_torch.py               # card
    PYTHONPATH=src python examples/tidal_cosched_torch.py --device cpu  # host
"""

from __future__ import annotations

import argparse

from repro_torch.core import (CheckpointModel, ClusterState, DynamicsConfig,
                              NodeFailureInjector, QSCH, QSCHConfig,
                              QuotaManager, RSCH, RSCHConfig, SimConfig,
                              Simulator, TidalAutoscaler, TidalService,
                              backfill_training_trace)
from repro_torch.core.topology import small_topology
from repro_torch.device import resolve_device

DAY = 86_400.0


def run_days(device=None, score_backend: str = "kernel"):
    """Two simulated days; returns (result, autoscaler, services)."""
    topo = small_topology(n_nodes=64, gpus_per_node=8, nodes_per_leaf=8)
    state = ClusterState.create(topo)
    quota = QuotaManager({"svc": {0: 10**6}, "batch": {0: 10**6}})
    rsch = RSCH(topo, RSCHConfig(device=device, score_backend=score_backend))
    qsch = QSCH(quota, rsch, QSCHConfig())

    services = [TidalService(name=f"svc{i}", tenant="svc",
                             gpus_per_replica=4, min_replicas=1,
                             max_replicas=12, peak_hour=14.0)
                for i in range(4)]
    scaler = TidalAutoscaler(services, interval_s=900.0)

    backlog = backfill_training_trace(
        180, seed=0, sizes=(8, 16, 32), size_probs=(.4, .35, .25),
        duration_range_h=(2.0, 4.0))

    dynamics = DynamicsConfig(
        plugins=[scaler,
                 NodeFailureInjector(mtbf_s=24 * 3600.0, repair_s=1800.0,
                                     shape=1.2)],
        recovery=CheckpointModel(interval_s=600.0,
                                 restart_overhead_s=120.0),
        seed=0)
    sim = Simulator(state, qsch, SimConfig(horizon=2 * DAY,
                                           dynamics=dynamics))
    return sim.run(backlog), scaler, services


def report(result, scaler, services) -> None:
    """Print the tide every ~2 simulated hours and the day's totals, and
    hold the reference's three asserts."""
    print("hour  demand  infer-GPUs  train-GPUs  GAR")
    next_mark = 0.0
    for s in result.metrics.samples:
        if s.t < next_mark:     # print every ~2 simulated hours
            continue
        next_mark = s.t + 7200.0
        demand = sum(svc.target_replicas(s.t) * svc.gpus_per_replica
                     for svc in services)
        print(f"{s.t / 3600.0:5.1f}  {demand:6d}  {s.infer_allocated:10d}"
              f"  {s.train_allocated:10d}  {s.gar:.2f}")

    d = result.dynamics
    print(f"\nreplicas +{d.replicas_started}/-{d.replicas_retired} over "
          f"{result.scale_events} scale decisions; "
          f"{result.preemptions} preemptions at the ramps")
    print(f"failures {result.failures}, interrupts {result.interrupts}, "
          f"MTTR {result.metrics.mttr():.0f}s, demand satisfaction "
          f"{scaler.satisfaction():.3f}")
    assert scaler.satisfaction() > 0.9
    assert d.replicas_retired > 0 and result.preemptions > 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the host)")
    args = ap.parse_args(argv)
    report(*run_days(resolve_device(args.device)))
    print("tidal_cosched complete")


if __name__ == "__main__":
    main()
