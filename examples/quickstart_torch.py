"""Quickstart for the PyTorch/CUDA port: the Kant scheduling loop + the
workloads it schedules.

The counterpart of ``examples/quickstart.py``, through ``repro_torch``
on the CUDA device (``--device cpu`` runs it on the host).  It tours the
port's public API end to end:

1. build a 256-GPU cluster (leaf/spine topology, 8-GPU nodes);
2. assemble scheduling profiles from the plugin framework
   (``repro_torch.core.framework``, see docs/plugins.md) — Kant's
   defaults (Backfill + E-Binpack) vs a Strict-FIFO/plain-Binpack
   baseline;
3. schedule a mixed training trace with both and print the paper's five
   metrics (GAR, SOR, GFR, JWTD, JTTED); RSCH's Level-2 pass runs in the
   node-score CUDA kernel;
4. run a few training steps of a reduced ("smoke") model, then one
   forward per family; the rwkv6 forward runs the WKV CUDA kernel.

Usage::

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # host
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import torch

from repro_torch.configs import get_arch, make_inputs
from repro_torch.core import (ClusterState, QSCH, QuotaManager, QuotaMode,
                              RSCH, RSCHConfig, SimConfig, Simulator,
                              training_trace)
from repro_torch.core.framework import (BackfillPolicy, ProfileSet,
                                        StrictFIFOPolicy, binpack_pass,
                                        default_profiles, make_profile,
                                        single_pass_plan)
from repro_torch.core.topology import ClusterTopology
from repro_torch.device import resolve_device
from repro_torch.launch.train import train_loop
from repro_torch.models.model import Model

# The baseline scheduler as explicit profiles: plain node-level Binpack
# for every workload class, Strict-FIFO queue.  Kant's defaults come
# from default_profiles(): E-Binpack training, E-Spread inference.
BASELINE_PROFILES = ProfileSet(
    train=make_profile("train-binpack", single_pass_plan(binpack_pass())),
    inference=make_profile("infer-binpack",
                           single_pass_plan(binpack_pass())),
    best_effort=make_profile("dev-binpack",
                             single_pass_plan(binpack_pass())),
)

FAMILY_ARCHS = ("mixtral-8x7b", "rwkv6-3b", "hymba-1.5b", "llava-next-34b")


def schedule(queue_policy, profiles: ProfileSet, jobs, device=None,
             score_backend: str = "kernel"):
    """One simulator run of ``jobs`` on the 32-node cluster; RSCH scores
    on ``device`` through ``score_backend``."""
    topo = ClusterTopology(n_nodes=32, gpus_per_node=8, nodes_per_leaf=8,
                           leaves_per_spine=2, spines_per_superspine=2,
                           nodes_per_hbd=8, nvlink_island=8, numa_split=4)
    state = ClusterState.create(topo)
    qm = QuotaManager({"team-a": {0: 10**6}}, mode=QuotaMode.SHARED)
    rsch = RSCH(topo, RSCHConfig(device=device, score_backend=score_backend),
                profiles=profiles)
    qsch = QSCH(qm, rsch, queue_policy=queue_policy)
    sim = Simulator(state, qsch, SimConfig(tick_interval=30.0,
                                           sample_interval=120.0))
    return sim.run(jobs)


def show(tag, result):
    rep = result.metrics.report()
    print(f"  {tag:28s} GAR(med)={rep['median_gar']:.3f} "
          f"SOR={rep['sor']:.3f} GFR(mean)={rep['mean_gfr']:.3f} "
          f"preemptions={result.preemptions}")
    return rep


def compare_schedulers(device=None, score_backend: str = "kernel"
                       ) -> Dict[str, object]:
    """§1: the trace under Strict FIFO + Binpack and under Kant's
    defaults.  Returns both results (``"baseline"``, ``"kant"``) and the
    JTTED dict the section prints (``"jtted"``)."""
    print("== 1. Kant vs baseline on a 256-GPU cluster " + "=" * 20)
    jobs = [j for j in training_trace(150, seed=7,
                                      arrival_rate_per_hour=500.0,
                                      mean_duration_s=1800.0)
            if j.n_gpus <= 64]
    base = schedule(StrictFIFOPolicy(), BASELINE_PROFILES, list(jobs),
                    device, score_backend)
    kant = schedule(BackfillPolicy(head_timeout=600.0),
                    default_profiles(), list(jobs), device, score_backend)
    show("Strict FIFO + Binpack", base)
    rep = show("Kant (Backfill + E-Binpack)", kant)
    jtted = {k: (round(a, 2), round(b, 2))
             for k, (a, b) in rep["jtted"].items()}
    if jtted:
        print("  JTTED (node_dev, group_dev) by job size:", jtted)
    return {"baseline": base, "kant": kant, "jtted": jtted}


def train_smoke(device=None) -> List[float]:
    """§2: six steps of the glm4-9b smoke config; returns the losses and
    asserts that they go down."""
    print("\n== 2. Train a smoke model (the scheduled workload) " + "=" * 12)
    state = train_loop("glm4-9b", smoke=True, steps=6, batch=4, seq=32,
                       log_every=2, device=device)
    losses = [h["loss"] for h in state.history]
    assert losses[-1] < losses[0], "loss should go down"
    print(f"  loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps  [ok]")
    return losses


@torch.no_grad()
def forward_tour(device=None, wkv_backend: str = "kernel"
                 ) -> Dict[str, torch.Tensor]:
    """§3: one forward of each family's smoke config (seed-0 weights,
    a batch of 2 × 16 positions); returns the logits by arch.
    ``wkv_backend`` is rwkv6's route ("kernel": the WKV CUDA kernel on a
    CUDA device)."""
    print("\n== 3. One forward pass per family " + "=" * 29)
    dev = resolve_device(device)
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = get_arch(arch, smoke=True)
        model = Model(cfg, device=dev, wkv_backend=wkv_backend).init(
            torch.Generator(device=dev).manual_seed(0))
        batch = {k: v.to(dev) for k, v in
                 make_inputs(cfg, batch=2, seq=16, kind="train").items()}
        logits, _aux = model(batch)
        out[arch] = logits
        print(f"  {arch:28s} [{cfg.family:6s}] logits "
              f"{tuple(logits.shape)}  ok")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' for the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    compare_schedulers(dev)
    train_smoke(dev)
    forward_tour(dev)
    print("\nquickstart complete")


if __name__ == "__main__":
    main()
