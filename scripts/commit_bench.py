#!/usr/bin/env python3
"""Time the commit of one placement to the column block, by pod count
and path, on the 80,000-GPU topology of ``kantbench``'s ``kant-80k``.

    python scripts/commit_bench.py [--pods 1,2,3,4,8,64,256] [--slots 8]
        [--reps 300] [--seed 0]

A fragmented 10,000-node × 8-GPU cluster (each node busy with
probability 0.6, 1–8 GPUs in its lowest slots) and an incremental
snapshot of it with the three per-group sums RSCH keeps, one pair for
each variant of the package under this checkout's ``src``: its commit
path forced pod by pod (``per_pod``), forced to one gang write
(``batched``) and as shipped (``shipped``, ``cluster.BATCH_MIN_PODS``).
A package without that constant is timed as it ships alone: to time
another checkout, copy this script into its ``scripts/`` and run it
there, in a process of its own.  For each pod count, a gang of
``--slots``-GPU pods on wholly free nodes is bound and freed ``--reps``
times on every variant in turn (each leading in turn), each time as a
fresh ``Placement`` (its index form is built inside the first call, as
in a cycle): ``allocate``, ``apply_placement``, ``release``,
``apply_release``, each timed alone.  Prints one JSON line per (pods,
variant): the median µs of each call; each state and snapshot is
checked to be back where it started.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

OPS = ("allocate", "apply_placement", "release", "apply_release")


def build(core, np, seed: int):
    topo = core.ClusterTopology(
        n_nodes=10_000, gpus_per_node=8, nodes_per_leaf=32,
        leaves_per_spine=4, spines_per_superspine=4, nodes_per_hbd=32)
    state = core.ClusterState.create(topo)
    rng = np.random.default_rng(seed)
    busy_nodes = rng.random(topo.n_nodes) < 0.6
    count = rng.integers(1, 9, size=topo.n_nodes)
    state.gpu_busy[:] = ((np.arange(8) < count[:, None])
                         & busy_nodes[:, None])
    snap = core.IncrementalSnapshotter().take(state)
    pool = snap.candidate_pool(0)
    for key, col in (("gslots", lambda s: s.free_gpus // 8),
                     ("gfree", lambda s: s.free_gpus),
                     ("gused", lambda s: s.used_gpus)):
        def contrib(s, idx, col=col):
            if idx is None:
                return np.where(pool, col(s), 0)
            return np.where(pool[idx], col(s)[idx], 0)
        snap.tracked_sum(key, topo.leaf_id, topo.n_leaf_groups, contrib)
    return state, snap, np.flatnonzero(~busy_nodes)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pods", default="1,2,3,4,8,64,256")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--reps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np

    import repro_torch.core as core
    from repro_torch.core import cluster as ours

    # variant -> BATCH_MIN_PODS to set (None: as it ships)
    shipped = getattr(ours, "BATCH_MIN_PODS", None)
    variants = {"shipped": None}
    if shipped is not None:
        variants = {"per_pod": 10 ** 9, "batched": 1, "shipped": shipped}
    blocks = {}
    for name in variants:
        state, snap, free_nodes = build(core, np, args.seed)
        blocks[name] = (state, snap, state.cols.copy())
    uid = 0
    gc.collect()
    gc.disable()
    for n_pods in (int(p) for p in args.pods.split(",")):
        job = core.Job(uid=0, tenant="t", gpu_type=0, n_pods=n_pods,
                       gpus_per_pod=args.slots)
        pods = [core.PodPlacement(node=int(n),
                                  gpu_indices=tuple(range(args.slots)))
                for n in free_nodes[:n_pods]]
        times = {name: {op: [] for op in OPS} for name in variants}
        names = list(variants)
        for rep in range(args.reps):
            # each variant leads in turn, so no one always runs first
            k = rep % len(names)
            for name in names[k:] + names[:k]:
                batch_min = variants[name]
                if batch_min is not None:
                    ours.BATCH_MIN_PODS = batch_min
                state, snap, _ = blocks[name]
                uid += 1
                job.uid = uid
                placement = core.Placement(pods=list(pods))
                t0 = time.perf_counter_ns()
                state.allocate(job, placement)
                t1 = time.perf_counter_ns()
                snap.apply_placement(placement)
                t2 = time.perf_counter_ns()
                state.release(uid)
                t3 = time.perf_counter_ns()
                snap.apply_release(placement)
                t4 = time.perf_counter_ns()
                for op, a, b in zip(OPS, (t0, t1, t2, t3), (t1, t2, t3, t4)):
                    times[name][op].append((b - a) / 1e3)
        if shipped is not None:
            ours.BATCH_MIN_PODS = shipped
        for name, per_op in times.items():
            state, snap, start = blocks[name]
            fresh = start.copy()
            fresh.refresh_derived()
            assert state.cols.columns_equal(fresh), f"{name}: state drifted"
            assert snap.cols.columns_equal(fresh), f"{name}: snap drifted"
            med = {op: statistics.median(v) for op, v in per_op.items()}
            print(json.dumps({
                "pods": n_pods, "slots": args.slots, "variant": name,
                "reps": args.reps,
                "us": {op: round(v, 2) for op, v in med.items()},
                "commit_us": round(med["allocate"]
                                   + med["apply_placement"], 2),
                "free_us": round(med["release"] + med["apply_release"], 2),
                "commit_pods": getattr(state, "commit_pods", None)}),
                flush=True)
    gc.enable()


if __name__ == "__main__":
    main()
