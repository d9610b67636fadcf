#!/usr/bin/env python3
"""Time the commit of one placement to the column block, by pod count
and path, on the 80,000-GPU topology of ``kantbench``'s ``kant-80k``.

    python scripts/commit_bench.py [--pods 1,2,3,4,6,8,12,16,24,32,64,256]
        [--slots 8] [--reps 300] [--seed 0]

A fragmented 10,000-node × 8-GPU cluster with a 2,500-node inference
zone (each node busy with probability 0.6, 1–8 GPUs in its lowest slots)
and an incremental snapshot of it with three per-group sums over the
pool and the sums an ``inference-wave`` snapshot holds (RSCH's own:
slots of each pod size in the zone, outside it and over the pool, free
and used GPUs in and outside the zone), one pair for each variant of the
package under this checkout's ``src``: as shipped (``shipped``); its
write path forced pod by pod (``per_pod``) and to one gang write
(``batched``), ``cluster.BATCH_MIN_PODS``; its derived columns forced to
be re-derived (``rederive``) and brought up to date by count deltas
(``delta``), ``cluster.DELTA_MAX_PODS``.  A variant sets its constant
alone; a package without the constant is timed as it ships: to time
another checkout, copy this script into its ``scripts/`` and run it
there, in a process of its own.  For each pod count, a gang of
``--slots``-GPU pods on wholly free nodes is bound and freed ``--reps``
times on every variant in turn (each leading in turn), each time as a
fresh ``Placement`` (its index form is built inside the first call, as
in a cycle): ``allocate``, ``apply_placement``, ``release``,
``apply_release``, then ``read``: the four sums a schedule call of a
small inference service reads, through ``Snapshot.tracked_sum`` (where
a package patches its sums when read, the patches of the four calls
before), each timed alone.  Prints one JSON line per (pods, variant):
the median µs of each call; each state and snapshot is checked to be
back where it started, and each sum equal to a from-scratch count.
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

OPS = ("allocate", "apply_placement", "release", "apply_release", "read")
#: the constants a variant may set, and the value that forces each path
VARIANTS = {"per_pod": ("BATCH_MIN_PODS", 10 ** 9),
            "batched": ("BATCH_MIN_PODS", 1),
            "rederive": ("DELTA_MAX_PODS", 0),
            "delta": ("DELTA_MAX_PODS", 10 ** 9)}
#: what a schedule call of a small inference service reads: admission's
#: slots over the pool, then the zone pass's slots, free and used GPUs
READ = (("slots", None, 2), ("slots", "zone", 2), ("free", "zone"),
        ("used", "zone"))


def build(core, np, seed: int):
    topo = core.ClusterTopology(
        n_nodes=10_000, gpus_per_node=8, nodes_per_leaf=32,
        leaves_per_spine=4, spines_per_superspine=4, nodes_per_hbd=32)
    state = core.ClusterState.create(topo, inference_zone_nodes=2_500)
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
    rsch = core.RSCH(topo, core.RSCHConfig(device="cpu"))
    sums = {("slots", zone, size): (rsch._group_slots_cached, zone, size)
            for zone in ("zone", "general", None) for size in (1, 2, 4, 8)}
    for zone in ("zone", "general"):
        sums["free", zone] = (rsch._group_free_cached, zone)
        sums["used", zone] = (rsch._group_used_cached, zone)
    for key in sums:
        read(snap, sums, key)
    # the wholly free nodes, outside the zone
    free_nodes = np.flatnonzero(~busy_nodes & ~state.inference_zone)
    return state, snap, sums, free_nodes


def read(snap, sums, key):
    """One sum of ``sums`` through RSCH's helper (``tracked_sum``)."""
    fn, *args = sums[key]
    return fn(snap, 0, *args)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pods", default="1,2,3,4,6,8,12,16,24,32,64,256")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--reps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np

    import repro_torch.core as core
    from repro_torch.core import cluster as ours

    # variant -> the constant it sets and its value (None: as it ships)
    shipped = {attr: getattr(ours, attr) for attr, _ in VARIANTS.values()
               if hasattr(ours, attr)}
    variants = {"shipped": None}
    variants.update((name, forced) for name, forced in VARIANTS.items()
                    if forced[0] in shipped)
    blocks = {}
    for name in variants:
        state, snap, sums, free_nodes = build(core, np, args.seed)
        blocks[name] = (state, snap, sums, state.cols.copy())
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
                for attr, value in shipped.items():
                    setattr(ours, attr, value)
                if variants[name] is not None:
                    setattr(ours, *variants[name])
                state, snap, sums, _ = blocks[name]
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
                for key in READ:
                    read(snap, sums, key)
                t5 = time.perf_counter_ns()
                for op, a, b in zip(OPS, (t0, t1, t2, t3, t4),
                                    (t1, t2, t3, t4, t5)):
                    times[name][op].append((b - a) / 1e3)
        for attr, value in shipped.items():
            setattr(ours, attr, value)
        for name, per_op in times.items():
            state, snap, sums, start = blocks[name]
            fresh = start.copy()
            fresh.refresh_derived()
            assert state.cols.columns_equal(fresh), f"{name}: state drifted"
            assert snap.cols.columns_equal(fresh), f"{name}: snap drifted"
            for key, cache in list(snap.tracked.items()):
                got = snap.tracked_sum(key, cache.leaf_id, len(cache.totals),
                                       cache.contrib_fn)
                want = np.bincount(cache.leaf_id,
                                   weights=cache.contrib_fn(snap, None),
                                   minlength=len(cache.totals))
                assert (got == want).all(), f"{name}: {key} drifted"
            med = {op: statistics.median(v) for op, v in per_op.items()}
            print(json.dumps({
                "pods": n_pods, "slots": args.slots, "variant": name,
                "reps": args.reps,
                "us": {op: round(v, 2) for op, v in med.items()},
                "commit_us": round(med["allocate"]
                                   + med["apply_placement"], 2),
                "free_us": round(med["release"] + med["apply_release"], 2),
                "cycle_us": round(sum(med.values()), 2),
                "commit_pods": getattr(state, "commit_pods", None),
                "commit_work": getattr(state, "commit_work", None)}),
                flush=True)
    gc.enable()


if __name__ == "__main__":
    main()
