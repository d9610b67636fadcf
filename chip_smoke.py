#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's scheduling cycle on one CUDA card and holds every
kernel of that path against its plain torch version::

    python3 chip_smoke.py

Phases, each printed as one JSON line on stdout:

1. device  — ``nvidia-smi`` name and power limit;
2. build   — ``nvcc`` build of ``kernels/csrc/node_score.cu`` for sm_90a;
3. sweep   — both kernels against the plain torch version on the card
             and the host numpy path, as int32 bit patterns;
4. main    — the paper's §5.1 run (1,000 nodes × 8 GPUs, 1,000-job
             training trace at 300 jobs/h, Backfill + E-Binpack) through
             ``Simulator.run`` on the card, with ``device="cpu"`` and with
             the host numpy backend: placements byte-identical, metric
             reports equal, launches > 0; then a timed and a profiled run
             split its time between the device seam and the rest;
5. per-pod — the per-pod path (``batched_gang=False``) at 10k nodes: it
             launches the score-only kernel, placements equal batched;
6. scale   — one 64-pod × 8-GPU gang cycle at 10k / 100k / 1M nodes with
             subset scoring on and off (off = full-width kernel sweep).

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises and
the script exits non-zero without that line.  Without a CUDA device it
exits 2 before doing anything.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
READ_BYTES = 4 + 4 + 1 + 4 + 4  # free, used (int32), mask (bool), gload, topo
FLOPS_PER_NODE = 8            # 1 div, 4 mul, 3 add
SIZES = (1, 31, 32, 8193, 1_048_576)
SCALE_SIZES = (10_000, 100_000, 1_000_000)
GANG_PODS, GPUS_PER_POD = 64, 8
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n: int, out_bytes: int) -> tuple:
    """Least time for one pass over ``n`` nodes: bytes over HBM rate vs
    f32 operations over the f32 peak; returns (ms, what bounds it)."""
    t_bytes = n * (READ_BYTES + out_bytes) / HBM_BYTES_PER_S
    t_ops = n * FLOPS_PER_NODE / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_ms(torch, fn, iters: int, flush=None) -> float:
    """Mean device ms of ``fn`` from CUDA events.  With ``flush`` (a
    buffer larger than L2), each launch is timed alone after the buffer
    is rewritten, so the inputs come from HBM, as after a fresh upload."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    if flush is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    for _ in range(iters):
        flush.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def placement_key(jobs):
    return [(j.uid, j.start_time,
             None if j.placement is None else
             tuple((p.node, tuple(p.gpu_indices)) for p in j.placement.pods))
            for j in sorted(jobs, key=lambda j: j.uid)]


def fragmented_state(core, np, n_nodes: int, seed: int = 0):
    """A fragmented cluster: ~60% of nodes partially or fully busy (the
    reference's ``benchmarks/sched_scale_bench.py::make_state``)."""
    topo = core.ClusterTopology(
        n_nodes=n_nodes, gpus_per_node=8, nodes_per_leaf=32,
        leaves_per_spine=4, spines_per_superspine=4, nodes_per_hbd=32)
    state = core.ClusterState.create(topo)
    rng = np.random.default_rng(seed)
    busy_nodes = rng.random(n_nodes) < 0.6
    busy_count = rng.integers(1, 9, size=n_nodes)
    state.gpu_busy[:] = ((np.arange(8) < busy_count[:, None])
                         & busy_nodes[:, None])
    return state


def kernel_inputs(rec):
    """The recorded ops call as (device columns, wrapper keywords)."""
    from repro_torch.kernels import ops
    args, kw = rec.last
    w = kw["weights"]
    return ops._columns(*args), dict(
        request=kw["request"], gpus_per_node=kw["gpus_per_node"],
        w_used=w.used, w_fit=w.fit, w_group=w.group, w_topo=w.topo)


class CallRecorder:
    """Wraps one module attribute: counts calls, sums their host seconds
    and keeps the last call's arguments (so the cycle's own kernel
    inputs can be timed afterwards)."""

    def __init__(self, module, name: str) -> None:
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.last = None
        self.calls = 0
        self.seconds = 0.0

    def __enter__(self):
        def wrapped(*args, **kw):
            self.last = (args, kw)
            t = time.perf_counter()
            out = self.orig(*args, **kw)
            self.seconds += time.perf_counter() - t
            self.calls += 1
            return out
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def device_busy_ms(torch, run) -> dict:
    """Device time by kind over ``run()`` from ``torch.profiler``:
    kernels vs memory copies, in ms (0 where the trace has no device
    events)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernel = copy = 0.0
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if "memcpy" in e.key.lower() or "memset" in e.key.lower():
            copy += us / 1e3
        else:
            kernel += us / 1e3
    return {"kernel_ms": kernel, "copy_ms": copy}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np

    import repro_torch.core as core
    from repro_torch.core.snapshot import FullSnapshotter
    from repro_torch.kernels import node_score, ops
    from repro_torch.kernels.ref import (node_scores_ref,
                                         node_scores_slots_ref)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0)})

    # -- 2. build ------------------------------------------------------
    node_score.build()
    emit({"phase": "build", "seconds": node_score.build_seconds,
          "flags": " ".join(node_score.NVCC_FLAGS)})

    # -- 3. sweep: kernel vs plain version, bit patterns ------------------
    weight_sets = {"BINPACK": core.BINPACK, "E_BINPACK": core.E_BINPACK,
                   "SPREAD": core.SPREAD, "E_SPREAD": core.E_SPREAD,
                   "MIXED": core.ScoreWeights(0.3, -0.2, 1.1, -0.7)}
    stats = {"score": {"cases": 0, "mismatches": 0, "max_abs_err": 0.0},
             "slots": {"cases": 0, "mismatches": 0, "max_abs_err": 0.0}}
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for n in SIZES:
        for g in (8, 6):
            free = rng.integers(0, g + 1, size=n).astype(np.int32)
            used = (rng.random(n) * (g - free + 1)).astype(np.int32)
            mask = rng.random(n) < 0.8
            gload = rng.random(n).astype(np.float32)
            topo = np.where(rng.random(n) < 0.5,
                            1.0 / (1.0 + rng.integers(0, 6, size=n)),
                            0.0).astype(np.float32)
            cols = tuple(torch.from_numpy(a).to(dev)
                         for a in (free, used, mask, gload, topo))
            for request in (r for r in (1, 2, 4, 8) if r <= g):
                for wname, w in weight_sets.items():
                    kw = dict(request=request, gpus_per_node=g,
                              w_used=w.used, w_fit=w.fit, w_group=w.group,
                              w_topo=w.topo)
                    host = core.node_scores_np(free, used, mask, gload,
                                               topo, request, g, w)
                    s1 = node_score.node_scores(*cols, **kw)
                    s2, sl = node_score.node_scores_slots(*cols, **kw)
                    p1 = node_scores_ref(*cols, **kw)
                    p2, psl = node_scores_slots_ref(*cols, **kw)
                    torch.cuda.synchronize()
                    hb = host.view(np.int32)
                    for name, k, p in (("score", s1, p1), ("slots", s2, p2)):
                        kb = k.cpu().numpy()
                        bad = int((kb.view(np.int32) != p.cpu().numpy()
                                   .view(np.int32)).sum()
                                  + (kb.view(np.int32) != hb).sum())
                        err = float(np.max(np.abs(
                            kb.astype(np.float64) - host.astype(np.float64)),
                            initial=0.0))
                        st = stats[name]
                        st["cases"] += 1
                        st["mismatches"] += bad
                        st["max_abs_err"] = max(st["max_abs_err"], err)
                    slot_bad = int((sl.cpu() != psl.cpu()).sum())
                    host_slots = np.where(mask & (free >= request),
                                          free // request, 0)
                    slot_bad += int((sl.cpu().numpy() != host_slots).sum())
                    stats["slots"]["mismatches"] += slot_bad
    emit({"phase": "sweep", "sizes": SIZES, "weight_sets": list(weight_sets),
          "stats": stats, "seconds": time.perf_counter() - t0})
    for name, st in stats.items():
        check(st["mismatches"] == 0,
              f"{name} kernel disagrees with its plain version: {st}")

    # -- 4. main path: §5.1 through Simulator.run -------------------------
    def run_51(device, backend="kernel"):
        topo = core.training_cluster_topology(8000)
        state = core.ClusterState.create(topo)
        rsch = core.RSCH(topo, core.RSCHConfig(device=device,
                                               score_backend=backend))
        qsch = core.QSCH(core.QuotaManager({"t0": {0: 10 ** 6}}), rsch,
                         core.QSCHConfig(policy=core.QueuePolicy.BACKFILL))
        sim = core.Simulator(state, qsch, core.SimConfig())
        jobs = core.training_trace(1000, seed=0, arrival_rate_per_hour=300)
        t = time.perf_counter()
        res = sim.run(jobs)
        return res, time.perf_counter() - t

    run_51(None)                        # warm the CUDA context and numpy
    node_score.node_scores.launches = 0
    node_score.node_scores_slots.launches = 0
    res_gpu, wall_gpu = run_51(None)
    main_launches = {"node_scores": node_score.node_scores.launches,
                     "node_scores_slots": node_score.node_scores_slots.launches}
    res_cpu, wall_cpu = run_51("cpu")
    res_np, wall_np = run_51(None, backend="np")
    rep_gpu = res_gpu.metrics.report()
    for name, res in (("cpu", res_cpu), ("np", res_np)):
        check(placement_key(res_gpu.jobs) == placement_key(res.jobs),
              f"§5.1 placements differ between cuda and {name}")
        check(rep_gpu == res.metrics.report(),
              f"§5.1 metric reports differ between cuda and {name}")
        check(res_gpu.cycles == res.cycles, f"§5.1 cycles differ ({name})")
    check(main_launches["node_scores_slots"] > 0,
          "§5.1 main path never launched the score+slots kernel")
    placed = sum(j.placement is not None for j in res_gpu.jobs)
    check(placed == len(res_gpu.jobs), "§5.1 left jobs unplaced")
    emit({"phase": "main", "cluster": "training_cluster_topology(8000)",
          "trace": "training_trace(1000, seed=0, arrival_rate_per_hour=300)",
          "gar": rep_gpu["median_gar"], "sor": rep_gpu["sor"],
          "gfr": rep_gpu["mean_gfr"], "jwtd_mean": rep_gpu["jwtd_mean"],
          "cycles": res_gpu.cycles, "wall_s_cuda": wall_gpu,
          "wall_s_cpu_plain_torch": wall_cpu, "wall_s_host_numpy": wall_np,
          "launches": main_launches, "placements_identical": True})

    # -- 4b. where the §5.1 cycle's time goes (separate, profiled runs) --
    import repro_torch.core.rsch as rsch_mod
    with CallRecorder(rsch_mod, "compute_node_scores_and_slots") as seam:
        _, wall_seam = run_51(None)
    busy = device_busy_ms(torch, lambda: run_51(None))
    busy_ms = busy["kernel_ms"] + busy["copy_ms"]
    emit({"phase": "main-breakdown", "wall_s": wall_seam,
          "seam_calls": seam.calls, "seam_s": seam.seconds,
          "seam_share": seam.seconds / wall_seam,
          "seam_us_per_call": seam.seconds / max(1, seam.calls) * 1e6,
          "device_kernel_ms": busy["kernel_ms"],
          "device_copy_ms": busy["copy_ms"],
          "device_busy_share": busy_ms / 1e3 / wall_seam if busy_ms else None})

    # -- 5. per-pod path at 10k nodes ----------------------------------
    job = core.Job(uid=1, tenant="bench", gpu_type=0, n_pods=GANG_PODS,
                   gpus_per_pod=GPUS_PER_POD, kind=core.JobKind.TRAIN)

    def picks(result):
        check(result.placement is not None, "gang must be placeable")
        return [(p.node, p.gpu_indices, p.nic)
                for p in result.placement.pods]

    state = fragmented_state(core, np, 10_000)
    snap = FullSnapshotter().take(state)
    batched = picks(core.RSCH(state.topology, core.RSCHConfig()).schedule(
        job, snap))
    node_score.node_scores.launches = 0
    t = time.perf_counter()
    per_pod = picks(core.RSCH(state.topology, core.RSCHConfig(
        batched_gang=False)).schedule(job, snap))
    per_pod_s = time.perf_counter() - t
    per_pod_launches = node_score.node_scores.launches
    check(per_pod == batched, "per-pod placements differ from batched")
    check(per_pod_launches > 0, "per-pod path never launched node_scores")
    emit({"phase": "per-pod", "nodes": 10_000, "launches": per_pod_launches,
          "cycle_ms": per_pod_s * 1e3, "placements_equal_batched": True})

    # -- 6. gang cycle at scale ----------------------------------------
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)  # 256 MB
    scale = []
    for n in SCALE_SIZES:
        state = fragmented_state(core, np, n)
        snap = FullSnapshotter().take(state)
        for subset in (True, False):
            def rsch(backend):
                return core.RSCH(state.topology, core.RSCHConfig(
                    score_backend=backend, subset_scoring=subset))
            kern, plain = rsch("kernel"), rsch("ref")
            with CallRecorder(ops, "node_scores_and_slots") as rec:
                want = picks(plain.schedule(job, snap))
                got = picks(kern.schedule(job, snap))
            check(got == want, f"kernel placement differs at {n} nodes")
            cols, kw = kernel_inputs(rec)
            n_scored = int(cols[0].shape[0])
            times = []
            for _ in range(7):
                t = time.perf_counter()
                kern.schedule(job, snap)
                times.append(time.perf_counter() - t)
            plain_times = []
            for _ in range(3):
                t = time.perf_counter()
                plain.schedule(job, snap)
                plain_times.append(time.perf_counter() - t)
            kcall = lambda: node_score.node_scores_slots(*cols, **kw)
            pcall = lambda: node_scores_slots_ref(*cols, **kw)
            bms, by = bound_ms(n_scored, 8)
            scale.append({
                "nodes": n, "subset_scoring": subset,
                "nodes_scored": n_scored,
                "cycle_ms": float(np.median(times)) * 1e3,
                "cycle_ms_plain": float(np.median(plain_times)) * 1e3,
                "kernel_ms": device_ms(torch, kcall, 50, flush),
                "wrapper_ms_back_to_back": device_ms(torch, kcall, 200),
                "plain_ms": device_ms(torch, pcall, 20, flush),
                "bound_ms": bms, "bound_by": by})
            emit({"phase": "scale", **scale[-1]})
            full_cols, full_kw = cols, kw

    # -- kernels line: timed at the 1M-node full-width pass ------------
    full = scale[-1]
    n1m = full["nodes_scored"]
    k_score = device_ms(
        torch, lambda: node_score.node_scores(*full_cols, **full_kw), 50,
        flush)
    p_score = device_ms(
        torch, lambda: node_scores_ref(*full_cols, **full_kw), 20, flush)
    b_score, by_score = bound_ms(n1m, 4)
    kernels = [
        {"name": "node_scores_slots", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/node_score.cu",
         "replaces": "src/repro/kernels/node_score.py:57",
         "launches": main_launches["node_scores_slots"],
         "launches_path": "§5.1 Simulator.run",
         "mismatches": stats["slots"]["mismatches"],
         "max_abs_err": stats["slots"]["max_abs_err"],
         "ms": full["kernel_ms"], "plain_ms": full["plain_ms"],
         "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
         "library_ms": None, "nodes": n1m},
        {"name": "node_scores", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/node_score.cu",
         "replaces": "src/repro/kernels/node_score.py:41",
         "launches": per_pod_launches,
         "launches_path": "per-pod gang cycle, 10k nodes",
         "mismatches": stats["score"]["mismatches"],
         "max_abs_err": stats["score"]["max_abs_err"],
         "ms": k_score, "plain_ms": p_score, "bound_ms": b_score,
         "bound_by": by_score, "library_ms": None, "nodes": n1m},
    ]
    print(json.dumps({"kernels": kernels,
                      "library_note": "no single PyTorch call computes the "
                                      "fused filter+score(+slots) pass"}),
          flush=True)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
