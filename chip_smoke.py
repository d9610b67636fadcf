#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main paths on one CUDA card — the scheduling cycle
(with cluster dynamics, tidal autoscaling and cycle pipelining), the
serving fabric, rwkv6-3b, glm4-9b, mixtral-8x7b (8 of 32 layers), hymba-1.5b,
seamless-m4t-large-v2 and llava-next-34b (16 of 60 layers) serving, and
rwkv6-3b training — and holds every kernel of those paths against its
plain torch version::

    python3 chip_smoke.py

Phases, each printed as one JSON line on stdout:

1. device  — ``nvidia-smi`` name and power limit;
2. build   — ``nvcc`` builds of ``kernels/csrc/node_score.cu`` and
             ``kernels/csrc/wkv6.cu`` for sm_90a, started together;
3. sweep   — both node-score kernels against the plain torch version on
             the card and the host numpy path, as int32 bit patterns, at
             sizes that include the edges of the vector path's group and
             block; then on columns and outputs that are views one
             element off 16-byte alignment (the kernel's scalar path);
4. main    — the paper's §5.1 run (1,000 nodes × 8 GPUs, 1,000-job
             training trace at 300 jobs/h, Backfill + E-Binpack) through
             ``Simulator.run`` on the card, with ``device="cpu"`` and with
             the host numpy backend: placements byte-identical, metric
             reports equal, launches > 0; then a timed and a profiled run
             split its time between the device seam and the rest, and
             count the seam's host-to-device and device-to-host copies;
5. per-pod — the per-pod path (``batched_gang=False``) at 10k nodes: it
             launches the score-only kernel, placements equal batched;
6. scale   — one 64-pod × 8-GPU gang cycle at 10k / 100k / 1M nodes with
             subset scoring on and off (off = full-width kernel sweep),
             beside the launch floor (an empty kernel on the same launch
             path);
6b. seam-time — the packed seam (one copy up, one down) against the
             per-column seam it replaced (five uploads, the kernel, two
             downloads; written inline here) and against itself with its
             cached views rebuilt on every call, in turns, at 33, 160,
             10k and 1M nodes: median host µs a call;
6c. tidal  — one simulated day of co-scheduling on the §5.1 cluster:
             8 tidal inference services (8-GPU replicas, 4–60 each, peak
             at 14 h, a decision every 900 s) over a 1,200-job
             preemptible training backlog of 8–128 GPUs, node failures
             (30-day MTBF, 30-minute repairs) and checkpoint-restart,
             seed 0, through ``Simulator.run`` on the card and with the
             host numpy backend: placements byte-identical, reports,
             dynamics summaries, demand logs, failures, interrupts and
             preemptions equal, launches > 0; both walls, the seam's
             calls and µs a call;
6d. pipeline — the §5.1 replay with ``pipelined_cycles=True`` on the
             card: placements and report equal to the unpipelined run,
             no speculation error, every speculation accounted for, and
             hits, misses, conflicts and score passes equal to a
             pipelined host numpy run;
6e. elastic — ``benchmarks/elastic_bench.py``'s gates rebuilt from
             the port: an ``ElasticManager`` with no ``ElasticSpec`` is the
             rigid path across 3 queue policies x 2 strategies (240-job
             trace, 512 GPUs); then elastic against rigid on 512 GPUs over
             22 h (100 fragmenting rigid jobs, 14 elastic 128-GPU gangs
             shrinkable to 64 and 32, node failures at a 6 h MTBF,
             checkpoints every 600 s): elastic wins goodput and P90 JWTD,
             reshape cost <= 10% of useful GPU-seconds.  Every run on the
             card and with the host numpy backend: placements, reports,
             samples, dynamics summaries, reshapes and plan-cache
             counters equal; launches > 0;
6f. federation — ``benchmarks/federation_bench.py``'s gates: a one-member
             federation equal to a plain ``Simulator`` (placements and raw
             samples) across the same matrix; spillover against static
             partitioning on three heterogeneous members (420 jobs, 10 h);
             then the acceptance scale, members of 10,000 / 8,000 /
             12,000 nodes under saturating big gangs for 1,800 s,
             standalone and federated, each timed: ms a cycle of both arms
             on the card and with numpy, their ratio (not gated), launches,
             seam calls and µs a call for each member.  Card and numpy
             equal in placements, routing stats and member reports;
6g. tuning — ``benchmarks/tuning_bench.py``'s gates: a no-op
             ``TuningManager`` leaves the run byte-identical across the
             matrix; the tuned stack (starvation escalator + hill climb
             over the ``qsch.`` handles) beats the four static profiles at
             1,024 GPUs; a second tuned run climbs over every handle, so
             score weights change mid-run and the kernel is launched with
             them (its param-change log equal to numpy's); the attached
             per-cycle ms at 10k nodes (not gated);
7. wkv-sweep    — the chunked WKV kernel against its plain version at
             the reference's test shapes, at T ∈ {1, 37, 513}, at the
             serve shape, at the chunk's edges (T = 15, 16, 17) and under
             strong decays (w = exp(-exp(x)), some exactly 0 and 1) at
             T ∈ {1, 15, 16, 17, 37, 513}, with f32, bf16 and mixed stream
             types; beside each kernel error, the error of the plain
             mirror of its algorithm (``wkv6_chunked_ref``), so that a
             kernel fault and an algorithm fault are told apart;
7b. wkv-time    — the chunked kernels and the serial step kernel they
             replaced, in turns (step, chunked, chunked, step), at
             (1, T, 40, 64) f32 for T ∈ {64, 445, 512, 2048, 4096}, each
             beside its bytes bound; then the chunked pair's device time
             split between its two kernels (torch.profiler) at the serve
             shape, and one head alone at T = 4096 against forty (a chunk
             step that costs the same is bound by latency, not by the
             card's throughput);
8. serve        — rwkv6-3b at full width (f32, seeded weights) behind a
             ``ServeEngine(batch_size=4)``: 8 requests of 64–512 prompt
             tokens, 16 new tokens each; the WKV kernel runs once per
             layer per prefill; then a profiled prefill and decode step
             split their wall time into device busy time and the rest;
9. serve-parity — solo prefills of the first two prompts with the WKV
             kernel and with the plain step loop: logits, states and
             greedy tokens agree;
9b. fabric — a ``ReplicaPool`` of rwkv6-3b and hymba-1.5b (FULL
             configs, 4 slots) routes ``request_trace(2000, seed=0)``
             through each built-in router (the same metrics when routed
             again); ``Replica.build_engine`` materialises both on the
             card (seeded f32 weights drawn there, ``max_seq=1024``) and
             serves the first 8 requests round-robin sent each
             (``to_engine_request(max_prompt=512, max_new=16)``): batched
             tokens equal solo (B=1) runs, the WKV kernel once per layer
             per prefill; then the pool at the token rates just measured
             feeds ``demand_service`` into a ``TidalAutoscaler`` over
             8,000 GPUs for the trace's span, on the card and with numpy:
             placements identical, the fleet reaches the peak target;
10. dense-serve — glm4-9b at full width (f32, seeded weights drawn on
             the card, 9.4e9 parameters) behind a ``ServeEngine(
             batch_size=4, max_seq=1024)``: the same 8 prompt lengths and
             16 new tokens each; the dense path has no hand-written
             kernel (attention, RoPE and the MLP are plain torch), so its
             launch counts read 0;
11. dense-breakdown — a profiled prefill and decode step: device busy
             against wall time, and the device time of the weight GEMMs
             (``aten::mm``) against attention's score and value products
             (``aten::bmm``) and the rest;
12. dense-parity — prefill of 64 tokens and decode of 32 more against
             ``forward`` on all 96 (1e-3 of max|logit|); each batched
             request's greedy tokens against its solo (B=1) run; and a
             2-layer cut at full width on the card against the same
             weights on the host (prefill logits 1e-4 of their max,
             greedy tokens equal);
13. moe-serve — mixtral-8x7b at full width cut to 8 of its 32 layers
             (``mixtral-8x7b-l8``: 11.87e9 parameters, 47.5 GB in f32,
             drawn on the card after glm4-9b is freed), the same 8
             requests and engine; beside the dense phase's numbers, the
             assignments the prefills dropped at capacity factor 1.25
             (by layer) and a decode step's bytes bound;
14. moe-breakdown — a profiled prefill and decode step: device busy
             against wall time, the expert SwiGLU's device ms (inside
             ``moe.experts``: its ``bmm``), the rest of ``moe_ffn``
             (dispatch: router, sort, cumsum, gathers, one-hot, combine),
             the weight GEMMs outside it (``aten::mm``), attention's
             products (``aten::bmm``) and the rest;
15. moe-parity — the dense-parity checks on the cut, decode against
             forward at capacity factor E/k (4.0: nothing drops, so the
             identity holds) and batched against solo at the config's
             1.25, with a 1-layer cut on the host (6.9 GB); then the same
             three on the llama4-maverick smoke config (top-1 routing);
16. hybrid-serve — hymba-1.5b FULL (1,314,257,600 parameters, 5.3 GB in
             f32, not cut), the same 8 requests and engine;
17. hybrid-breakdown — a profiled prefill and decode step as in 11,
             with the device ms inside ``hymba.selective_scan`` (the
             loop over t) and ``hymba.ssm_step``, and the scan loop's
             share of an unprofiled prefill's wall time (the card
             synchronised around each layer's loop);
18. hybrid-parity — the dense-parity checks, with a 2-layer cut on the
             host.  The moe and hybrid paths run no hand-written kernel
             (the reference's are plain ``jnp``), so their launch counts
             read 0;
19. encdec-serve — seamless-m4t-large-v2 FULL (24 encoder and 24
             decoder layers, 2,034,784,256 parameters, 8.1 GB in f32, not
             cut), the same 8 requests and engine (``max_seq=1024``, so
             1,024 encoder frames a prefill); beside the serve numbers, a
             profiled prefill and decode step with the device ms of the
             encoder (``Model._encode``), of the memory's K/V
             (``memory_kv``) and of ``cross_attention``;
20. encdec-parity — the dense-parity checks, with a cut of 2 encoder and
             2 decoder layers at full width on the host;
21. vlm-serve — llava-next-34b at full width cut to 16 of 60 layers
             (``llava-next-34b-l16``: 9,843,219,456 parameters, 39.4 GB),
             each prompt behind its 576-patch prefix, ``max_seq=2048``;
             a profiled prefill and decode step;
22. vlm-parity — the dense-parity checks, with a 1-layer cut on the host;
23. train       — rwkv6-3b FULL trained through ``TrainState``: 4 AdamW
             steps (remat, B=4, seq 256, synthetic sticky-bigram data,
             f32 weights, gradients and moments; the first a warm-up),
             losses and grad norms finite, step seconds, tokens/s, peak
             memory and the FLOP bound 8·N·D; no WKV kernel launch (the
             step differentiates the plain scan); a fifth step profiled
             for the device busy share;
24. train-parity — one step of a 2-layer full-width cut (B=2, seq 64) on
             the card against the host from the same weights and batch:
             loss and grad norm at rtol 1e-5, each gradient leaf within
             1e-4 of its max|g|, the parameter delta within 1e-5 where
             |g| > 1e-5 (below it the first step is sign-like, ±lr: those
             elements are counted and held to 2·lr).  The encdec, vlm and
             train paths run no hand-written kernel.

Then the ``{"kernels": [...]}`` line (the node-score rows also carry
each kernel's own device duration from a ``torch.profiler`` trace), the
``nvidia-smi`` line, and as the last line ``{"ok": true, "device": {...}}``.  Any failed check raises and
the script exits non-zero without that line.  Without a CUDA device it
exits 2 before doing anything.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
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
# The vector path's group (4 nodes), the seam's padding (16) and the
# nodes a block of the vector path covers (1,024), on either side.
EDGE_SIZES = (3, 4, 5, 15, 16, 17, 4095, 4096, 4097)
UNALIGNED_SIZES = (1, 5, 17, 4097, 8193)
SEAM_SIZES = (33, 160, 10_000, 1_000_000)
SEAM_CALLS = {33: 300, 160: 300, 10_000: 100, 1_000_000: 10}
SCALE_SIZES = (10_000, 100_000, 1_000_000)
GANG_PODS, GPUS_PER_POD = 64, 8
DEVICE = "cuda"
# WKV-6: the reference's kernel-test shapes (tests/test_kernels.py), long
# sequences at the model's head size, and the serve shape (B=1 prefill of
# a 512-token prompt, 40 heads of 64).
WKV_REF_SHAPES = ((1, 16, 1, 8), (2, 32, 3, 8), (2, 64, 2, 16), (3, 48, 5, 4))
WKV_LONG_SHAPES = ((2, 1, 4, 64), (2, 37, 4, 64), (2, 513, 4, 64))
WKV_SERVE_SHAPE = (1, 512, 40, 64)
WKV_EDGE_T = (15, 16, 17)            # the chunk's edges, C = 16
WKV_STRONG_T = (1, 15, 16, 17, 37, 513)
WKV_TIME_T = (64, 445, 512, 2048, 4096)
WKV_TOL_F32 = 1e-5      # the reference's own, f32 inputs
WKV_TOL_BF16 = 3e-2     # the reference's own, bf16 inputs
WKV_TOL_LONG = 1e-4     # max|Δ| / max|o_ref| at T = 513 and the serve shape
SERVE_ARCH = "rwkv6-3b"
SERVE_REQUESTS, SERVE_BATCH, SERVE_NEW = 8, 4, 16
PARITY_TOL = 1e-3       # kernel against plain scan, relative to max|x|
DENSE_ARCH = "glm4-9b"
DENSE_MAX_SEQ = 1024
DENSE_PREFIX, DENSE_SEQ = 64, 96     # decode against forward
DENSE_CUT_LAYERS = 2    # card against host at full width
DENSE_HOST_TOL = 1e-4   # card against host, relative to max|logit|
DENSE_HOST_STEPS = 8
MOE_ARCH = "mixtral-8x7b"
# 8 of 32 layers at full width: 47.5 GB of f32 weights.  The whole model
# is 186.8 GB in f32 (93.4 GB in bf16) and fits no card; 12 layers (70.7
# GB) leave too little beside the activations.
MOE_CUT_LAYERS = 8
MOE_HOST_LAYERS = 1     # card against host at full width: 6.9 GB on the host
MOE_TOP1_ARCH = "llama4-maverick-400b-a17b"   # its smoke config: top-1
HYBRID_ARCH = "hymba-1.5b"
HYBRID_HOST_LAYERS = 2
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_HOST_LAYERS = 2  # encoder and decoder layers of the host cut
VLM_ARCH = "llava-next-34b"
# 16 of 60 layers at full width: 39.4 GB of f32 weights.  The whole model
# is 137.6 GB in f32 and fits no card.  Each prompt carries the 576-patch
# prefix (the longest is 1,021 positions), so max_seq = 2048.
VLM_CUT_LAYERS = 16
VLM_MAX_SEQ = 2048
VLM_HOST_LAYERS = 1     # card against host at full width: 5.9 GB on the host
TRAIN_ARCH = "rwkv6-3b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 4, 256   # step 1 is the warm-up
TRAIN_HOST_LAYERS, TRAIN_HOST_BATCH, TRAIN_HOST_SEQ = 2, 2, 64
TRAIN_TOL_METRIC = 1e-5  # loss, aux, grad norm: rtol, card against host
TRAIN_TOL_GRAD = 1e-4    # of each gradient leaf's max|g|
TRAIN_TOL_DELTA = 1e-5   # parameter delta where |g_host| > TRAIN_SIGN_LIKE
TRAIN_SIGN_LIKE = 1e-5
# The co-scheduling day: training_cluster_topology(8000) (1,000 nodes x 8
# GPUs), 8 inference services of 8-GPU replicas riding one diurnal tide
# (4-60 replicas each, peak at 14 h, a decision every 900 s) over a
# 1,200-job preemptible training backlog of 8-128 GPUs, node failures at
# a 30-day MTBF with 30-minute repairs, checkpoint-restart every 600 s.
TIDAL_SERVICES, TIDAL_MIN, TIDAL_MAX = 8, 4, 60
TIDAL_JOBS = 1200
TIDAL_SIZES = (8, 16, 32, 64, 128)
TIDAL_SIZE_PROBS = (.3, .25, .2, .15, .1)
TIDAL_MTBF_S, TIDAL_REPAIR_S = 30 * 86_400.0, 1800.0
# Elastic training, federation and self-tuning (phases 6e-6g): the
# reference benchmarks' own scenarios and scales, seed 0.
BENCH_SEED = 0
ELASTIC_GPUS = 512
ELASTIC_HORIZON_S = 22 * 3600.0
FED_TENANT_REGIONS = {"tA": "r0", "tB": "r0", "tC": "r1", "tD": "r2"}
FED_SCALE = 250                 # members of 10,000 / 8,000 / 12,000 nodes
FED_HORIZON_S = 1800.0
TUNING_PERIOD_S = 1800.0
TUNING_IDENTITY_GPUS = 512
TUNING_GPUS = 1024
TUNING_STATIC = ("E_BINPACK", "BINPACK", "E_SPREAD", "SPREAD")
TUNING_METRIC_SENSE = {"gar": +1, "gfr": -1, "p90_wait": -1, "p99_wait": -1,
                       "goodput": +1}
TUNING_METRIC_TOL = {"gar": (0.05, 0.02), "gfr": (0.05, 0.02),
                     "p90_wait": (0.10, 120.0), "p99_wait": (0.10, 120.0),
                     "goodput": (0.02, 0.0)}
TUNING_OVERHEAD_NODES, TUNING_OVERHEAD_REPEATS = 10_000, 30
# The all-handle climb's seed: its arms are ~40 (handle, direction) pairs,
# and seeds 0 and 1 probe only inference and best-effort weights, which a
# training trace never scores with; seed 3 probes training weights from
# the first control period on.
TUNING_CLIMB_SEED = 3
WEIGHT_FIELDS = (".used", ".fit", ".group", ".topo")
# The serving fabric: a pool of these FULL-config replicas, 4 slots each,
# behind each built-in router; the first FABRIC_SERVED requests the
# round-robin router sent to each replica served on the card.
FABRIC_ARCHS = ("rwkv6-3b", "hymba-1.5b")
FABRIC_ROUTERS = ("RoundRobinRouter", "LeastLoadedRouter",
                  "CapabilityCostRouter")
FABRIC_REQUESTS, FABRIC_SERVED = 2000, 8
FABRIC_MAX_SEQ, FABRIC_MAX_PROMPT, FABRIC_MAX_NEW = 1024, 512, 16
FABRIC_GPUS_PER_REPLICA, FABRIC_MAX_REPLICAS = 8, 60


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def free_memory(torch) -> None:
    """Return what the last phase dropped to the card: collect unreachable
    cycles first, so that the next phase's peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()


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


def device_ms(torch, fn, iters: int, flush=None, times=None) -> float:
    """Mean device ms of ``fn`` from CUDA events.  With ``flush`` (a
    buffer larger than L2), each launch is timed alone after the buffer
    is rewritten, so the inputs come from HBM, as after a fresh upload;
    each launch's ms is then also appended to ``times`` if given."""
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
        if times is not None:
            times.append(start.elapsed_time(end))
    return total / iters


def median(xs) -> float:
    return sorted(xs)[len(xs) // 2]


def profiled_kernel_ms(torch, fn, flush, kernel: str, iters: int = 20
                       ) -> float:
    """Mean device duration of the kernel named ``kernel`` that ``fn``
    launches, from the ``torch.profiler`` trace of ``iters`` calls, each
    after ``flush`` is rewritten: the kernel's own time on the card, with
    no launch or event overhead in it.  Three rewrites of ``flush`` alone
    open the window.  Call it before the serving phases: after their
    large traces, a short trace has lost up to ten of its first launches
    (and a 10 ms spin on the card ahead of them did not help: the loss
    counts launches, not time)."""
    def run():
        for _ in range(3):
            flush.add_(1)
        torch.cuda.synchronize()
        for _ in range(iters):
            flush.add_(1)
            fn()
    top = device_busy_ms(torch, run)["top"]
    hits = [e for e in top if kernel in e["name"]]
    check(len(hits) == 1 and hits[0]["count"] == iters,
          f"no single {kernel} entry of {iters} launches in {top}")
    return hits[0]["ms"] / iters


def unaligned(torch, t):
    """A copy of ``t`` that is a view one element past the start of its
    buffer: contiguous, but not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].copy_(t)


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
    """The recorded ops call as (device columns, wrapper keywords); the
    columns are cloned out of the seam's buffers, which the next pass
    overwrites."""
    from repro_torch.kernels import ops
    args, kw = rec.last
    w = kw["weights"]
    return tuple(c.clone() for c in ops._columns(*args)), dict(
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


def device_busy_ms(torch, run, ranges=()) -> dict:
    """Device time by kind over ``run()`` from ``torch.profiler``:
    kernels vs memory copies, in ms (0 where the trace has no device
    events), the five device entries that took longest, the number of
    host-to-device and device-to-host copies, and ``ops``: the device
    ms of the kernels each host op (``aten::mm``, ...) launched itself,
    and ``launches``: the number of kernels (copies not counted).

    ``ranges``: (module, function name) pairs, each wrapped in a
    ``record_function`` of its name for the run.  Each kernel then
    belongs to the innermost range around the op that launched it:
    ``ranges`` in the result gives each range's device ms and host ms,
    ``outside`` the device ms by op of the kernels outside them all."""
    from torch.profiler import ProfilerActivity, profile, record_function
    labels = {name for _, name in ranges}

    def in_range(fn, name):
        def wrapped(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return wrapped

    origs = [(mod, name, getattr(mod, name)) for mod, name in ranges]
    for mod, name, fn in origs:
        setattr(mod, name, in_range(fn, name))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        for mod, name, fn in origs:
            setattr(mod, name, fn)
    kernel = copy = 0.0
    launches = 0
    entries = []
    copies = {"HtoD": 0, "DtoH": 0}
    ops = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if "CUDA" not in str(e.device_type):
            if us > 0:
                ops[e.key] = us / 1e3
            continue
        if e.key in labels:          # a range's span on the device
            continue
        entries.append((us / 1e3, e.count, e.key[:80]))
        for way in copies:
            if "memcpy" in e.key.lower() and way in e.key:
                copies[way] += e.count
        if "memcpy" in e.key.lower() or "memset" in e.key.lower():
            copy += us / 1e3
        else:
            kernel += us / 1e3
            launches += e.count
    top = [{"name": k, "ms": ms, "count": n}
           for ms, n, k in sorted(entries, reverse=True)[:5]]
    out = {"kernel_ms": kernel, "copy_ms": copy, "launches": launches,
           "top": top, "copies": copies, "ops": ops}
    if ranges:
        spans = {name: {"device_ms": 0.0, "host_ms": 0.0, "calls": 0}
                 for name in labels}
        outside = {}
        for e in prof.events():
            if "CUDA" in str(e.device_type):
                continue
            if e.name in labels:
                spans[e.name]["host_ms"] += e.cpu_time_total / 1e3
                spans[e.name]["calls"] += 1
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us <= 0:
                continue
            owner = e
            while owner is not None and owner.name not in labels:
                owner = owner.cpu_parent
            if owner is None:
                outside[e.name] = outside.get(e.name, 0.0) + us / 1e3
            else:
                spans[owner.name]["device_ms"] += us / 1e3
        out.update(ranges=spans, outside=outside)
    return out


def device_totals(torch, run) -> dict:
    """Device ms of the kernels and copies ``run()`` launches, from a
    trace of CUDA activity alone read event by event: for a window of
    hundreds of thousands of launches (a train step), where
    ``device_busy_ms``'s parse into host-op trees takes minutes.  The
    five kernels that took longest, and ``gemm_ms``: the kernels whose
    name says GEMM."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernel = copy = gemm = 0.0
    launches = 0
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        name, ms = e.name(), e.duration_ns() / 1e6
        if "memcpy" in name.lower() or "memset" in name.lower():
            copy += ms
            continue
        kernel += ms
        launches += 1
        if "gemm" in name.lower():
            gemm += ms
        entry = by_name.setdefault(name[:80], [0.0, 0])
        entry[0] += ms
        entry[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"kernel_ms": kernel, "copy_ms": copy, "launches": launches,
            "gemm_ms": gemm,
            "top": [{"name": k, "ms": ms, "count": n} for k, (ms, n) in top]}


def wkv_inputs(np, torch, shape, types, seed: int = 0, strong=False):
    """WKV inputs on the card in the distributions of the reference's
    kernel tests: r, k, v ~ N(0, 1)/2, w = sigmoid(N(0, 1)), u ~ N/2,
    s0 ~ N/10; the streams cast to ``types``.  With ``strong``, decays
    w = exp(-exp(x)), x ~ 2·N(0, 1) + 1, 5% exactly 0.0 and 5% 1.0."""
    B, T, H, n = shape
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, n)) * 0.5 for _ in range(3))
    if strong:
        w = np.exp(-np.exp(2.0 * rng.standard_normal((B, T, H, n)) + 1.0))
        pick = rng.random((B, T, H, n))
        w[pick < 0.05] = 0.0
        w[pick > 0.95] = 1.0
    else:
        w = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, H, n))))
    u = rng.standard_normal((H, n)) * 0.5
    s0 = rng.standard_normal((B, H, n, n)) * 0.1

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(DEVICE).to(dtype)
    return (*(dev(a, t) for a, t in zip((r, k, v, w), types)), dev(u),
            dev(s0))


def wkv_bound_ms(shape, stream_bytes: int) -> tuple:
    """Least time for one WKV pass: each input read once (four streams,
    u, s0) and each output written once (o, S_T) over the HBM rate, vs
    B·T·H·(4n² + 3n) f32 operations over the f32 peak."""
    B, T, H, n = shape
    nbytes = B * T * H * n * (stream_bytes + 4) + H * n * 4 \
        + 2 * B * H * n * n * 4
    ops = B * T * H * (4 * n * n + 3 * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ptxas_summary(log: str) -> list:
    """Per kernel entry in a ``ptxas -v`` log: its (mangled) name and the
    lines that give registers, shared memory, stack and spills."""
    out = []
    for part in log.split("Compiling entry function")[1:]:
        name = part.split("'")[1] if "'" in part else part[:80]
        info = [ln.split("info    :")[-1].strip() for ln in part.splitlines()
                if "registers" in ln or "spill" in ln]
        out.append({"entry": name, "info": info})
    return out


def timed(torch, fn, log):
    """``fn`` with a synchronised wall clock around each call; appends
    (seconds, logits finite, logits) to ``log``."""
    def wrapped(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = fn(*args)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t,
                    bool(torch.isfinite(logits).all()), logits))
        return logits, cache
    return wrapped


def serve_run(torch, cfg, params, dev, reqs, timings=None, batch_size=4,
              max_seq=1024):
    """Serve ``reqs`` ((prompt, new tokens) pairs) through a fresh
    ``ServeEngine``; with ``timings`` its prefill and decode calls are
    timed into ``timings["_prefill"]`` and ``["_decode"]``.  Returns
    (engine, finished requests, wall seconds)."""
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, params, batch_size=batch_size, max_seq=max_seq,
                      device=dev)
    if timings is not None:
        for name in ("_prefill", "_decode"):
            setattr(eng, name, timed(torch, getattr(eng, name),
                                     timings[name]))
    for uid, (prompt, new) in enumerate(reqs):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new))
    t = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    return eng, done, time.perf_counter() - t


def serve_prompts(np, vocab: int, n: int):
    """The serve phases' prompts: ``n`` of 64-512 tokens from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, size=n)
    return lens, [rng.integers(0, vocab, size=int(k)).astype(np.int32)
                  for k in lens]


def top2_gap(logits) -> float:
    top = logits.float().topk(2).values
    return float(top[0] - top[1])


def rel_err(a, b) -> float:
    """max|a - b| / max|b| (0 when b is all zero)."""
    den = float(b.abs().max())
    return float((a - b).abs().max()) / den if den else 0.0


def frontend_inputs(cfg, batch: int, seq_len: int) -> dict:
    """The family's stub embeddings for a batch of ``batch`` (host
    tensors, as the engine draws them): vlm patches, or encdec frames
    for ``seq_len`` (``seq_len // enc_seq_divisor`` of them)."""
    from repro_torch.models import frontend
    if cfg.family == "vlm":
        return {"patch_embeds": frontend.patch_embeds(cfg, batch)}
    if cfg.family == "encdec":
        return {"enc_embeds": frontend.frame_embeds(cfg, batch, seq_len)}
    return {}


def decode_read_bytes(params) -> int:
    """Weight bytes a decode step reads: every parameter but the
    embedding table (it gathers B rows), the encoder and its norm (their
    work is the prefill's) and the cross-attention's K/V projections (the
    memory's K/V are cached)."""
    def read(name):
        return not (name == "embed" or name.startswith("encoder.")
                    or name == "enc_norm"
                    or name.endswith(("xattn.wk", "xattn.wv")))
    return sum(t.numel() * t.element_size() for k, t in params.items()
               if read(k))


def serve_cell(torch, np, dev, cfg, counters, record=None,
               max_seq=DENSE_MAX_SEQ):
    """A decoder family's ``-serve`` phase: ``cfg``'s weights drawn on the
    card (f32, seed 0), a warm-up, then the 8 requests through a
    ``ServeEngine(batch_size=4, max_seq=max_seq)`` with every prefill and
    decode call timed; ``record`` (a context manager) is entered around
    that run.  Returns (the phase line, what the later phases use)."""
    import contextlib
    from repro_torch.models import Model

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0), torch.float32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = model.state_dict()
    n_params = model.n_params()
    # ArchConfig.n_params() is the reference's estimate; it is exact for
    # dense, moe and vlm, leaves out enc_norm for encdec, and is off for
    # hybrid (ROADMAP queue 3).
    expect = cfg.n_params() + (cfg.d_model if cfg.n_enc_layers else 0)
    check(cfg.family == "hybrid" or n_params == expect,
          f"{cfg.name}: {n_params} parameters, the config says "
          f"{cfg.n_params()}")
    lens, prompts = serve_prompts(np, cfg.vocab, SERVE_REQUESTS)

    def engine_run(reqs, timings=None, batch_size=SERVE_BATCH):
        return serve_run(torch, cfg, params, dev, reqs, timings,
                         batch_size=batch_size, max_seq=max_seq)

    engine_run([(prompts[0][:64], 2), (prompts[1][:64], 2)])   # warm-up
    timings = {"_prefill": [], "_decode": []}
    for c in counters:
        c.launches = 0
    with record or contextlib.nullcontext():
        engine, finished, wall = engine_run(
            [(p, SERVE_NEW) for p in prompts], timings)
    launches = {c.__name__: c.launches for c in counters}
    check(len(finished) == SERVE_REQUESTS
          and all(len(r.generated) == SERVE_NEW for r in finished),
          f"{cfg.name} serve left requests unfinished")
    check(all(ok for log in timings.values() for _, ok, _ in log),
          f"{cfg.name} serve produced non-finite logits")
    pre_s = [t for t, _, _ in timings["_prefill"]]
    dec_s = [t for t, _, _ in timings["_decode"]]
    dec_ms = np.asarray(dec_s) * 1e3
    longest = int(np.argmax(lens))
    param_bytes = sum(t.numel() * t.element_size() for t in params.values())
    step_bytes = decode_read_bytes(params)
    # What it reads of the cache: the ring (and the encdec memory), once.
    cache_bytes = sum(t.numel() * t.element_size()
                      for part in ("layers", "memory")
                      for t in engine.cache.get(part, {}).values())
    line = {"arch": cfg.name, "family": cfg.family, "dtype": "float32",
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
            "params": n_params, "param_bytes": param_bytes,
            "init_s": init_s, "requests": len(finished),
            "max_seq": max_seq,
            "cache_window": engine.model.cache_window(max_seq),
            "prompt_tokens": int(lens.sum()),
            "prompt_lens": [int(n) for n in lens],
            "prefill_calls": engine.prefill_calls,
            "prefill_ms_per_request": float(np.mean(pre_s)) * 1e3,
            "prefill_ms": [t * 1e3 for t in pre_s],
            "prefill_tokens_per_s": float(lens.sum()) / sum(pre_s),
            "first_prompt": {"len": int(lens[0]), "ms": pre_s[0] * 1e3},
            "longest_prompt": {"len": int(lens[longest]),
                               "ms": pre_s[longest] * 1e3},
            "decode_steps": len(dec_s), "decode_batch": SERVE_BATCH,
            "decode_ms_per_step_median": float(np.median(dec_ms)),
            "decode_ms_per_step_mean": float(np.mean(dec_ms)),
            "decode_ms_per_step_min_q1_q3_max": [
                float(np.min(dec_ms)), float(np.percentile(dec_ms, 25)),
                float(np.percentile(dec_ms, 75)), float(np.max(dec_ms))],
            "decode_bytes": step_bytes,
            "decode_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
            "decode_cache_bytes": cache_bytes,
            "decode_bound_with_cache_ms":
                (step_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3,
            "wall_s": wall, "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if cfg.family == "vlm":
        positions = int(lens.sum()) + cfg.n_prefix * len(lens)
        line.update(prefix_tokens=cfg.n_prefix, prefill_positions=positions,
                    prefill_positions_per_s=positions / sum(pre_s))
    if cfg.family == "encdec":
        line.update(encoder_frames=max_seq * 4 // cfg.enc_seq_divisor)
    return line, {"engine": engine, "finished": finished, "model": model,
                  "params": params, "lens": lens, "prompts": prompts,
                  "pre_s": pre_s, "dec_s": dec_s, "engine_run": engine_run,
                  "max_seq": max_seq}


def served_parity(torch, np, cell, forward_cfg) -> dict:
    """Prefill of 64 tokens and decode of 32 more against ``forward`` on
    all 96, by a model of ``forward_cfg`` on the served weights (1e-3 of
    max|logit|); then each batched request's greedy tokens against its
    solo (B=1) run (equal, or a top-2 gap < 1e-3 of max|logit| where
    they part)."""
    from repro_torch.models import Model
    m = Model(forward_cfg, device=cell["engine"].device)
    m.load_state_dict(cell["params"], assign=True)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, forward_cfg.vocab, size=(1, DENSE_SEQ)).astype(np.int32))
    # The served memory's length (encdec) and patch prefix (vlm).
    extra = frontend_inputs(forward_cfg, 1, cell["max_seq"] * 4)
    with torch.no_grad():
        full, _ = m({"tokens": toks, **extra})
    scale = float(full.abs().max())
    lg, cache = m.prefill({"tokens": toks[:, :DENSE_PREFIX], **extra},
                          seq_len=DENSE_SEQ + forward_cfg.n_prefix)
    errs = [float((lg - full[:, DENSE_PREFIX - 1]).abs().max())]
    for i in range(DENSE_PREFIX, DENSE_SEQ):
        lg, cache = m.decode_step(cache, toks[:, i])
        errs.append(float((lg - full[:, i]).abs().max()))
    decode_rel = max(errs) / scale
    check(decode_rel <= PARITY_TOL,
          f"{forward_cfg.name} prefill+decode differs from forward by "
          f"{decode_rel} of max|logit|")
    del full, cache, lg, m

    batched = {r.uid: r.generated for r in cell["finished"]}
    slots = []
    for uid, prompt in enumerate(cell["prompts"]):
        log = {"_prefill": [], "_decode": []}
        _, [solo], _ = cell["engine_run"]([(prompt, SERVE_NEW)], log,
                                          batch_size=1)
        diff = next((j for j, (a, b) in enumerate(zip(solo.generated,
                                                      batched[uid]))
                     if a != b), None)
        gap = None
        if diff is not None:
            logits = [lgt for _, _, lgt in log["_prefill"] + log["_decode"]]
            lgt = logits[diff][0]
            gap = top2_gap(lgt) / float(lgt.abs().max())
            check(gap < PARITY_TOL,
                  f"request {uid}: batched and solo tokens differ at step "
                  f"{diff} with a top-2 gap of {gap} of max|logit|")
        slots.append({"uid": uid, "tokens_equal": diff is None,
                      "first_diff_step": diff, "solo_top2_gap_rel": gap})
    factor = ({"capacity_factor": forward_cfg.capacity_factor}
              if forward_cfg.family == "moe" else {})
    return {"decode_vs_forward": {
                "prefix": DENSE_PREFIX, "seq": DENSE_SEQ, **factor,
                "max_abs_err": max(errs), "max_abs_logit": scale,
                "rel": decode_rel},
            "slot_independence": slots}


def card_vs_host(torch, np, dev, cut, prompt) -> dict:
    """``cut`` drawn on the card (seed 1) and copied to the host: prefill
    logits within 1e-4 of their max, and 8 greedy tokens equal."""
    from repro_torch.models import Model
    card = Model(cut, device=dev).init(
        torch.Generator(device=dev).manual_seed(1), torch.float32)
    host = Model(cut, device="cpu")
    host.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()},
                         assign=True)
    batch = {"tokens": torch.from_numpy(prompt[None, :DENSE_PREFIX]),
             **frontend_inputs(cut, 1, DENSE_SEQ * 4)}
    t = time.perf_counter()
    lc, cc = card.prefill(batch, seq_len=DENSE_SEQ + cut.n_prefix)
    lh, ch = host.prefill(batch, seq_len=DENSE_SEQ + cut.n_prefix)
    host_s = time.perf_counter() - t
    host_rel = rel_err(lc.cpu(), lh)
    check(host_rel <= DENSE_HOST_TOL,
          f"{cut.name} x{cut.n_layers} prefill on the card differs from "
          f"the host by {host_rel} of max|logit|")
    toks_c, toks_h = [], []
    for _ in range(DENSE_HOST_STEPS):
        toks_c.append(int(torch.argmax(lc[0])))
        toks_h.append(int(torch.argmax(lh[0])))
        lc, cc = card.decode_step(cc, torch.tensor([toks_c[-1]]))
        lh, ch = host.decode_step(ch, torch.tensor([toks_h[-1]]))
    check(toks_c == toks_h,
          f"{cut.name}: greedy tokens differ between card and host: "
          f"{toks_c} {toks_h}")
    return {"arch": cut.name, "layers": cut.n_layers,
            "enc_layers": cut.n_enc_layers, "d_model": cut.d_model,
            "vocab": cut.vocab, "params": host.n_params(),
            "prompt_len": DENSE_PREFIX, "logit_rel": host_rel,
            "tol": DENSE_HOST_TOL, "tokens": toks_c, "tokens_equal": True,
            "seconds": host_s}


def op_split(busy, wall_ms, inside=None) -> dict:
    """Device ms of a profiled pass: the weight GEMMs (``aten::mm``) and
    the batched products (``aten::bmm``) outside every named range, each
    named range's own device ms (``inside``: range -> key), and the
    rest."""
    ops = busy["outside"] if inside is not None else busy["ops"]
    gemm = sum(ms for k, ms in ops.items()
               if k in ("aten::mm", "aten::addmm"))
    bmm = ops.get("aten::bmm", 0.0)
    kernel = busy["kernel_ms"]
    named = {key: busy["ranges"][r]["device_ms"]
             for r, key in (inside or {}).items()}
    out = {"wall_ms": wall_ms, "kernel_ms": kernel,
           "copy_ms": busy["copy_ms"], "kernel_launches": busy["launches"],
           "busy_share": (kernel + busy["copy_ms"]) / wall_ms,
           "gemm_ms": gemm, "attention_products_ms": bmm, **named,
           "other_ms": kernel - gemm - bmm - sum(named.values()),
           "gemm_share": gemm / kernel if kernel else None,
           "attention_products_share": bmm / kernel if kernel else None,
           "top": busy["top"],
           "top_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:8]}
    for key, ms in named.items():
        out[key.replace("_ms", "_share")] = ms / kernel if kernel else None
    return out


def run_dense(torch, np, dev, cfg, counters, smi: str) -> None:
    """Phases 10-12: ``cfg`` (glm4-9b FULL) served, profiled and held
    against ``forward``, its solo runs and the host.  ``counters`` are
    the kernel wrappers, whose launches are read over the served run."""

    line, cell = serve_cell(torch, np, dev, cfg, counters)
    emit({"phase": "dense-serve", **line, "nvidia_smi": smi})

    # -- 11. dense-breakdown: one profiled prefill and decode step -------
    engine, prompts = cell["engine"], cell["prompts"]
    first = {"tokens": torch.from_numpy(prompts[0][None])}
    pre_busy = device_busy_ms(torch, lambda: engine.model.prefill(
        first, seq_len=DENSE_MAX_SEQ))
    dec_busy = device_busy_ms(torch, lambda: engine.model.decode_step(
        engine.cache, torch.zeros(SERVE_BATCH, dtype=torch.int32)))
    emit({"phase": "dense-breakdown",
          "prefill": {"prompt_len": len(prompts[0]),
                      **op_split(pre_busy, cell["pre_s"][0] * 1e3)},
          "decode": {"batch": SERVE_BATCH,
                     **op_split(dec_busy,
                                float(np.median(cell["dec_s"])) * 1e3)}})

    # -- 12. dense-parity --------------------------------------------------
    parity = served_parity(torch, np, cell, cfg)
    del engine, cell
    free_memory(torch)
    host = card_vs_host(torch, np, dev,
                        dataclasses.replace(cfg, n_layers=DENSE_CUT_LAYERS),
                        prompts[0])
    emit({"phase": "dense-parity", "tol": PARITY_TOL, **parity,
          "card_vs_host": host})


class RoutingRecorder:
    """While entered, keeps the expert ids of every prefill's routing
    (``moe.route`` with S > 1; device tensors, no synchronisation), so
    that the assignments dropped at capacity are counted afterwards."""

    def __init__(self, cfg) -> None:
        from repro_torch.models import moe
        self.moe, self.cfg = moe, cfg
        self.ids = []

    def __enter__(self):
        orig = self.orig = self.moe.route

        def route(p, x, top_k):
            out = orig(p, x, top_k)
            if x.shape[1] > 1:
                self.ids.append(out[2])
            return out
        self.moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig

    def dropped(self, torch) -> dict:
        """Assignments, and those past their expert's capacity in their
        row (GShard group), over the recorded prefills, by layer."""
        cfg, E = self.cfg, self.cfg.n_experts
        by_layer = [0] * cfg.n_layers
        total = 0
        for i, ids in enumerate(self.ids):
            B, S, k = ids.shape
            C = self.moe.capacity(S, E, k, cfg.capacity_factor)
            counts = torch.nn.functional.one_hot(
                ids.reshape(B, S * k), E).sum(dim=1)           # (B, E)
            by_layer[i % cfg.n_layers] += int(
                torch.clamp(counts - C, min=0).sum())
            total += ids.numel()
        return {"capacity_factor": cfg.capacity_factor,
                "prefill_calls": len(self.ids) // cfg.n_layers,
                "assignments": total, "dropped": sum(by_layer),
                "dropped_share": sum(by_layer) / total if total else None,
                "dropped_by_layer": by_layer}


def run_moe(torch, np, dev, cfg, top1_cfg, counters, smi: str) -> None:
    """Phases 13-15: ``cfg`` (mixtral-8x7b at full width, depth cut)
    served, profiled and held against ``forward`` at capacity factor
    E/k, its solo runs, and a 1-layer cut on the host; then the same
    three checks on ``top1_cfg`` (llama4-maverick smoke, top-1)."""
    from repro_torch.models import moe

    rec = RoutingRecorder(cfg)
    line, cell = serve_cell(torch, np, dev, cfg, counters, rec)
    drops = rec.dropped(torch)
    del rec
    emit({"phase": "moe-serve", **line,
          "experts": [cfg.n_experts, cfg.top_k],
          "capacity_factor": cfg.capacity_factor,
          "prefill_drops": drops, "nvidia_smi": smi})

    # -- 14. moe-breakdown: one profiled prefill and decode step ---------
    engine, prompts = cell["engine"], cell["prompts"]
    ranges = ((moe, "moe_ffn"), (moe, "experts"))
    inside = {"moe_ffn": "dispatch_ms", "experts": "experts_ms"}
    first = {"tokens": torch.from_numpy(prompts[0][None])}
    pre_busy = device_busy_ms(torch, lambda: engine.model.prefill(
        first, seq_len=DENSE_MAX_SEQ), ranges)
    dec_busy = device_busy_ms(torch, lambda: engine.model.decode_step(
        engine.cache, torch.zeros(SERVE_BATCH, dtype=torch.int32)), ranges)
    emit({"phase": "moe-breakdown",
          "note": "experts_ms: the expert SwiGLU (its bmm, silu, mul); "
                  "dispatch_ms: the rest of moe_ffn (router, sort, cumsum, "
                  "gathers, one-hot, combine); gemm_ms: aten::mm outside "
                  "moe_ffn (attention weights, LM head)",
          "prefill": {"prompt_len": len(prompts[0]),
                      "capacity": moe.capacity(len(prompts[0]),
                                               cfg.n_experts, cfg.top_k,
                                               cfg.capacity_factor),
                      **op_split(pre_busy, cell["pre_s"][0] * 1e3, inside)},
          "decode": {"batch": SERVE_BATCH,
                     "capacity": moe.capacity(1, cfg.n_experts, cfg.top_k,
                                              cfg.capacity_factor),
                     **op_split(dec_busy,
                                float(np.median(cell["dec_s"])) * 1e3,
                                inside)}})

    # -- 15. moe-parity ----------------------------------------------------
    # Decode equals forward only where nothing drops: at E/k, C >= S.
    no_drop = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    parity = served_parity(torch, np, cell, no_drop)
    del engine, cell
    free_memory(torch)
    host = card_vs_host(torch, np, dev,
                        dataclasses.replace(cfg, n_layers=MOE_HOST_LAYERS),
                        prompts[0])
    free_memory(torch)
    _, small = serve_cell(torch, np, dev, top1_cfg, counters)
    top1 = served_parity(torch, np, small, dataclasses.replace(
        top1_cfg, capacity_factor=top1_cfg.n_experts / top1_cfg.top_k))
    top1["card_vs_host"] = card_vs_host(torch, np, dev, top1_cfg,
                                        small["prompts"][0])
    del small
    emit({"phase": "moe-parity", "tol": PARITY_TOL, **parity,
          "card_vs_host": host,
          "top1": {"arch": top1_cfg.name,
                   "experts": [top1_cfg.n_experts, top1_cfg.top_k],
                   **top1}})


def run_hybrid(torch, np, dev, cfg, counters, smi: str) -> None:
    """Phases 16-18: ``cfg`` (hymba-1.5b FULL) served, profiled (the SSM
    scan loop's share of device and wall time) and held against
    ``forward``, its solo runs and a 2-layer cut on the host."""
    from repro_torch.models import hymba

    line, cell = serve_cell(torch, np, dev, cfg, counters)
    emit({"phase": "hybrid-serve", **line, "ssm_state": cfg.ssm_state,
          "nvidia_smi": smi})

    # -- 17. hybrid-breakdown ----------------------------------------------
    engine, prompts = cell["engine"], cell["prompts"]
    first = {"tokens": torch.from_numpy(prompts[0][None])}
    ranges = ((hymba, "selective_scan"), (hymba, "ssm_step"))
    inside = {"selective_scan": "scan_loop_ms", "ssm_step": "ssm_step_ms"}
    pre_busy = device_busy_ms(torch, lambda: engine.model.prefill(
        first, seq_len=DENSE_MAX_SEQ), ranges)
    dec_busy = device_busy_ms(torch, lambda: engine.model.decode_step(
        engine.cache, torch.zeros(SERVE_BATCH, dtype=torch.int32)), ranges)
    # The scan loop's share of a prefill's wall time, unprofiled: the
    # card synchronised around each layer's loop and around the prefill.
    scan_s = []
    orig = hymba.selective_scan

    def timed_scan(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*args)
        torch.cuda.synchronize()
        scan_s.append(time.perf_counter() - t)
        return out
    hymba.selective_scan = timed_scan
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.model.prefill(first, seq_len=DENSE_MAX_SEQ)
        torch.cuda.synchronize()
        synced_s = time.perf_counter() - t
    finally:
        hymba.selective_scan = orig
    check(len(scan_s) == cfg.n_layers,
          f"{len(scan_s)} scan loops in a {cfg.n_layers}-layer prefill")
    scan_host_ms = pre_busy["ranges"]["selective_scan"]["host_ms"]
    emit({"phase": "hybrid-breakdown",
          "note": "scan_loop_ms: device ms inside hymba.selective_scan (the "
                  "loop over t, its hoisted decay and input terms, and y); "
                  "ssm_step_ms: the decode step's SSM; gemm_ms: aten::mm "
                  "outside both",
          "prefill": {"prompt_len": len(prompts[0]),
                      "scan_steps": len(prompts[0]) * cfg.n_layers,
                      "scan_loop_host_ms_profiled": scan_host_ms,
                      "synced_prefill_ms": synced_s * 1e3,
                      "scan_loop_wall_ms": sum(scan_s) * 1e3,
                      "scan_loop_wall_share": sum(scan_s) / synced_s,
                      **op_split(pre_busy, cell["pre_s"][0] * 1e3, inside)},
          "decode": {"batch": SERVE_BATCH,
                     **op_split(dec_busy,
                                float(np.median(cell["dec_s"])) * 1e3,
                                inside)}})

    # -- 18. hybrid-parity -------------------------------------------------
    parity = served_parity(torch, np, cell, cfg)
    del engine, cell
    free_memory(torch)
    host = card_vs_host(torch, np, dev,
                        dataclasses.replace(cfg, n_layers=HYBRID_HOST_LAYERS),
                        prompts[0])
    emit({"phase": "hybrid-parity", "tol": PARITY_TOL, **parity,
          "card_vs_host": host})


def frontend_breakdown(torch, np, cell, ranges=(), inside=None) -> dict:
    """A profiled prefill of the first prompt and a decode step of the
    served batch: device busy against the unprofiled wall, split by op
    (``op_split``) and by the named ``ranges``."""
    engine, prompts = cell["engine"], cell["prompts"]
    first = engine._solo_batch(prompts[0])
    pre_busy = device_busy_ms(torch, lambda: engine.model.prefill(
        first, seq_len=cell["max_seq"]), ranges)
    dec_busy = device_busy_ms(torch, lambda: engine.model.decode_step(
        engine.cache, torch.zeros(SERVE_BATCH, dtype=torch.int32)), ranges)
    return {"prefill": {"prompt_len": len(prompts[0]),
                        **op_split(pre_busy, cell["pre_s"][0] * 1e3, inside)},
            "decode": {"batch": SERVE_BATCH,
                       **op_split(dec_busy,
                                  float(np.median(cell["dec_s"])) * 1e3,
                                  inside)}}


def run_encdec(torch, np, dev, cfg, counters, smi: str) -> None:
    """Phases 19-20: ``cfg`` (seamless-m4t-large-v2 FULL) served with
    ``max_seq`` encoder frames a prefill, profiled (the encoder, the
    memory K/V and the cross-attention apart) and held against
    ``forward``, its solo runs and a cut of 2 encoder and 2 decoder
    layers on the host."""
    from repro_torch.models import model as model_mod

    line, cell = serve_cell(torch, np, dev, cfg, counters)
    ranges = ((model_mod.Model, "_encode"), (model_mod, "memory_kv"),
              (model_mod, "cross_attention"))
    inside = {"_encode": "encoder_ms", "memory_kv": "memory_kv_ms",
              "cross_attention": "cross_attention_ms"}
    emit({"phase": "encdec-serve", **line,
          "enc_layers": cfg.n_enc_layers, "nvidia_smi": smi,
          "breakdown": frontend_breakdown(torch, np, cell, ranges, inside),
          "breakdown_note": "encoder_ms: device ms inside Model._encode (the "
                            "encoder stack and enc_norm); memory_kv_ms: the "
                            "decoder layers' K/V of the memory; "
                            "cross_attention_ms: its queries, attention and "
                            "output projection; gemm_ms: aten::mm outside "
                            "them"})
    parity = served_parity(torch, np, cell, cfg)
    prompt = cell["prompts"][0]
    del cell
    free_memory(torch)
    host = card_vs_host(torch, np, dev, dataclasses.replace(
        cfg, n_layers=ENCDEC_HOST_LAYERS, n_enc_layers=ENCDEC_HOST_LAYERS),
        prompt)
    emit({"phase": "encdec-parity", "tol": PARITY_TOL, **parity,
          "card_vs_host": host})


def run_vlm(torch, np, dev, cfg, counters, smi: str) -> None:
    """Phases 21-22: ``cfg`` (llava-next-34b at full width, depth cut)
    served behind its 576-patch prefix at ``max_seq`` 2048, profiled, and
    held against ``forward``, its solo runs and a 1-layer cut on the
    host."""
    line, cell = serve_cell(torch, np, dev, cfg, counters,
                            max_seq=VLM_MAX_SEQ)
    emit({"phase": "vlm-serve", **line, "nvidia_smi": smi,
          "breakdown": frontend_breakdown(torch, np, cell)})
    parity = served_parity(torch, np, cell, cfg)
    prompt = cell["prompts"][0]
    del cell
    free_memory(torch)
    host = card_vs_host(torch, np, dev,
                        dataclasses.replace(cfg, n_layers=VLM_HOST_LAYERS),
                        prompt)
    emit({"phase": "vlm-parity", "tol": PARITY_TOL, **parity,
          "card_vs_host": host})


def train_compare(torch, np, dev, cut, data) -> dict:
    """One AdamW step (remat on) of ``cut`` on the card and on the host
    from the same weights (drawn on the card, seed 1) and batch: loss,
    aux and grad norm (rtol), every gradient leaf (of its max|g|), and
    the parameter delta where the host's |g| exceeds ``TRAIN_SIGN_LIKE``;
    below it the first step is sign-like (±lr), and those elements are
    counted and held to 2·lr."""
    from repro_torch.models import Model
    from repro_torch.train import (AdamWConfig, adamw_init, loss_and_grads,
                                   make_train_step)
    card = Model(cut, device=dev, wkv_backend="scan").init(
        torch.Generator(device=dev).manual_seed(1), torch.float32)
    p0 = {k: t.cpu() for k, t in card.state_dict().items()}
    host = Model(cut, device="cpu", wkv_backend="scan")
    host.load_state_dict({k: t.clone() for k, t in p0.items()}, assign=True)
    batch = next(data)
    out = []
    for model in (card, host):
        t0 = time.perf_counter()
        grads = loss_and_grads(model, batch, remat=True)[3]
        grads = {k: g.cpu() for k, g in grads.items()}
        _, m = make_train_step(model, AdamWConfig(), remat=True)(
            adamw_init(dict(model.named_parameters())), batch)
        out.append(({k: float(v) for k, v in m.items()}, grads,
                    {k: t.detach().cpu() for k, t in
                     model.state_dict().items()},
                    time.perf_counter() - t0))
    (mc, gc, pc, card_s), (mh, gh, ph, host_s) = out
    metric_rel = {k: abs(mc[k] - mh[k]) / max(abs(mh[k]), 1e-30)
                  for k in mh}
    grad_rel = max(float((gc[k] - g).abs().max())
                   / max(float(g.abs().max()), 1e-30) for k, g in gh.items())
    lr = AdamWConfig().lr
    delta_err = small_err = 0.0
    small = total = 0
    for k, g in gh.items():
        diff = ((pc[k] - p0[k]) - (ph[k] - p0[k])).abs()
        big = g.abs() > TRAIN_SIGN_LIKE
        delta_err = max(delta_err, float(torch.where(big, diff, 0).max()))
        small_err = max(small_err, float(torch.where(big, 0, diff).max()))
        small += int((~big).sum())
        total += g.numel()
    check(all(r <= TRAIN_TOL_METRIC for r in metric_rel.values()),
          f"{cut.name} train step: card against host {metric_rel}")
    check(grad_rel <= TRAIN_TOL_GRAD,
          f"{cut.name} gradients: card against host {grad_rel} of max|g|")
    check(delta_err <= TRAIN_TOL_DELTA and small_err <= 2 * lr * (1 + 1e-5),
          f"{cut.name} parameter delta: {delta_err} (|g| > "
          f"{TRAIN_SIGN_LIKE}), {small_err} (sign-like, bound 2 lr)")
    return {"arch": cut.name, "layers": cut.n_layers,
            "d_model": cut.d_model, "params": host.n_params(),
            "batch": list(batch["tokens"].shape),
            "card": mc, "host": mh, "metric_rel": metric_rel,
            "grad_rel_max": grad_rel, "tol_grad": TRAIN_TOL_GRAD,
            "delta_abs_max": delta_err, "tol_delta": TRAIN_TOL_DELTA,
            "sign_like": {"threshold": TRAIN_SIGN_LIKE, "elements": small,
                          "share": small / total,
                          "delta_abs_max": small_err, "bound": 2 * lr},
            "card_s": card_s, "host_s": host_s}


def run_train(torch, np, dev, cfg, counters, smi: str) -> None:
    """Phases 23-24: ``cfg`` (rwkv6-3b FULL) trained 4 AdamW steps
    (remat, B=4, seq 256, f32 weights, gradients and moments) through
    ``TrainState``, a fifth step profiled; then one step of a 2-layer
    full-width cut on the card against the host."""
    from repro_torch.data import DataConfig, synthetic_batches
    from repro_torch.train import AdamWConfig, TrainState

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = TrainState(cfg, torch.Generator(device=dev).manual_seed(0),
                       AdamWConfig(), remat=True, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = synthetic_batches(cfg, DataConfig(batch=TRAIN_BATCH,
                                             seq=TRAIN_SEQ, seed=0))
    n_params = state.model.n_params()
    for c in counters:
        c.launches = 0
    step_s = []
    for _ in range(TRAIN_STEPS):
        batch = next(data)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state.step(batch)            # the metrics' floats synchronise
        step_s.append(time.perf_counter() - t)
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated() / 1e9
    hist = state.history
    check(all(np.isfinite(h[k]) for h in hist for k in h),
          f"{cfg.name} train: non-finite metrics {hist}")
    check(launches["wkv6"] == 0,
          f"{cfg.name} train launched the WKV kernel: {launches}")
    timed_s = step_s[1:]
    med = float(np.median(timed_s))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    param_bytes = n_params * 4
    # 8·N·D (forward, remat recompute, backward) over the matmul weights:
    # the embedding table's gather and scatter do no multiply-adds.
    matmul_params = n_params - state.model.embed.numel()
    flops = 8 * matmul_params * tokens
    t_ops = flops / F32_OPS_PER_S
    # Weights read, gradients written, moments read and written, weights
    # written: each once.
    t_bytes = 6 * param_bytes / HBM_BYTES_PER_S
    t = time.perf_counter()
    busy = device_totals(torch, lambda: state.step(next(data)))
    profiled_s = time.perf_counter() - t
    emit({"phase": "train", "arch": cfg.name, "dtype": "float32",
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "params": n_params, "param_bytes": param_bytes, "init_s": init_s,
          "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "remat": True, "wkv_backend": state.model.wkv_backend,
          "loss": [h["loss"] for h in hist[:TRAIN_STEPS]],
          "grad_norm": [h["grad_norm"] for h in hist[:TRAIN_STEPS]],
          "step_s": step_s, "step_s_median_after_warmup": med,
          "tokens_per_s": tokens / med,
          "matmul_params": matmul_params, "flops_per_step": flops,
          "bound_s": max(t_ops, t_bytes),
          "bound_by": "operations" if t_ops >= t_bytes else "bytes",
          "peak_mem_gb": peak, "launches": launches,
          "profiled_step": {"loss": hist[-1]["loss"],
                            "kernel_ms": busy["kernel_ms"],
                            "copy_ms": busy["copy_ms"],
                            "gemm_ms": busy["gemm_ms"],
                            "kernel_launches": busy["launches"],
                            "busy_share": (busy["kernel_ms"]
                                           + busy["copy_ms"]) / (med * 1e3),
                            "top": busy["top"],
                            "seconds_with_trace": profiled_s},
          "nvidia_smi": smi})
    del state, busy
    free_memory(torch)
    cut = dataclasses.replace(cfg, n_layers=TRAIN_HOST_LAYERS,
                              name=f"{cfg.name}-l{TRAIN_HOST_LAYERS}")
    cmp = train_compare(torch, np, dev, cut, synthetic_batches(
        cut, DataConfig(batch=TRAIN_HOST_BATCH, seq=TRAIN_HOST_SEQ,
                        seed=1)))
    emit({"phase": "train-parity", "tol_metric": TRAIN_TOL_METRIC, **cmp})



def scheduling_outcome(res) -> dict:
    """What a simulator run decided: placements, the metric report, the
    loop's counters and, with dynamics, its summary."""
    return {"placements": placement_key(res.jobs),
            "report": res.metrics.report(), "cycles": res.cycles,
            "failures": res.failures, "interrupts": res.interrupts,
            "preemptions": res.preemptions,
            "dynamics": None if res.dynamics is None
            else res.dynamics.as_dict()}


def demand_log(scaler) -> list:
    return [dataclasses.astuple(s) for s in scaler.demand_log]


def tidal_day(core, device, backend: str):
    """One simulated day of tidal co-scheduling (the ``TIDAL_*``
    constants) through ``Simulator.run`` with ``backend``; returns (the
    result, the autoscaler, wall seconds)."""
    topo = core.training_cluster_topology(8000)
    state = core.ClusterState.create(topo)
    scaler = core.TidalAutoscaler(
        [core.TidalService(name=f"svc{i}", tenant="svc", gpus_per_replica=8,
                           min_replicas=TIDAL_MIN, max_replicas=TIDAL_MAX,
                           peak_hour=14.0) for i in range(TIDAL_SERVICES)],
        interval_s=900.0)
    dynamics = core.DynamicsConfig(
        plugins=[scaler, core.NodeFailureInjector(
            mtbf_s=TIDAL_MTBF_S, repair_s=TIDAL_REPAIR_S, shape=1.2)],
        recovery=core.CheckpointModel(600.0, 120.0), seed=0)
    qsch = core.QSCH(
        core.QuotaManager({"svc": {0: 10 ** 6}, "batch": {0: 10 ** 6}}),
        core.RSCH(topo, core.RSCHConfig(device=device,
                                        score_backend=backend)),
        core.QSCHConfig(policy=core.QueuePolicy.BACKFILL))
    jobs = core.backfill_training_trace(TIDAL_JOBS, seed=0,
                                        sizes=TIDAL_SIZES,
                                        size_probs=TIDAL_SIZE_PROBS)
    sim = core.Simulator(state, qsch, core.SimConfig(horizon=86_400.0,
                                                     dynamics=dynamics))
    t = time.perf_counter()
    res = sim.run(jobs)
    wall = time.perf_counter() - t
    state.check_invariants()
    return res, scaler, wall


def run_tidal(core, node_score, rsch_mod, device=None) -> dict:
    """Phase 6c: the co-scheduling day on the card and with the host
    numpy backend; every decision, report and count must agree."""
    counters = (node_score.node_scores, node_score.node_scores_slots)
    for c in counters:
        c.launches = 0
    with CallRecorder(rsch_mod, "compute_node_scores_and_slots") as seam, \
            CallRecorder(rsch_mod, "compute_node_scores") as seam1:
        res, scaler, wall = tidal_day(core, device, "kernel")
    launches = {c.__name__: c.launches for c in counters}
    res_np, scaler_np, wall_np = tidal_day(core, device, "np")
    got, want = scheduling_outcome(res), scheduling_outcome(res_np)
    for key in want:
        check(got[key] == want[key],
              f"tidal day: {key} differs between the card and numpy")
    check(demand_log(scaler) == demand_log(scaler_np),
          "tidal day: the autoscaler's demand logs differ")
    check(launches["node_scores_slots"] > 0,
          f"tidal day never launched the score+slots kernel: {launches}")
    check(res.failures > 0 and res.preemptions > 0
          and scaler.replicas_started > 0,
          "tidal day: no failure, preemption or replica to hold")
    calls = seam.calls + seam1.calls
    out = {"phase": "tidal", "cluster": "training_cluster_topology(8000)",
           "services": TIDAL_SERVICES, "replicas": [TIDAL_MIN, TIDAL_MAX],
           "backlog_jobs": TIDAL_JOBS, "sizes": TIDAL_SIZES,
           "mtbf_days": TIDAL_MTBF_S / 86_400.0,
           "wall_s_cuda": wall, "wall_s_host_numpy": wall_np,
           "cycles": res.cycles, "seam_calls": calls,
           "seam_s": seam.seconds + seam1.seconds,
           "seam_us_per_call": (seam.seconds + seam1.seconds)
           / max(1, calls) * 1e6,
           "launches": launches, "failures": res.failures,
           "interrupts": res.interrupts, "preemptions": res.preemptions,
           "replicas_started": scaler.replicas_started,
           "replicas_retired": scaler.replicas_retired,
           "satisfaction": scaler.satisfaction(),
           "dynamics": got["dynamics"], "gar": got["report"]["median_gar"],
           "goodput_fraction": got["report"]["goodput_fraction"],
           "mttr_s": got["report"]["mttr"],
           "identical_to_numpy": True}
    emit(out)
    return out


def run_pipeline(node_score, rsch_mod, run_51, res_unpipelined,
                 device=None) -> dict:
    """Phase 6d: the §5.1 replay pipelined on the card against the same
    replay unpipelined, and against a pipelined host numpy run."""
    counters = (node_score.node_scores, node_score.node_scores_slots)
    for c in counters:
        c.launches = 0
    res, wall = run_51(device, pipelined=True)
    launches = {c.__name__: c.launches for c in counters}
    with CallRecorder(rsch_mod, "node_scores_np") as np_passes:
        res_np, wall_np = run_51(device, "np", pipelined=True)
    check(placement_key(res.jobs) == placement_key(res_unpipelined.jobs),
          "pipelined §5.1 placements differ from the unpipelined run")
    check(res.metrics.report() == res_unpipelined.metrics.report(),
          "pipelined §5.1 report differs from the unpipelined run")
    check(placement_key(res.jobs) == placement_key(res_np.jobs),
          "pipelined §5.1 placements differ between the card and numpy")
    stats, stats_np = dict(res.pipeline), dict(res_np.pipeline)
    drained = stats["hits"] + stats["misses"] + stats["conflicts"]
    check(stats["errors"] == 0, f"pipeline errors: {stats}")
    check(stats["speculated"] > 0, f"the pipeline never speculated: {stats}")
    check(stats["speculated"] - drained in (0, 1),
          f"speculations unaccounted for: {stats}")
    for key in ("speculated", "hits", "misses", "conflicts", "errors"):
        check(stats[key] == stats_np[key],
              f"pipeline {key}: card {stats[key]}, numpy {stats_np[key]}")
    passes = launches["node_scores_slots"] + launches["node_scores"]
    check(passes == np_passes.calls,
          f"pipelined score passes: card {passes}, numpy {np_passes.calls}")
    out = {"phase": "pipeline", "trace": "§5.1 (the main phase's)",
           "wall_s_cuda": wall, "wall_s_host_numpy": wall_np,
           "launches": launches, "score_passes_numpy": np_passes.calls,
           "stats": stats, "stats_numpy": stats_np,
           "identical_to_unpipelined": True}
    emit(out)
    return out


def node_score_launches(node_score) -> dict:
    return {"node_scores": node_score.node_scores.launches,
            "node_scores_slots": node_score.node_scores_slots.launches}


def zero_launches(node_score) -> None:
    node_score.node_scores.launches = 0
    node_score.node_scores_slots.launches = 0


def bench_topology(core, n_gpus: int, gpus_per_node: int = 8,
                   nodes_per_leaf: int = 8):
    """The reference benchmarks' scale topology
    (``benchmarks/common.py::scale_topology``)."""
    return core.ClusterTopology(
        n_nodes=n_gpus // gpus_per_node, gpus_per_node=gpus_per_node,
        nodes_per_leaf=nodes_per_leaf, leaves_per_spine=4,
        spines_per_superspine=4, nodes_per_hbd=nodes_per_leaf,
        nvlink_island=gpus_per_node, numa_split=gpus_per_node // 2)


def clone_jobs(core, jobs) -> list:
    return [core.Job(uid=j.uid, tenant=j.tenant, gpu_type=j.gpu_type,
                     n_pods=j.n_pods, gpus_per_pod=j.gpus_per_pod,
                     kind=j.kind, gang=j.gang, priority=j.priority,
                     submit_time=j.submit_time, duration=j.duration,
                     preemptible=j.preemptible, region=j.region,
                     elastic=j.elastic, metadata=j.metadata)
            for j in jobs]


def placement_fingerprint(jobs) -> list:
    """The reference benchmarks' fingerprint: in the result's order."""
    return [(j.uid, j.start_time, j.end_time,
             tuple((p.node, tuple(p.gpu_indices))
                   for p in (j.placement.pods if j.placement else ())))
            for j in jobs]


def sample_series(metrics) -> list:
    return [dataclasses.astuple(s) for s in metrics.samples]


def bench_sim(core, jobs, backend: str, device, *, n_gpus: int,
              policy=None, strategy=None, horizon=None, dynamics=None,
              elastic=None, manager=None, preempt: bool = True):
    """The reference's elastic and tuning benches' ``run_sim`` on the
    port, with the score pass on ``backend``: returns (result, wall s)."""
    topo = bench_topology(core, n_gpus)
    state = core.ClusterState.create(topo)
    rsch = core.RSCH(topo, core.RSCHConfig(
        train_strategy=strategy or core.Strategy.E_BINPACK, device=device,
        score_backend=backend))
    qsch = core.QSCH(core.QuotaManager({"t0": {0: 10 ** 6}}), rsch,
                     core.QSCHConfig(
                         policy=policy or core.QueuePolicy.BACKFILL,
                         priority_preemption=preempt),
                     elastic=elastic)
    sim = core.Simulator(state, qsch, core.SimConfig(
        tick_interval=30.0, sample_interval=300.0, binding_latency=45.0,
        horizon=horizon, dynamics=dynamics))
    if manager is not None:
        manager.attach(sim)
    t = time.perf_counter()
    res = sim.run(clone_jobs(core, jobs))
    wall = time.perf_counter() - t
    state.check_invariants()
    return res, wall


def run_outcome(res) -> dict:
    """``scheduling_outcome`` with the reference benches' fingerprint
    (end times included) and the raw sample series."""
    return {**scheduling_outcome(res),
            "fingerprint": placement_fingerprint(res.jobs),
            "samples": sample_series(res.metrics)}


def held_equal(tag: str, got: dict, want: dict) -> None:
    for key in want:
        check(got[key] == want[key],
              f"{tag}: {key} differs between the card and numpy")


def policy_strategy_matrix(core) -> list:
    """The reference benches' parity matrix: 3 queue policies x 2
    training strategies."""
    return [(p, s) for p in (core.QueuePolicy.BACKFILL,
                             core.QueuePolicy.STRICT_FIFO,
                             core.QueuePolicy.BEST_EFFORT_FIFO)
            for s in (core.Strategy.E_BINPACK, core.Strategy.BINPACK)]


def parity_trace(core, n: int) -> list:
    return [j for j in core.training_trace(n, seed=BENCH_SEED,
                                           arrival_rate_per_hour=500,
                                           mean_duration_s=2400.0)
            if j.n_gpus <= 128]


# -- 6e. elastic -------------------------------------------------------------
def contended_elastic(core, np) -> list:
    """``benchmarks/elastic_bench.py::_contended_workload`` (full size):
    100 small rigid jobs fragment the cluster while 14 elastic 128-GPU
    gangs (shrinkable to 64 and 32) arrive on top."""
    rng = np.random.default_rng(BENCH_SEED)
    jobs = []
    window = 10.0 * 3600.0
    for i in range(100):
        n_gpus = int(rng.choice([8, 16, 32], p=[.45, .35, .2]))
        jobs.append(core.Job(
            uid=i, tenant="t0", gpu_type=0, n_pods=n_gpus // 8,
            gpus_per_pod=8, submit_time=float(rng.uniform(0.0, window)),
            duration=float(rng.uniform(1.0, 2.5)) * 3600.0))
    spec = core.spec_from_artifacts(core.scaling_artifacts(
        "bench-train", "large", [32, 64, 128], alpha=0.85))
    ideal = spec.ideal()
    for k in range(14):
        jobs.append(core.Job(
            uid=10_000 + k, tenant="t0", gpu_type=0, n_pods=ideal.n_pods,
            gpus_per_pod=ideal.gpus_per_pod,
            submit_time=float(rng.uniform(0.0, 0.6 * window)),
            duration=float(rng.uniform(2.0, 3.5)) * 3600.0, elastic=spec))
    return jobs


def censored(jobs, horizon: float) -> list:
    """Jobs that never started waited until the horizon."""
    out = []
    for j in jobs:
        if j.start_time is None:
            j = copy.copy(j)
            j.start_time = horizon
        out.append(j)
    return out


def elastic_outcome(res) -> dict:
    m = res.metrics
    return {**run_outcome(res),
            "reshape": (m.reshapes, m.reshape_gpu_seconds,
                        m.lost_gpu_seconds, m.overhead_gpu_seconds,
                        m.useful_gpu_seconds),
            "plans": [(j.uid, j.reshape_count, None if j.active_plan is None
                       else j.active_plan.shape) for j in res.jobs]}


def run_elastic(core, np, node_score, device=None) -> dict:
    """Phase 6e: ``benchmarks/elastic_bench.py``'s two gates on the port,
    each on the card and with the host numpy backend."""
    zero_launches(node_score)
    t0 = t_phase = time.perf_counter()
    # Parity: an ElasticManager with no ElasticSpec is the rigid path.
    jobs = parity_trace(core, 240)
    walls = {"kernel": 0.0, "np": 0.0}
    for policy, strategy in policy_strategy_matrix(core):
        outs = {}
        for backend in ("kernel", "np"):
            base, w0 = bench_sim(core, jobs, backend, device,
                                 n_gpus=ELASTIC_GPUS, policy=policy,
                                 strategy=strategy)
            managed, w1 = bench_sim(core, jobs, backend, device,
                                    n_gpus=ELASTIC_GPUS, policy=policy,
                                    strategy=strategy,
                                    elastic=core.ElasticManager())
            walls[backend] += w0 + w1
            tag = f"elastic parity {policy.name} x {strategy.name}"
            check(placement_fingerprint(base.jobs)
                  == placement_fingerprint(managed.jobs),
                  f"{tag} ({backend}): placements differ")
            check(base.metrics.report() == managed.metrics.report(),
                  f"{tag} ({backend}): reports differ")
            outs[backend] = elastic_outcome(managed)
        held_equal(f"elastic parity {policy.name} x {strategy.name}",
                   outs["kernel"], outs["np"])
    parity_s = time.perf_counter() - t0

    # Elastic against rigid on a contended, failing 512-GPU cluster.
    def dynamics():
        return core.DynamicsConfig(
            plugins=[core.NodeFailureInjector(mtbf_s=6 * 3600.0,
                                              repair_s=1200.0, shape=1.2)],
            seed=BENCH_SEED,
            recovery=core.CheckpointModel(interval_s=600.0,
                                          restart_overhead_s=180.0))

    gate, cache = {}, {}
    for backend in ("kernel", "np"):
        core.elastic.plan_cache().clear()
        jobs = contended_elastic(core, np)
        check(contended_elastic(core, np)[-1].elastic is jobs[-1].elastic,
              "the plan cache did not return the memoised spec")
        cache[backend] = core.elastic.plan_cache_stats()
        rigid_jobs = clone_jobs(core, jobs)
        for j in rigid_jobs:
            j.elastic = None
        rigid, w_rigid = bench_sim(core, rigid_jobs, backend, device,
                                   n_gpus=ELASTIC_GPUS,
                                   horizon=ELASTIC_HORIZON_S,
                                   dynamics=dynamics())
        elast, w_elastic = bench_sim(core, jobs, backend, device,
                                     n_gpus=ELASTIC_GPUS,
                                     horizon=ELASTIC_HORIZON_S,
                                     dynamics=dynamics(),
                                     elastic=core.ElasticManager())
        gate[backend] = (rigid, elast, w_rigid, w_elastic)
    launches = node_score_launches(node_score)
    rigid, elast, w_rigid, w_elastic = gate["kernel"]
    held_equal("elastic gate, rigid arm", elastic_outcome(rigid),
               elastic_outcome(gate["np"][0]))
    held_equal("elastic gate, elastic arm", elastic_outcome(elast),
               elastic_outcome(gate["np"][1]))
    check(cache["kernel"] == cache["np"],
          f"plan-cache counters differ: {cache}")
    good = {"rigid": rigid.metrics.useful_gpu_seconds,
            "elastic": elast.metrics.useful_gpu_seconds}
    p90 = {"rigid": core.waiting_percentile(
               censored(rigid.jobs, ELASTIC_HORIZON_S), 90.0),
           "elastic": core.waiting_percentile(
               censored(elast.jobs, ELASTIC_HORIZON_S), 90.0)}
    overhead = elast.metrics.reshape_overhead_fraction()
    check(good["elastic"] > good["rigid"],
          f"elastic goodput {good} does not beat rigid")
    check(p90["elastic"] < p90["rigid"],
          f"elastic P90 JWTD {p90} does not beat rigid")
    check(overhead <= 0.10, f"reshape cost {overhead} over 10%")
    check(launches["node_scores_slots"] > 0,
          f"elastic phase never launched the score+slots kernel: {launches}")
    out = {"phase": "elastic", "cluster_gpus": ELASTIC_GPUS,
           "parity_configs": len(policy_strategy_matrix(core)),
           "parity_wall_s": parity_s, "parity_wall_s_cuda": walls["kernel"],
           "parity_wall_s_host_numpy": walls["np"],
           "horizon_h": ELASTIC_HORIZON_S / 3600.0, "seed": BENCH_SEED,
           "goodput_gpu_h": {k: v / 3600.0 for k, v in good.items()},
           "goodput_gain": good["elastic"] / good["rigid"] - 1.0,
           "jwtd_p90_s": p90, "reshape_overhead_fraction": overhead,
           "reshapes": elast.metrics.reshapes,
           "failures": {"rigid": rigid.failures, "elastic": elast.failures},
           "cycles": {"rigid": rigid.cycles, "elastic": elast.cycles},
           "wall_s_cuda": {"rigid": w_rigid, "elastic": w_elastic},
           "wall_s_host_numpy": {"rigid": gate["np"][2],
                                 "elastic": gate["np"][3]},
           "plan_cache": cache["kernel"], "launches": launches,
           "phase_wall_s": time.perf_counter() - t_phase,
           "identical_to_numpy": True}
    emit(out)
    return out


# -- 6f. federation ----------------------------------------------------------
def hetero_members(core, scale: int, backend: str, device):
    """``benchmarks/federation_bench.py::hetero_members``: three members
    of mixed node counts, GPUs a node and GPU-type pools."""
    kw = dict(tenants=tuple(FED_TENANT_REGIONS), device=device,
              score_backend=backend)
    return core.FederatedCluster([
        core.make_member("east-h100", region="r0",
                         gpu_pools=((0, 40 * scale),), gpus_per_node=8, **kw),
        core.make_member("west-h100", region="r1",
                         gpu_pools=((0, 16 * scale), (1, 16 * scale)),
                         gpus_per_node=8, **kw),
        core.make_member("west-a100", region="r2",
                         gpu_pools=((1, 48 * scale),), gpus_per_node=4, **kw),
    ])


def static_partition_select(core, np, fed):
    """The reference bench's ``StaticPartitionSelect``: each job pinned to
    its home-region member, else the first member hosting its type."""
    class StaticPartitionSelect(core.framework.ClusterSelectPlugin):
        name = "StaticPartitionSelect"

        def __init__(self, regions) -> None:
            self.regions = regions

        def assign(self, job, summary) -> int:
            fits = summary.structural_fit(job)
            home = (self.regions.index(job.region)
                    if job.region in self.regions else 0)
            if fits[home]:
                return home
            order = np.nonzero(fits)[0]
            if len(order):
                return int(order[0])
            c = summary.col(job.gpu_type)
            if c is None:
                return home
            return int(np.argmax(summary.capacity[:, c]))

        def score(self, job, summary):
            out = np.zeros(summary.n_members)
            out[self.assign(job, summary)] = 1e6
            return out

    return StaticPartitionSelect([m.region for m in fed.members])


def skewed_workload(core) -> list:
    """``federation_bench.py::skewed_workload`` (full size)."""
    jobs = core.training_trace(
        420, seed=BENCH_SEED, arrival_rate_per_hour=900.0,
        mean_duration_s=4200.0, tenants=tuple(FED_TENANT_REGIONS),
        tenant_regions=FED_TENANT_REGIONS, gpu_types=(0, 1),
        type_probs=(0.65, 0.35))
    return [j for j in jobs if j.n_gpus <= 64]


def saturating_workload(core, np, scale: int, horizon: float) -> list:
    """``federation_bench.py::saturating_workload``: big-gang demand at
    ~1.35x federation capacity, arriving in the first half of the
    horizon and outliving it."""
    rng = np.random.default_rng([BENCH_SEED, 0xFED])
    cap0 = (40 + 16) * scale * 8
    cap1 = 16 * scale * 8 + 48 * scale * 4
    specs = [(0, 64, 8, 0.95), (0, 16, 8, 0.80),
             (1, 64, 4, 0.90), (1, 16, 4, 0.85)]
    tenants_by_type = {0: ("tA", "tB", "tC"), 1: ("tC", "tD")}
    jobs, uid = [], 0
    for gpu_type, n_pods, per_pod, share in specs:
        demand = share * (cap0 if gpu_type == 0 else cap1)
        for _ in range(max(1, int(demand / (n_pods * per_pod)))):
            tenant = str(rng.choice(tenants_by_type[gpu_type]))
            jobs.append(core.Job(
                uid=uid, tenant=tenant, region=FED_TENANT_REGIONS[tenant],
                gpu_type=gpu_type, n_pods=n_pods, gpus_per_pod=per_pod,
                submit_time=float(rng.uniform(0.0, horizon / 2)),
                duration=horizon * 2.0))
            uid += 1
    return jobs


def fed_outcome(res) -> dict:
    """What a federated run decided: placements, routing stats, the
    federated report and each member's placements, report and samples."""
    return {"placements": placement_fingerprint(res.jobs),
            "routing": dataclasses.astuple(res.routing),
            "report": res.report(),
            "counts": (res.end_time, res.cycles, res.preemptions,
                       res.spills, [j.uid for j in res.unrouted]),
            "members": [{"placements": placement_fingerprint(m.jobs),
                         "report": m.metrics.report(),
                         "samples": sample_series(m.metrics)}
                        for m in res.members]}


class MemberMeter:
    """Node-score launches, seam calls and seam seconds of each member,
    counted around its RSCH's ``schedule`` (the only way in to the
    score pass) while ``seams`` (CallRecorders on the seam) are live."""

    def __init__(self, fed, node_score, seams) -> None:
        self.names = [m.name for m in fed.members]
        self.nodes = [m.topology.n_nodes for m in fed.members]
        self.launches = [0] * len(fed.members)
        self.calls = [0] * len(fed.members)
        self.seconds = [0.0] * len(fed.members)

        def total():
            return (sum(node_score_launches(node_score).values()),
                    sum(s.calls for s in seams),
                    sum(s.seconds for s in seams))

        for i, m in enumerate(fed.members):
            rsch = m.qsch.rsch

            def schedule(*args, _i=i, _orig=rsch.schedule, **kw):
                before = total()
                out = _orig(*args, **kw)
                after = total()
                self.launches[_i] += after[0] - before[0]
                self.calls[_i] += after[1] - before[1]
                self.seconds[_i] += after[2] - before[2]
                return out
            rsch.schedule = schedule

    def as_dict(self) -> dict:
        return {name: {"launches": self.launches[i],
                       "seam_calls": self.calls[i],
                       "seam_us_per_call": self.seconds[i]
                       / max(1, self.calls[i]) * 1e6}
                for i, name in enumerate(self.names)}


def run_federation(core, np, node_score, rsch_mod, device=None) -> dict:
    """Phase 6f: ``benchmarks/federation_bench.py``'s gates on the port,
    each on the card and with the host numpy backend; at the acceptance
    scale (10,000 / 8,000 / 12,000 nodes) both arms are timed."""
    zero_launches(node_score)
    t0 = t_phase = time.perf_counter()
    # Single-member parity: a one-member federation is a plain Simulator.
    jobs = parity_trace(core, 240)
    for policy, strategy in policy_strategy_matrix(core):
        outs = {}
        for backend in ("kernel", "np"):
            def member():
                return core.make_member(
                    "solo", gpu_pools=((0, 64),), policy=policy,
                    strategy=strategy, device=device, score_backend=backend)
            m = member()
            base = core.Simulator(m.state, m.qsch, m.sim_config).run(
                clone_jobs(core, jobs))
            fed = core.FederatedSimulator(core.FederatedCluster(
                [member()])).run(clone_jobs(core, jobs))
            solo = fed.members[0]
            tag = f"federation parity {policy.name} x {strategy.name}"
            check(placement_fingerprint(base.jobs)
                  == placement_fingerprint(solo.jobs),
                  f"{tag} ({backend}): placements differ")
            check(sample_series(base.metrics) == sample_series(solo.metrics),
                  f"{tag} ({backend}): sample series differ")
            check(base.metrics.report() == solo.metrics.report(),
                  f"{tag} ({backend}): reports differ")
            outs[backend] = fed_outcome(fed)
        held_equal(f"federation parity {policy.name} x {strategy.name}",
                   outs["kernel"], outs["np"])
    parity_s = time.perf_counter() - t0

    # Spillover against static partitioning, hetero_members(1).
    t0 = time.perf_counter()
    jobs = skewed_workload(core)
    horizon = 10 * 3600.0
    spill_runs = {}
    for backend in ("kernel", "np"):
        for spillover in (False, True):
            fed = hetero_members(core, 1, backend, device)
            cfg = core.GSCHConfig(
                select=(core.federation.QuotaFitSelect(),
                        static_partition_select(core, np, fed)),
                immediate_fit_bonus=0.0, spillover=spillover,
                spill_deadline_s=600.0, forward_delay_s=60.0,
                locality_penalty_s=240.0)
            spill_runs[backend, spillover] = core.FederatedSimulator(
                fed, cfg, horizon=horizon).run(clone_jobs(core, jobs))
    for spillover in (False, True):
        held_equal(f"federation spillover={spillover}",
                   fed_outcome(spill_runs["kernel", spillover]),
                   fed_outcome(spill_runs["np", spillover]))
    static, spill = spill_runs["kernel", False], spill_runs["kernel", True]
    T = max(j.start_time for res in (static, spill) for j in res.jobs
            if j.start_time is not None)
    capacity = sum(m.state.total_allocatable()
                   for m in hetero_members(core, 1, "np", device).members)
    stats = {}
    for tag, res in (("static", static), ("spillover", spill)):
        stats[tag] = {
            "p90_jwtd_s": core.federation.waiting_percentile(res.jobs, 90.0),
            "mean_gar_loaded": core.federation.allocated_gar(
                res.jobs, capacity, T, default_end=horizon),
            "sor": res.metrics.sor(),
            "balance_loaded": res.metrics.balance_index(T)}
    check(spill.spills > 0, "the spillover scenario never spilled")
    check(stats["spillover"]["p90_jwtd_s"] < stats["static"]["p90_jwtd_s"],
          f"spillover does not beat static on P90 JWTD: {stats}")
    check(stats["spillover"]["mean_gar_loaded"]
          >= 0.995 * stats["static"]["mean_gar_loaded"],
          f"spillover loses loaded-window GAR: {stats}")
    check(stats["spillover"]["balance_loaded"]
          >= stats["static"]["balance_loaded"],
          f"spillover does not improve balance: {stats}")
    spill_s = time.perf_counter() - t0

    # The acceptance scale: hetero_members(250), saturating big gangs.
    scale, horizon = FED_SCALE, FED_HORIZON_S
    jobs = saturating_workload(core, np, scale, horizon)

    def partition(fed):
        sel = static_partition_select(core, np, fed)
        summary = core.federation.summarize(fed.members, 0.0)
        parts = [[] for _ in fed.members]
        for j in jobs:
            parts[sel.assign(j, summary)].append(j)
        return parts

    def standalone(backend):
        fed = hetero_members(core, scale, backend, device)
        meter = MemberMeter(fed, node_score, seams)
        wall, cycles, outs = 0.0, 0, []
        for m, part in zip(fed.members, partition(fed)):
            m.sim_config = dataclasses.replace(m.sim_config, horizon=horizon)
            sim = core.Simulator(m.state, m.qsch, m.sim_config)
            part = clone_jobs(core, part)
            t = time.perf_counter()
            res = sim.run(part)
            wall += time.perf_counter() - t
            cycles += res.cycles
            outs.append(run_outcome(res))
        return wall, cycles, outs, meter

    def federated(backend):
        fed = hetero_members(core, scale, backend, device)
        meter = MemberMeter(fed, node_score, seams)
        cfg = core.GSCHConfig(
            select=(core.federation.QuotaFitSelect(),
                    static_partition_select(core, np, fed)),
            immediate_fit_bonus=0.0, summary_max_age_s=120.0,
            spill_deadline_s=horizon * 10)
        sim = core.FederatedSimulator(fed, cfg, horizon=horizon)
        batch = clone_jobs(core, jobs)
        t = time.perf_counter()
        res = sim.run(batch)
        wall = time.perf_counter() - t
        for m in fed.members:
            m.state.check_invariants()
        return wall, res.cycles, fed_outcome(res), meter

    accept = {}
    with CallRecorder(rsch_mod, "compute_node_scores_and_slots") as seam, \
            CallRecorder(rsch_mod, "compute_node_scores") as seam1:
        seams = (seam, seam1)
        for backend in ("kernel", "np"):
            accept[backend] = {"standalone": standalone(backend),
                               "federated": federated(backend)}
    launches = node_score_launches(node_score)
    for arm in ("standalone", "federated"):
        got, want = accept["kernel"][arm][2], accept["np"][arm][2]
        if arm == "standalone":
            for i, (g, w) in enumerate(zip(got, want)):
                held_equal(f"federation acceptance, standalone member {i}",
                           g, w)
        else:
            held_equal("federation acceptance, federated", got, want)
    check(launches["node_scores_slots"] > 0,
          f"federation phase never launched the score+slots kernel: "
          f"{launches}")
    arms = {}
    for backend in ("kernel", "np"):
        sa_wall, sa_cycles = accept[backend]["standalone"][:2]
        fed_wall, fed_cycles = accept[backend]["federated"][:2]
        sa_ms = sa_wall / max(1, sa_cycles) * 1e3
        fed_ms = fed_wall / max(1, fed_cycles) * 1e3
        arms["cuda" if backend == "kernel" else "host_numpy"] = {
            "standalone_cycles": sa_cycles, "federated_cycles": fed_cycles,
            "standalone_ms_per_cycle": sa_ms,
            "federated_ms_per_cycle": fed_ms, "ratio": fed_ms / sa_ms,
            "standalone_wall_s": sa_wall, "federated_wall_s": fed_wall}
    card = accept["kernel"]
    n_nodes = card["federated"][3].nodes
    fed_res = card["federated"][2]
    out = {"phase": "federation",
           "parity_configs": len(policy_strategy_matrix(core)),
           "parity_wall_s": parity_s,
           "spillover": {**stats, "spills": spill.spills,
                         "cross_region": spill.routing.cross_region_forwards,
                         "window_h": T / 3600.0, "wall_s": spill_s},
           "acceptance": {"nodes_per_member": n_nodes, "scale": scale,
                          "horizon_s": horizon, "jobs": len(jobs),
                          "routing": fed_res["routing"], **arms,
                          "members_standalone":
                              card["standalone"][3].as_dict(),
                          "members_federated":
                              card["federated"][3].as_dict()},
           "launches": launches, "phase_wall_s": time.perf_counter() - t_phase,
           "identical_to_numpy": True}
    emit(out)
    return out


# -- 6g. tuning --------------------------------------------------------------
def contended_tuning_trace(core, np, n_gpus: int) -> list:
    """``benchmarks/tuning_bench.py::contended_trace``: a PRIO_LOW burst
    of ~2.4x cluster capacity under a stream of small PRIO_NORMAL jobs."""
    rng = np.random.default_rng(BENCH_SEED)
    window = 4.0 * 3600.0
    jobs = []
    n_norm = round(0.55 * n_gpus * window / (4.9 * 2400.0))
    arrivals = np.cumsum(rng.exponential(window / n_norm, size=n_norm))
    for i in range(n_norm):
        gpus = int(rng.choice([1, 2, 4, 8, 16], p=[.2, .25, .25, .2, .1]))
        n_pods, per_pod = (1, gpus) if gpus <= 8 else (gpus // 8, 8)
        jobs.append(core.Job(uid=i, tenant="t0", gpu_type=0, n_pods=n_pods,
                             gpus_per_pod=per_pod, priority=core.PRIO_NORMAL,
                             submit_time=float(arrivals[i]),
                             duration=max(300.0, float(
                                 rng.exponential(2400.0)))))
    for k in range(round(2.4 * n_gpus / 11.2)):
        gpus = int(rng.choice([8, 16], p=[.6, .4]))
        jobs.append(core.Job(uid=50_000 + k, tenant="t0", gpu_type=0,
                             n_pods=gpus // 8, gpus_per_pod=8,
                             kind=core.JobKind.TRAIN, priority=core.PRIO_LOW,
                             submit_time=float(rng.uniform(0.0, 600.0)),
                             duration=max(300.0, float(
                                 rng.exponential(2400.0)))))
    return jobs


def frontier_metrics(core, res) -> dict:
    rep = res.metrics.report()
    return {"gar": float(rep["median_gar"]), "gfr": float(rep["mean_gfr"]),
            "p90_wait": float(core.waiting_percentile(res.jobs, 90.0)),
            "p99_wait": float(core.waiting_percentile(res.jobs, 99.0)),
            "goodput": float(rep["goodput_gpu_seconds"])}


def compare_arm(tuned: dict, static: dict) -> tuple:
    """(wins, regressions) of the tuned arm against one static arm, with
    the reference bench's senses and tolerances."""
    wins, regressions = [], []
    for name, sense in TUNING_METRIC_SENSE.items():
        rel, slack = TUNING_METRIC_TOL[name]
        margin = abs(static[name]) * rel + slack
        gain = sense * (tuned[name] - static[name])
        if gain > margin:
            wins.append(name)
        elif gain < -margin:
            regressions.append(name)
    return wins, regressions


def tuning_outcome(res, mgr) -> dict:
    return {**run_outcome(res),
            "changes": [dataclasses.astuple(c) for c in mgr.space.changes],
            "history": list(mgr.history), "periods": mgr.periods}


def run_tuning(core, np, node_score, rsch_mod, device=None) -> dict:
    """Phase 6g: ``benchmarks/tuning_bench.py``'s identity, tuned-vs-static
    and attached-overhead gates on the port, each on the card and with
    the host numpy backend, plus a climb over every handle (score
    weights included)."""
    zero_launches(node_score)
    t0 = t_phase = time.perf_counter()
    # NoOp byte-identity across the policy x strategy matrix.
    jobs = parity_trace(core, 160)
    handles = 0
    for policy, strategy in policy_strategy_matrix(core):
        outs = {}
        for backend in ("kernel", "np"):
            base, _ = bench_sim(core, jobs, backend, device,
                                n_gpus=TUNING_IDENTITY_GPUS, policy=policy,
                                strategy=strategy)
            noop = core.NoOpController()
            mgr = core.TuningManager([noop],
                                     control_period_s=TUNING_PERIOD_S)
            inst, _ = bench_sim(core, jobs, backend, device,
                                n_gpus=TUNING_IDENTITY_GPUS, policy=policy,
                                strategy=strategy, manager=mgr)
            tag = f"tuning identity {policy.name} x {strategy.name}"
            check(run_outcome(base) == run_outcome(inst),
                  f"{tag} ({backend}): the no-op manager perturbed the run")
            check(noop.ticks_seen > 0 and noop.windows_seen > 0,
                  f"{tag} ({backend}): the manager never drove the "
                  f"controller")
            check(not mgr.space.changes, f"{tag} ({backend}): changes")
            handles = len(mgr.space)
            check(handles >= 15, f"{tag}: only {handles} handles")
            outs[backend] = tuning_outcome(inst, mgr)
        held_equal(f"tuning identity {policy.name} x {strategy.name}",
                   outs["kernel"], outs["np"])
    identity_s = time.perf_counter() - t0

    # Tuned against the static Table-1 profiles at 1,024 GPUs.
    t0 = time.perf_counter()
    n_gpus = TUNING_GPUS
    jobs = contended_tuning_trace(core, np, n_gpus)
    statics = {f"static:{name}": core.Strategy[name]
               for name in TUNING_STATIC}
    arms, tuned_runs = {}, {}
    for backend in ("kernel", "np"):
        for tag, strategy in statics.items():
            res, _ = bench_sim(core, jobs, backend, device, n_gpus=n_gpus,
                               strategy=strategy, preempt=False)
            arms[backend, tag] = res
        mgr = core.TuningManager(
            [core.StarvationEscalator(wait_threshold_s=900.0, boost=30,
                                      escalation_period_s=450.0),
             core.HillClimbController(seed=BENCH_SEED, params=["qsch."],
                                      hysteresis=0.02)],
            control_period_s=TUNING_PERIOD_S)
        res, _ = bench_sim(core, jobs, backend, device, n_gpus=n_gpus,
                           manager=mgr, preempt=False)
        tuned_runs[backend] = (res, mgr)
    for tag in statics:
        held_equal(f"tuning {tag}", run_outcome(arms["kernel", tag]),
                   run_outcome(arms["np", tag]))
    held_equal("tuning tuned arm", tuning_outcome(*tuned_runs["kernel"]),
               tuning_outcome(*tuned_runs["np"]))
    res, mgr = tuned_runs["kernel"]
    tuned = frontier_metrics(core, res)
    escalator, climber = mgr.controllers
    check(escalator.escalations > 0, "the escalator never escalated")
    matchups = {}
    for tag in statics:
        static = frontier_metrics(core, arms["kernel", tag])
        wins, regressions = compare_arm(tuned, static)
        matchups[tag] = {"wins": wins, "regressions": regressions,
                         "static": static}
        check(wins, f"tuned arm beat {tag} on no frontier metric: "
                    f"{tuned} against {static}")
        check(not regressions, f"tuned arm regressed {regressions} against "
                               f"{tag}: {tuned} against {static}")
    tuned_s = time.perf_counter() - t0

    # The climb over every handle: score weights move mid-run.
    t0 = time.perf_counter()
    every = {}
    for backend in ("kernel", "np"):
        mgr = core.TuningManager(
            [core.StarvationEscalator(wait_threshold_s=900.0, boost=30,
                                      escalation_period_s=450.0),
             core.HillClimbController(seed=TUNING_CLIMB_SEED, params=None,
                                      hysteresis=0.02)],
            control_period_s=TUNING_PERIOD_S)
        first = {}
        emit_change = mgr.space.on_change

        def on_change(ch, _first=first, _emit=emit_change):
            if "launches" not in _first and ch.param.endswith(WEIGHT_FIELDS):
                _first.update(param=ch.param, t=ch.t,
                              launches=sum(node_score_launches(
                                  node_score).values()))
            _emit(ch)
        mgr.space.on_change = on_change
        seam_weights, seam = set(), rsch_mod.compute_node_scores_and_slots

        def record(*args, _seam=seam, _seen=seam_weights, **kw):
            _seen.add(args[7])          # the weights this pass launches with
            return _seam(*args, **kw)
        rsch_mod.compute_node_scores_and_slots = record
        try:
            res, wall = bench_sim(core, jobs, backend, device, n_gpus=n_gpus,
                                  manager=mgr, preempt=False)
        finally:
            rsch_mod.compute_node_scores_and_slots = seam
        after = sum(node_score_launches(node_score).values()) \
            - first.get("launches", 0)
        every[backend] = (res, mgr, first, after, wall, seam_weights)
    held_equal("tuning all-handle run", tuning_outcome(*every["kernel"][:2]),
               tuning_outcome(*every["np"][:2]))
    res, mgr, first, launches_after, wall_every, weights = every["kernel"]
    weight_changes = [c for c in mgr.space.changes
                      if c.param.endswith(WEIGHT_FIELDS)]
    check(weight_changes, "the all-handle climb never moved a score weight")
    check(launches_after > 0,
          f"no kernel launch after the first weight change {first}")
    check(len(weights) > 1, f"the kernel was launched with one weight set "
                            f"only: {weights}")
    every_s = time.perf_counter() - t0

    # Attached overhead at 10k nodes: one stack, arms in turns.
    overhead = {}
    for backend in ("kernel", "np"):
        overhead[backend] = tuning_overhead(core, np, backend, device)
    check(overhead["kernel"]["picks"] == overhead["np"]["picks"],
          "the overhead gang's placements differ between card and numpy")
    launches = node_score_launches(node_score)
    check(launches["node_scores_slots"] > 0,
          f"tuning phase never launched the score+slots kernel: {launches}")
    out = {"phase": "tuning", "handles": handles,
           "identity_configs": len(policy_strategy_matrix(core)),
           "identity_wall_s": identity_s,
           "tuned_vs_static": {
               "n_gpus": n_gpus, "tuned": tuned, "matchups": matchups,
               "escalations": escalator.escalations,
               "probes": climber.moves, "accepts": climber.accepts,
               "reverts": climber.reverts, "periods": mgr.periods,
               "wall_s": tuned_s},
           "all_handles": {
               "changes": len(mgr.space.changes),
               "weight_changes": len(weight_changes),
               "first_weight_change": {k: v for k, v in first.items()
                                       if k != "launches"},
               "launches_after_first_weight_change": launches_after,
               "weight_sets_launched": len(weights),
               "probes": mgr.controllers[1].moves,
               "reverts": mgr.controllers[1].reverts,
               "wall_s_cuda": wall_every,
               "wall_s_host_numpy": every["np"][4], "wall_s": every_s},
           "overhead_10k": {
               "cuda": {k: v for k, v in overhead["kernel"].items()
                        if k != "picks"},
               "host_numpy": {k: v for k, v in overhead["np"].items()
                              if k != "picks"}},
           "launches": launches, "phase_wall_s": time.perf_counter() - t_phase,
           "identical_to_numpy": True}
    emit(out)
    return out


def tuning_overhead(core, np, backend: str, device) -> dict:
    """``tuning_bench.py::overhead_gate`` on ``backend``: a 64-pod gang
    cycle on a fragmented 10k-node cluster, detached and attached (a
    no-op controller and an escalator that never fires) in turns on one
    stack; median ms of each arm and of the paired deltas."""
    state = fragmented_state(core, np, TUNING_OVERHEAD_NODES, BENCH_SEED)
    qsch = core.QSCH(
        core.QuotaManager({"t0": {0: 10 ** 9}}),
        core.RSCH(state.topology, core.RSCHConfig(
            train_strategy=core.Strategy.E_BINPACK, device=device,
            score_backend=backend)),
        core.QSCHConfig(policy=core.QueuePolicy.STRICT_FIFO))
    sim = core.Simulator(state, qsch, core.SimConfig(tick_interval=30.0))
    mgr = core.TuningManager(
        [core.NoOpController(), core.StarvationEscalator(
            wait_threshold_s=1e15)], control_period_s=TUNING_PERIOD_S)
    mgr.attach(sim)

    def cycle(now, attached, seq):
        qsch.submit(core.Job(uid=1, tenant="t0", gpu_type=0,
                             n_pods=GANG_PODS, gpus_per_pod=GPUS_PER_POD,
                             kind=core.JobKind.TRAIN))
        t = time.perf_counter()
        result = qsch.cycle(state, now)
        if attached:
            mgr._on_tick(core.Event(t=now, kind=core.EventKind.TICK,
                                    seq=seq))
        dt = time.perf_counter() - t
        check(len(result.scheduled) == 1, "the overhead gang must bind")
        bound = result.scheduled[0]
        picks = tuple((p.node, tuple(p.gpu_indices))
                      for p in bound.placement.pods)
        state.release(bound.uid)
        qsch.running.clear()
        qsch.quota.refund(bound)
        return dt, picks

    cycle(0.0, False, 0)
    cycle(0.0, True, 0)
    det, att = [], []
    for i in range(TUNING_OVERHEAD_REPEATS * 2):
        now = 30.0 * (i + 1)
        dt, p_det = cycle(now, False, i)
        det.append(dt)
        dt, p_att = cycle(now, True, i)
        att.append(dt)
        check(p_det == p_att, "the attached arm placed differently")
    check(not mgr.space.changes, "the overhead arms changed a parameter")
    d = float(np.median(det))
    a = d + float(np.median(np.subtract(att, det)))
    return {"nodes": TUNING_OVERHEAD_NODES, "gang_pods": GANG_PODS,
            "cycles_per_arm": len(det), "detached_ms": d * 1e3,
            "attached_ms": a * 1e3, "overhead": a / d - 1.0,
            "handles": len(mgr.space), "picks": p_det}


def fabric_pool(serve, router: str, specs, trace):
    """``specs`` behind ``router``, ``trace`` routed through it."""
    pool = serve.ReplicaPool(specs, getattr(serve, router)())
    pool.route_trace(trace)
    return pool


def fabric_metrics(pool):
    m = pool.metrics
    return (m.report(), m.by_class(), m.replica_share(),
            [dataclasses.astuple(o) for o in m.outcomes])


def run_fabric(torch, np, dev, counters, smi: str, smoke: bool = False
               ) -> dict:
    """Phase 9b: the serving fabric.  Routing of the ``FABRIC_*`` pool
    through each router; both replicas' engines materialised on the card
    with ``Replica.build_engine``, serving the requests round-robin sent
    them (batched against solo); then the pool, at the token rates just
    measured, exported to a ``TidalAutoscaler`` in a card ``Simulator``
    over 8,000 GPUs, against the host numpy backend."""
    import repro_torch.core as core
    import repro_torch.serve as serve
    from repro_torch.configs import get_arch
    from repro_torch.kernels import node_score
    from repro_torch.models import Model

    trace = core.request_trace(FABRIC_REQUESTS, seed=0)
    specs = [serve.ReplicaSpec.from_arch(a) for a in FABRIC_ARCHS]
    routing, pools = {}, {}
    for router in FABRIC_ROUTERS:
        pools[router] = fabric_pool(serve, router, specs, trace)
        got = fabric_metrics(pools[router])
        again = fabric_metrics(fabric_pool(serve, router, specs, trace))
        check(got == again, f"{router}: routing the trace again differs")
        routing[router] = got[0]
    by_uid = {r.uid: r for r in trace}
    sent = {i: [by_uid[o.uid] for o in pools["RoundRobinRouter"].metrics
                .outcomes if o.replica == i] for i in range(len(specs))}

    engine_device = None if dev.type == "cuda" else dev
    engines = {}
    for idx, arch in enumerate(FABRIC_ARCHS):
        cfg = get_arch(arch, smoke=smoke)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = Model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0),
            torch.float32).state_dict()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        replica = serve.Replica(specs[idx])

        def requests():
            return [serve.to_engine_request(
                r, vocab=cfg.vocab, max_prompt=FABRIC_MAX_PROMPT,
                max_new=FABRIC_MAX_NEW) for r in sent[idx][:FABRIC_SERVED]]

        timings = {"_prefill": [], "_decode": []}
        engine = replica.build_engine(params, max_seq=FABRIC_MAX_SEQ,
                                      smoke=smoke, device=engine_device)
        check(engine.device.type == dev.type and engine.B == specs[idx].slots,
              f"{arch}: build_engine made {engine.device}, B={engine.B}")
        for name in ("_prefill", "_decode"):
            setattr(engine, name, timed(torch, getattr(engine, name),
                                        timings[name]))
        for c in counters:
            c.launches = 0
        reqs = requests()
        for r in reqs:
            engine.submit(r)
        t = time.perf_counter()
        batched = {r.uid: list(r.generated)
                   for r in engine.run_until_drained()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {c.__name__: c.launches for c in counters}
        prefill_calls = engine.prefill_calls
        check(all(ok for log in timings.values() for _, ok, _ in log),
              f"{arch}: non-finite logits in the fabric")
        del engine
        solo_engine = serve.Replica(dataclasses.replace(
            specs[idx], slots=1)).build_engine(
                params, max_seq=FABRIC_MAX_SEQ, smoke=smoke,
                device=engine_device)
        solo = {}
        for r in requests():
            solo_engine.submit(r)
            solo.update({d.uid: list(d.generated)
                         for d in solo_engine.run_until_drained()})
        check(len(batched) == len(reqs) == FABRIC_SERVED,
              f"{arch}: served {len(batched)} of {len(reqs)} requests")
        check(batched == solo,
              f"{arch}: batched tokens differ from solo runs")
        if cfg.family == "ssm":
            check(launches["wkv6"] == cfg.n_layers * prefill_calls > 0,
                  f"{arch}: wkv6 launches {launches} for {prefill_calls} "
                  "prefills")
        pre_s = [s for s, _, _ in timings["_prefill"]]
        dec_s = [s for s, _, _ in timings["_decode"]]
        prompt_tokens = sum(len(r.prompt) for r in reqs)
        engines[arch] = {
            "params": sum(t.numel() for t in params.values()),
            "param_gb": sum(t.numel() * t.element_size()
                            for t in params.values()) / 1e9,
            "init_s": init_s, "requests": len(reqs),
            "prompt_tokens": prompt_tokens,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "prefill_calls": prefill_calls,
            "prefill_ms_per_request": float(np.mean(pre_s)) * 1e3,
            "prefill_tokens_per_s": prompt_tokens / sum(pre_s),
            "decode_steps": len(dec_s),
            "decode_ms_per_step_median": float(np.median(dec_s)) * 1e3,
            "wall_s": wall, "launches": launches,
            "tokens_equal_solo": True,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del solo_engine, params
        free_memory(torch)

    # The hand-off: the pool at the token rates this run measured (one
    # token a decode step per slot), so the autoscaler sees the load the
    # card's engines would carry.  The nominal rates (1e15 FLOP/s) serve
    # a request in well under a millisecond: their demand never leaves
    # the minimum of one replica.
    measured = [dataclasses.replace(
        spec, prefill_tokens_per_s=engines[spec.arch]["prefill_tokens_per_s"],
        decode_tokens_per_s=1e3 / engines[spec.arch][
            "decode_ms_per_step_median"]) for spec in specs]
    span = trace[-1].arrival_s
    grid = np.arange(0.0, span, 60.0)

    def targets(pool):
        svc = serve.demand_service(pool,
                                   gpus_per_replica=FABRIC_GPUS_PER_REPLICA,
                                   max_replicas=FABRIC_MAX_REPLICAS)
        return svc, [svc.target_replicas(t) for t in grid]

    _, nominal = targets(pools["RoundRobinRouter"])
    sim_device = None if dev.type == "cuda" else "cpu"

    def autoscaled(backend):
        svc, want = targets(fabric_pool(serve, "RoundRobinRouter", measured,
                                        trace))
        scaler = core.TidalAutoscaler([svc], interval_s=60.0)
        topo = core.training_cluster_topology(8000)
        state = core.ClusterState.create(topo)
        qsch = core.QSCH(core.QuotaManager({"svc": {0: 10 ** 6}}),
                         core.RSCH(topo, core.RSCHConfig(
                             device=sim_device, score_backend=backend)))
        res = core.Simulator(state, qsch, core.SimConfig(
            horizon=span, dynamics=core.DynamicsConfig(
                plugins=[scaler]))).run([])
        state.check_invariants()
        return res, scaler, want

    node_score.node_scores_slots.launches = 0
    res, scaler, want = autoscaled("kernel")
    sim_launches = node_score.node_scores_slots.launches
    res_np, scaler_np, _ = autoscaled("np")
    check(placement_key(res.jobs) == placement_key(res_np.jobs)
          and res.metrics.report() == res_np.metrics.report()
          and demand_log(scaler) == demand_log(scaler_np),
          "fabric demand: the card's run differs from numpy")
    check(scaler.replicas_started >= max(want),
          f"fabric demand: {scaler.replicas_started} replicas started "
          f"for a peak target of {max(want)}")
    check(sim_launches > 0, "fabric demand never launched the kernel")
    out = {"phase": "fabric", "archs": FABRIC_ARCHS,
           "trace": f"request_trace({FABRIC_REQUESTS}, seed=0)",
           "span_s": span, "routing": routing, "engines": engines,
           "max_seq": FABRIC_MAX_SEQ,
           "demand": {"target_min": min(want), "target_max": max(want),
                      "nominal_target_max": max(nominal),
                      "replicas_started": scaler.replicas_started,
                      "replicas_retired": scaler.replicas_retired,
                      "satisfaction": scaler.satisfaction(),
                      "launches": sim_launches,
                      "identical_to_numpy": True},
           "nvidia_smi": smi}
    emit(out)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np

    import repro_torch.core as core
    from repro_torch.core.snapshot import FullSnapshotter
    from repro_torch.configs import get_arch
    from repro_torch.kernels import node_score, ops, wkv6
    from repro_torch.kernels.ref import (node_scores_ref,
                                         node_scores_slots_ref,
                                         wkv6_chunked_ref, wkv6_ref)
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0)})

    # -- 2. build: one nvcc per source, all started together -----------
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(node_score.build), pool.submit(wkv6.build)]:
            fut.result()
    emit({"phase": "build", "seconds": node_score.build_seconds,
          "flags": " ".join(node_score.NVCC_FLAGS),
          "ptxas": ptxas_summary(node_score.build_log),
          "wkv6": {"seconds": wkv6.build_seconds,
                   "flags": " ".join(wkv6.NVCC_FLAGS),
                   "ptxas": ptxas_summary(wkv6.build_log),
                   "ptxas_log": wkv6.build_log},
          "wall_s": time.perf_counter() - t0})

    # -- 3. sweep: kernel vs plain version, bit patterns ------------------
    weight_sets = {"BINPACK": core.BINPACK, "E_BINPACK": core.E_BINPACK,
                   "SPREAD": core.SPREAD, "E_SPREAD": core.E_SPREAD,
                   "MIXED": core.ScoreWeights(0.3, -0.2, 1.1, -0.7)}
    stats = {name: {"cases": 0, "mismatches": 0, "max_abs_err": 0.0}
             for name in ("score", "slots", "unaligned")}
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for n in sorted(set(SIZES + EDGE_SIZES)):
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

                    def bad_vs_host(score, slots) -> int:
                        return int(
                            (score.cpu().numpy().view(np.int32) != hb).sum()
                            + (slots.cpu().numpy() != host_slots).sum())
                    if n not in UNALIGNED_SIZES:
                        continue
                    # Columns and outputs one element off alignment: the
                    # kernel's scalar path.
                    ucols = tuple(unaligned(torch, c) for c in cols)
                    us1 = node_score.node_scores(
                        *ucols, **kw, out=unaligned(torch, torch.zeros_like(
                            s1)))
                    us2, usl = node_score.node_scores_slots(
                        *ucols, **kw, out=(unaligned(torch, torch.zeros_like(
                            s2)), unaligned(torch, torch.zeros_like(sl))))
                    check(all(t.data_ptr() % 16 for t in (*ucols, us1, us2,
                                                          usl)),
                          "the unaligned views are aligned")
                    st = stats["unaligned"]
                    st["cases"] += 2
                    st["mismatches"] += bad_vs_host(us2, usl) + int(
                        (us1.cpu().numpy().view(np.int32) != hb).sum())
    emit({"phase": "sweep", "sizes": sorted(set(SIZES + EDGE_SIZES)),
          "unaligned_sizes": UNALIGNED_SIZES,
          "weight_sets": list(weight_sets),
          "stats": stats, "seconds": time.perf_counter() - t0})
    for name, st in stats.items():
        check(st["mismatches"] == 0,
              f"{name} kernel disagrees with its plain version: {st}")

    # -- 4. main path: §5.1 through Simulator.run -------------------------
    def run_51(device, backend="kernel", pipelined=False):
        topo = core.training_cluster_topology(8000)
        state = core.ClusterState.create(topo)
        rsch = core.RSCH(topo, core.RSCHConfig(device=device,
                                               score_backend=backend))
        qsch = core.QSCH(core.QuotaManager({"t0": {0: 10 ** 6}}), rsch,
                         core.QSCHConfig(policy=core.QueuePolicy.BACKFILL))
        sim = core.Simulator(state, qsch, core.SimConfig(
            pipelined_cycles=pipelined))
        jobs = core.training_trace(1000, seed=0, arrival_rate_per_hour=300)
        t = time.perf_counter()
        res = sim.run(jobs)
        return res, time.perf_counter() - t

    run_51(None)                        # warm the CUDA context and numpy
    node_score.node_scores.launches = 0
    node_score.node_scores_slots.launches = 0
    res_gpu, wall_gpu = run_51(None)
    main_launches = {
        "node_scores": node_score.node_scores.launches,
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
    with CallRecorder(rsch_mod, "compute_node_scores_and_slots") as pseam, \
            CallRecorder(rsch_mod, "compute_node_scores") as pseam1:
        busy = device_busy_ms(torch, lambda: run_51(None))
    busy_ms = busy["kernel_ms"] + busy["copy_ms"]
    prof_calls = pseam.calls + pseam1.calls
    copies = {way: count / max(1, prof_calls)
              for way, count in busy["copies"].items()}
    emit({"phase": "main-breakdown", "wall_s": wall_seam,
          "seam_calls": seam.calls, "seam_s": seam.seconds,
          "seam_share": seam.seconds / wall_seam,
          "seam_us_per_call": seam.seconds / max(1, seam.calls) * 1e6,
          "device_kernel_ms": busy["kernel_ms"],
          "device_copy_ms": busy["copy_ms"],
          "device_busy_share": busy_ms / 1e3 / wall_seam if busy_ms else None,
          "profiled_seam_calls": prof_calls, "copies": busy["copies"],
          "copies_per_seam_call": copies})
    check(copies == {"HtoD": 1.0, "DtoH": 1.0},
          f"the seam makes {copies} copies a call, not one each way")

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
    launch_floor_ms = device_ms(torch, lambda: node_score.noop(dev), 50,
                                flush)
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
            k_times = []
            k_ms = device_ms(torch, kcall, 50, flush, k_times)
            bms, by = bound_ms(n_scored, 8)
            scale.append({
                "nodes": n, "subset_scoring": subset,
                "nodes_scored": n_scored,
                "cycle_ms": float(np.median(times)) * 1e3,
                "cycle_ms_plain": float(np.median(plain_times)) * 1e3,
                "kernel_ms": k_ms, "kernel_ms_median": median(k_times),
                "wrapper_ms_back_to_back": device_ms(torch, kcall, 200),
                "plain_ms": device_ms(torch, pcall, 20, flush),
                "bound_ms": bms, "bound_by": by,
                "launch_floor_ms": launch_floor_ms})
            emit({"phase": "scale", **scale[-1]})
            full_cols, full_kw = cols, kw
    # Each kernel's own device duration at the 1M-node full-width pass,
    # from the profiler, for the kernels line.
    slots_call = lambda: node_score.node_scores_slots(*full_cols, **full_kw)
    score_call = lambda: node_score.node_scores(*full_cols, **full_kw)
    prof_slots, prof_score = (
        profiled_kernel_ms(torch, fn, flush, "node_score_kernel")
        for fn in (slots_call, score_call))

    # -- 6b. seam-time: the packed seam against the per-column one -----
    col_dtypes = (np.int32, np.int32, np.bool_, np.float32, np.float32)

    def per_column_seam(free, used, mask, gload, topo, request, g, w):
        """The seam as it was before the packed one: five uploads from
        pageable memory, the kernel, two downloads."""
        cols = tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=dt))
                     .to(dev) for a, dt in zip((free, used, mask, gload,
                                                 topo), col_dtypes))
        s, sl = ops.node_scores_and_slots(*cols, request=request,
                                          gpus_per_node=g, weights=w)
        return s.cpu().numpy(), sl.cpu().numpy().astype(np.int64)

    def packed_seam(*args):
        return core.compute_node_scores_and_slots(*args, backend="kernel")

    staging = core.scoring._staging_for(None)

    def rebuilt_seam(*args):
        """The packed seam with its cached views dropped first, so it
        builds them again, as an uncached seam would on every call."""
        staging._layouts.clear()
        return packed_seam(*args)

    seams = {"per_column": per_column_seam, "packed": packed_seam,
             "packed_views_rebuilt": rebuilt_seam}
    for n in SEAM_SIZES:
        rng = np.random.default_rng(n)
        free = rng.integers(0, 9, size=n).astype(np.int32)
        used = (rng.random(n) * (9 - free)).astype(np.int32)
        table = (free, used, rng.random(n) < 0.8,
                 rng.random(n).astype(np.float32),
                 rng.random(n).astype(np.float32))
        args = (*table, 2, 8, core.E_BINPACK)
        host = core.node_scores_np(*args)
        host_slots = np.where(table[2] & (free >= 2), free // 2, 0)
        for name, fn in seams.items():
            got, got_slots = fn(*args)
            check(np.array_equal(got.view(np.int32), host.view(np.int32))
                  and np.array_equal(got_slots, host_slots),
                  f"the {name} seam disagrees with numpy at {n} nodes")
        times = {name: [] for name in seams}
        for name in (*seams, *reversed(seams)):
            for _ in range(SEAM_CALLS[n]):
                t = time.perf_counter()
                seams[name](*args)
                times[name].append(time.perf_counter() - t)
        med = {name: float(np.median(ts)) * 1e6 for name, ts in times.items()}
        emit({"phase": "seam-time", "nodes": n,
              "calls_per_turn": SEAM_CALLS[n],
              "per_column_us_median": med["per_column"],
              "packed_us_median": med["packed"],
              "packed_views_rebuilt_us_median": med["packed_views_rebuilt"],
              "packed_faster": med["packed"] < med["per_column"]})

    # -- 6c. tidal: the co-scheduling day, card against numpy ----------
    tidal = run_tidal(core, node_score, rsch_mod)

    # -- 6d. pipeline: the §5.1 replay with cycle pipelining -----------
    pipe = run_pipeline(node_score, rsch_mod, run_51, res_gpu)

    # -- 6e-6g. elastic training, federation, self-tuning --------------
    elastic = run_elastic(core, np, node_score)
    federation = run_federation(core, np, node_score, rsch_mod)
    tuning = run_tuning(core, np, node_score, rsch_mod)

    # -- 7. wkv-sweep: the WKV kernel against its plain version ---------
    f32, bf16 = torch.float32, torch.bfloat16
    wkv_types = {"f32": (f32,) * 4, "bf16": (bf16,) * 4,
                 "mixed": (bf16, bf16, bf16, f32)}
    sweep, t0 = [], time.perf_counter()

    def errors(group, tname, got, want) -> tuple:
        """(max abs error, max rel error, tolerance, within it): allclose
        at the reference's tolerance for the reference shapes and for
        T <= 64 in the edge and strong groups, else max|Δ| / max|want|."""
        (o, sT), (po, psT) = got, want
        abs_err = max(float((o - po).abs().max()),
                      float((sT - psT).abs().max()))
        rel = max(rel_err(o, po), rel_err(sT, psT))
        finite = bool(torch.isfinite(o).all() and torch.isfinite(sT).all())
        if group == "reference" or (group in ("edge", "strong")
                                    and o.shape[1] <= 64):
            tol = WKV_TOL_F32 if tname == "f32" else WKV_TOL_BF16
            ok = all(torch.allclose(a, b, atol=tol, rtol=tol)
                     for a, b in ((o, po), (sT, psT)))
        else:
            tol = WKV_TOL_LONG
            ok = rel <= tol
        return abs_err, rel, tol, ok and finite

    strong_shapes = WKV_REF_SHAPES + tuple((2, t, 4, 64)
                                           for t in WKV_STRONG_T)
    for group, shapes in (("reference", WKV_REF_SHAPES),
                          ("long", WKV_LONG_SHAPES),
                          ("serve", (WKV_SERVE_SHAPE,)),
                          ("edge", tuple((2, t, 4, 64) for t in WKV_EDGE_T)),
                          ("strong", strong_shapes)):
        for shape in shapes:
            for tname, types in wkv_types.items():
                args = wkv_inputs(np, torch, shape, types,
                                  strong=group == "strong")
                got = wkv6.wkv6(*args)
                want = wkv6_ref(*args)
                mirror = wkv6_chunked_ref(*args, chunk=wkv6.CHUNK)
                torch.cuda.synchronize()
                abs_err, rel, tol, ok = errors(group, tname, got, want)
                m_abs, m_rel, _, m_ok = errors(group, tname, mirror, want)
                sweep.append({"group": group, "shape": shape,
                              "types": tname, "max_abs_err": abs_err,
                              "max_rel_err": rel, "tol": tol, "ok": ok,
                              "mirror_abs_err": m_abs,
                              "mirror_rel_err": m_rel, "mirror_ok": m_ok})
    emit({"phase": "wkv-sweep", "cases": sweep,
          "worst_abs_err": max(c["max_abs_err"] for c in sweep),
          "worst_rel_err": max(c["max_rel_err"] for c in sweep),
          "mirror_worst_abs_err": max(c["mirror_abs_err"] for c in sweep),
          "seconds": time.perf_counter() - t0})
    bad = [c for c in sweep if not c["mirror_ok"]]
    check(not bad, f"the chunked algorithm's mirror disagrees with the "
                   f"plain version (an algorithm fault): {bad}")
    bad = [c for c in sweep if not c["ok"]]
    check(not bad, f"wkv6 kernel disagrees with its plain version while "
                   f"its algorithm's mirror agrees (a kernel fault): {bad}")

    # -- 7b. wkv-time: chunked kernel against the step kernel, in turns --
    wkv_time = []
    for T in WKV_TIME_T:
        shape = WKV_SERVE_SHAPE[:1] + (T,) + WKV_SERVE_SHAPE[2:]
        args = wkv_inputs(np, torch, shape, (f32,) * 4, seed=T)
        co, csT = wkv6.wkv6(*args)
        so, ssT = wkv6.wkv6_step(*args)
        torch.cuda.synchronize()
        rel = max(rel_err(co, so), rel_err(csT, ssT))
        check(rel <= WKV_TOL_LONG,
              f"chunked and step kernels differ by {rel} at T = {T}")
        turns = {"step": [], "chunked": []}
        for name in ("step", "chunked", "chunked", "step"):
            fn = wkv6.wkv6_step if name == "step" else wkv6.wkv6
            turns[name].append(device_ms(torch, lambda: fn(*args), 10,
                                         flush))
        b_ms, b_by = wkv_bound_ms(shape, 4 * 4)
        step_ms = sum(turns["step"]) / 2
        chunk_ms = sum(turns["chunked"]) / 2
        wkv_time.append({"shape": shape, "step_ms": step_ms,
                         "chunked_ms": chunk_ms, "turns": turns,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "speedup": step_ms / chunk_ms,
                         "chunked_over_bound": chunk_ms / b_ms,
                         "chunked_faster": chunk_ms < step_ms,
                         "max_rel_diff": rel})
        emit({"phase": "wkv-time", **wkv_time[-1]})
    args = wkv_inputs(np, torch, WKV_SERVE_SHAPE, (f32,) * 4)
    split = device_busy_ms(torch, lambda: [wkv6.wkv6(*args)
                                           for _ in range(10)])
    long_T = WKV_TIME_T[-1]
    per_step = {}
    for heads in (1, WKV_SERVE_SHAPE[2]):
        args = wkv_inputs(np, torch, (1, long_T, heads, WKV_SERVE_SHAPE[3]),
                          (f32,) * 4)
        per_step[heads] = device_ms(torch, lambda: wkv6.wkv6(*args), 10,
                                    flush) / -(-long_T // wkv6.CHUNK) * 1e3
    emit({"phase": "wkv-time-split", "shape": WKV_SERVE_SHAPE,
          "launches": 10, "device_ms_by_kernel": split["top"],
          "T": long_T, "us_per_chunk_step_by_heads": per_step})

    # -- 8. serve: rwkv6-3b at full width behind the ServeEngine -------
    cfg = get_arch(SERVE_ARCH)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0), torch.float32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = model.state_dict()
    n_params = model.n_params()
    param_bytes = sum(t.numel() * t.element_size() for t in params.values())
    lens, prompts = serve_prompts(np, cfg.vocab, SERVE_REQUESTS)

    def engine_run(reqs, timings=None):
        return serve_run(torch, cfg, params, dev, reqs, timings,
                         batch_size=SERVE_BATCH)

    engine_run([(prompts[0][:64], 2), (prompts[1][:64], 2)])   # warm-up
    timings = {"_prefill": [], "_decode": []}
    node_score.node_scores.launches = 0
    node_score.node_scores_slots.launches = 0
    wkv6.wkv6.launches = 0
    wkv6.wkv6_step.launches = 0
    engine, finished, serve_wall = engine_run(
        [(p, SERVE_NEW) for p in prompts], timings)
    serve_launches = {"wkv6": wkv6.wkv6.launches,
                      "wkv6_step": wkv6.wkv6_step.launches,
                      "node_scores": node_score.node_scores.launches,
                      "node_scores_slots":
                          node_score.node_scores_slots.launches}
    check(engine.prefill_calls > 0 and serve_launches["wkv6"] > 0,
          f"serve path never launched the WKV kernel: {serve_launches}")
    check(serve_launches["wkv6"] == cfg.n_layers * engine.prefill_calls,
          f"wkv6 launches {serve_launches['wkv6']} != {cfg.n_layers} x "
          f"{engine.prefill_calls} prefills")
    check(serve_launches["wkv6_step"] == 0,
          "serve path launched the step kernel")
    check(len(finished) == SERVE_REQUESTS
          and all(len(r.generated) == SERVE_NEW for r in finished),
          "serve left requests unfinished")
    check(all(ok for log in timings.values() for _, ok, _ in log),
          "serve produced non-finite logits")
    pre_s = [s for s, _, _ in timings["_prefill"]]
    dec_s = [s for s, _, _ in timings["_decode"]]
    emit({"phase": "serve", "arch": SERVE_ARCH, "dtype": "float32",
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "params": n_params, "param_bytes": param_bytes,
          "init_s": init_s, "requests": len(finished),
          "prompt_tokens": int(lens.sum()),
          "prompt_lens": [int(n) for n in lens],
          "prefill_calls": engine.prefill_calls,
          "prefill_ms_per_request": float(np.mean(pre_s)) * 1e3,
          "prefill_ms": [s * 1e3 for s in pre_s],
          "prefill_tokens_per_s": float(lens.sum()) / sum(pre_s),
          "decode_steps": len(dec_s), "decode_batch": SERVE_BATCH,
          "decode_ms_per_step_median": float(np.median(dec_s)) * 1e3,
          "decode_ms_per_step_mean": float(np.mean(dec_s)) * 1e3,
          "wall_s": serve_wall, "launches": serve_launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    # -- 8b. where a prefill's and a decode step's time goes -----------
    # Profiled separately; the wall times are the unprofiled ones above
    # (the first prefill is prompts[0]'s).
    pre_busy = device_busy_ms(torch, lambda: engine.model.prefill(
        {"tokens": torch.from_numpy(prompts[0][None])}))
    dec_busy = device_busy_ms(torch, lambda: engine.model.decode_step(
        engine.cache, torch.zeros(SERVE_BATCH, dtype=torch.int32)))
    pre_wall_ms = pre_s[0] * 1e3
    dec_wall_ms = float(np.median(dec_s)) * 1e3
    emit({"phase": "serve-breakdown",
          "prefill": {"prompt_len": len(prompts[0]),
                      "wall_ms": pre_wall_ms, **pre_busy,
                      "busy_share": (pre_busy["kernel_ms"]
                                     + pre_busy["copy_ms"]) / pre_wall_ms},
          "decode": {"batch": SERVE_BATCH, "wall_ms": dec_wall_ms,
                     **dec_busy,
                     "busy_share": (dec_busy["kernel_ms"]
                                    + dec_busy["copy_ms"]) / dec_wall_ms}})

    # -- 9. serve-parity: WKV kernel against the plain step loop -------
    kern_model = engine.model
    scan_model = Model(cfg, device=dev, wkv_backend="scan")
    scan_model.load_state_dict(params, assign=True)

    parity = []
    for prompt in prompts[:2]:
        batch = {"tokens": torch.from_numpy(prompt[None])}
        t = time.perf_counter()
        lk, ck = kern_model.prefill(batch)
        torch.cuda.synchronize()
        k_s = time.perf_counter() - t
        t = time.perf_counter()
        ls, cs = scan_model.prefill(batch)
        torch.cuda.synchronize()
        s_s = time.perf_counter() - t
        logit_rel = rel_err(lk, ls)
        state_rel = max(rel_err(ck["layers"]["state"][i],
                                cs["layers"]["state"][i])
                        for i in range(cfg.n_layers))
        xlast_rel = max(rel_err(ck["layers"][key], cs["layers"][key])
                        for key in ("x_last_t", "x_last_c"))
        check(max(logit_rel, state_rel, xlast_rel) <= PARITY_TOL,
              f"kernel prefill differs from scan: logits {logit_rel}, "
              f"states {state_rel}, x_last {xlast_rel}")
        toks_k, toks_s, first_diff, gap = [], [], None, None
        for step in range(SERVE_NEW):
            tk, ts = int(torch.argmax(lk[0])), int(torch.argmax(ls[0]))
            toks_k.append(tk)
            toks_s.append(ts)
            if tk != ts:
                first_diff = step
                gap = top2_gap(ls[0]) / float(ls[0].abs().max())
                check(gap < PARITY_TOL,
                      f"greedy tokens differ at step {step} with a scan "
                      f"top-2 gap of {gap} of max|logit|")
                break
            tok = torch.tensor([tk], dtype=torch.int32)
            lk, ck = kern_model.decode_step(ck, tok)
            ls, cs = scan_model.decode_step(cs, tok)
        parity.append({"prompt_len": len(prompt), "logit_rel": logit_rel,
                       "state_rel": state_rel, "x_last_rel": xlast_rel,
                       "tokens_equal": first_diff is None,
                       "first_diff_step": first_diff,
                       "scan_top2_gap_rel": gap,
                       "prefill_s_kernel": k_s, "prefill_s_scan": s_s})
    emit({"phase": "serve-parity", "tol": PARITY_TOL, "cases": parity})
    del scan_model, kern_model, engine, model, params, ck, cs, lk, ls
    free_memory(torch)

    counters = (node_score.node_scores, node_score.node_scores_slots,
                wkv6.wkv6, wkv6.wkv6_step)
    # -- 9b. fabric: routers, build_engine, demand to the autoscaler -----
    fabric = run_fabric(torch, np, dev, counters, smi)
    free_memory(torch)

    # -- 10-12. glm4-9b at full width: serve, breakdown, parity ---------
    run_dense(torch, np, dev, get_arch(DENSE_ARCH), counters, smi)
    free_memory(torch)

    # -- 13-15. mixtral-8x7b at full width, 8 of 32 layers -------------
    moe_cfg = get_arch(MOE_ARCH)
    moe_cut = dataclasses.replace(moe_cfg, n_layers=MOE_CUT_LAYERS,
                                  name=f"{MOE_ARCH}-l{MOE_CUT_LAYERS}")
    run_moe(torch, np, dev, moe_cut, get_arch(MOE_TOP1_ARCH, smoke=True),
            counters, smi)
    free_memory(torch)

    # -- 16-18. hymba-1.5b FULL ----------------------------------------
    run_hybrid(torch, np, dev, get_arch(HYBRID_ARCH), counters, smi)
    free_memory(torch)

    # -- 19-20. seamless-m4t-large-v2 FULL -----------------------------
    run_encdec(torch, np, dev, get_arch(ENCDEC_ARCH), counters, smi)
    free_memory(torch)

    # -- 21-22. llava-next-34b at full width, 16 of 60 layers ----------
    run_vlm(torch, np, dev, dataclasses.replace(
        get_arch(VLM_ARCH), n_layers=VLM_CUT_LAYERS,
        name=f"{VLM_ARCH}-l{VLM_CUT_LAYERS}"), counters, smi)
    free_memory(torch)

    # -- 23-24. rwkv6-3b FULL, AdamW steps -----------------------------
    run_train(torch, np, dev, get_arch(TRAIN_ARCH), counters, smi)
    free_memory(torch)

    # -- kernels line: timed at the 1M-node full-width pass ------------
    full = scale[-1]
    n1m = full["nodes_scored"]
    p_score = device_ms(
        torch, lambda: node_scores_ref(*full_cols, **full_kw), 20, flush)
    b_score, by_score = bound_ms(n1m, 4)
    s_times = []
    k_score = device_ms(torch, score_call, 50, flush, s_times)
    kernels = [
        {"name": "node_scores_slots", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/node_score.cu",
         "replaces": "src/repro/kernels/node_score.py:57",
         "launches": main_launches["node_scores_slots"],
         "launches_path": "§5.1 Simulator.run",
         "launches_tidal": tidal["launches"]["node_scores_slots"],
         "launches_pipeline": pipe["launches"]["node_scores_slots"],
         "launches_fabric_demand": fabric["demand"]["launches"],
         "launches_elastic": elastic["launches"]["node_scores_slots"],
         "launches_federation": federation["launches"]["node_scores_slots"],
         "launches_tuning": tuning["launches"]["node_scores_slots"],
         "mismatches": stats["slots"]["mismatches"],
         "max_abs_err": stats["slots"]["max_abs_err"],
         "ms": full["kernel_ms"], "plain_ms": full["plain_ms"],
         "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
         "library_ms": None, "nodes": n1m,
         "ms_median": full["kernel_ms_median"],
         "profiled_ms": prof_slots, "launch_floor_ms": launch_floor_ms},
        {"name": "node_scores", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/node_score.cu",
         "replaces": "src/repro/kernels/node_score.py:41",
         "launches": per_pod_launches,
         "launches_path": "per-pod gang cycle, 10k nodes",
         "launches_tidal": tidal["launches"]["node_scores"],
         "launches_pipeline": pipe["launches"]["node_scores"],
         "launches_elastic": elastic["launches"]["node_scores"],
         "launches_federation": federation["launches"]["node_scores"],
         "launches_tuning": tuning["launches"]["node_scores"],
         "mismatches": stats["score"]["mismatches"],
         "max_abs_err": stats["score"]["max_abs_err"],
         "ms": k_score, "plain_ms": p_score, "bound_ms": b_score,
         "bound_by": by_score, "library_ms": None, "nodes": n1m,
         "ms_median": median(s_times), "profiled_ms": prof_score,
         "launch_floor_ms": launch_floor_ms},
    ]
    args = wkv_inputs(np, torch, WKV_SERVE_SHAPE, (torch.float32,) * 4)
    w_time = next(c for c in wkv_time if c["shape"] == WKV_SERVE_SHAPE)
    w_plain = device_ms(torch, lambda: wkv6_ref(*args), 3, flush)
    kernels.append(
        {"name": "wkv6", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/wkv6.cu",
         "replaces": "src/repro/kernels/wkv6.py:47",
         "launches": serve_launches["wkv6"],
         "launches_path": f"serve: {SERVE_REQUESTS} requests, "
                          f"{SERVE_ARCH} full width",
         "launches_fabric": fabric["engines"][SERVE_ARCH]["launches"]["wkv6"],
         "max_abs_err": max(c["max_abs_err"] for c in sweep),
         "max_rel_err": max(c["max_rel_err"] for c in sweep),
         "ms": w_time["chunked_ms"], "step_ms": w_time["step_ms"],
         "plain_ms": w_plain, "bound_ms": w_time["bound_ms"],
         "bound_by": w_time["bound_by"], "library_ms": None,
         "launch_floor_ms": launch_floor_ms,
         "shape": WKV_SERVE_SHAPE, "types": "f32"})
    print(json.dumps({"kernels": kernels,
                      "library_note": "no single PyTorch call computes the "
                                      "fused filter+score(+slots) pass or "
                                      "the WKV recurrence",
                      "dense_note": f"the {DENSE_ARCH} path runs no "
                                    "hand-written kernel: attention, RoPE "
                                    "and the MLP are plain torch",
                      "moe_hybrid_note": f"the {MOE_ARCH} and {HYBRID_ARCH} "
                                         "paths run no hand-written kernel: "
                                         "the MoE dispatch, the expert "
                                         "SwiGLU and the selective scan are "
                                         "plain torch, as the reference's "
                                         "are plain jnp",
                      "encdec_vlm_train_note": f"the {ENCDEC_ARCH}, "
                                               f"{VLM_ARCH} and train paths "
                                               "run no hand-written kernel: "
                                               "the encoder, cross-attention, "
                                               "patch prefix, loss and AdamW "
                                               "are plain torch, as the "
                                               "reference's are plain jnp; "
                                               "training runs RWKV-6 through "
                                               "the plain scan, as the "
                                               "reference's train step does "
                                               "(the WKV kernel has no "
                                               "backward)"}),
          flush=True)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
