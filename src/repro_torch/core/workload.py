"""Synthetic workload generation matching the paper's job population.

§2 / §5.1.1 describe the shape of real AI-cluster workloads:

* >90 % of jobs use fewer than 8 GPUs, yet contribute <10 % of GPU-time;
* jobs of >=256 GPUs, though rare, consume over half of total GPU-time;
* the §5.1 test cluster sees sizes from 1 to 2048 GPUs.

``training_trace`` reproduces that distribution (validated in
``benchmarks/fig2_job_distribution.py``); ``inference_trace`` produces the
§5.2 multi-tenant replica fleets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .job import Job, JobKind, PRIO_HIGH, PRIO_LOW, PRIO_NORMAL

# (n_gpus, probability, mean duration scale) — probabilities follow the
# paper's ">90% below 8 GPUs" long tail; duration scales are tuned so the
# GPU-time shares land on the paper's ">50% from >=256-GPU jobs" /
# "<10% from <8-GPU jobs" split (checked by the Fig 2 benchmark).
TRAIN_SIZE_TABLE: Sequence[Tuple[int, float, float]] = (
    (1, 0.40, 0.6),
    (2, 0.22, 0.6),
    (4, 0.18, 0.8),
    (8, 0.11, 1.0),
    (16, 0.03, 1.2),
    (32, 0.02, 1.5),
    (64, 0.013, 2.0),
    (128, 0.009, 3.0),
    (256, 0.008, 5.0),
    (512, 0.005, 6.0),
    (1024, 0.003, 8.0),
    (2048, 0.002, 10.0),
)


@dataclasses.dataclass
class TraceStats:
    jobs_by_size: Dict[int, int]
    gpu_time_by_size: Dict[int, float]

    def job_fraction_below(self, n: int) -> float:
        total = sum(self.jobs_by_size.values())
        small = sum(c for s, c in self.jobs_by_size.items() if s < n)
        return small / total if total else 0.0

    def gpu_time_fraction_at_least(self, n: int) -> float:
        total = sum(self.gpu_time_by_size.values())
        big = sum(c for s, c in self.gpu_time_by_size.items() if s >= n)
        return big / total if total else 0.0


def _pods_for(n_gpus: int, gpus_per_node: int) -> Tuple[int, int]:
    """Split a request into (n_pods, gpus_per_pod): multi-node jobs use
    whole-node pods; small jobs are single-pod."""
    if n_gpus <= gpus_per_node:
        return 1, n_gpus
    if n_gpus % gpus_per_node:
        raise ValueError("multi-node sizes must be node multiples")
    return n_gpus // gpus_per_node, gpus_per_node


def training_trace(n_jobs: int, *, seed: int = 0,
                   arrival_rate_per_hour: float = 120.0,
                   mean_duration_s: float = 7200.0,
                   gpus_per_node: int = 8,
                   gpu_type: int = 0,
                   gpu_types: Optional[Sequence[int]] = None,
                   type_probs: Optional[Sequence[float]] = None,
                   tenants: Sequence[str] = ("t0",),
                   tenant_regions: Optional[Dict[str, str]] = None,
                   start_uid: int = 0) -> List[Job]:
    """Poisson arrivals with the §5.1.1 size/duration population.

    ``gpu_types`` (mirroring ``inference_trace``) samples each job's GPU
    model from a mix — optionally weighted by ``type_probs`` — instead of
    pinning the whole trace to one ``gpu_type``; heterogeneous-pool and
    federation scenarios need mixed traces without hand-building them.
    Types draw from a rng derived from ``seed`` so the base population
    (sizes, arrivals, durations, tenants) is identical to the
    homogeneous trace with the same seed — heterogeneity A/Bs compare
    the SAME jobs.  ``tenant_regions`` stamps each job's home region
    from its tenant (multi-region tenancy for the federation GSCH).
    Both default to off and leave existing seeded traces untouched.
    """
    rng = np.random.default_rng(seed)
    type_rng = np.random.default_rng([seed, 0x67747970])  # "ggtyp"
    sizes = np.asarray([s for s, _, _ in TRAIN_SIZE_TABLE])
    probs = np.asarray([p for _, p, _ in TRAIN_SIZE_TABLE])
    probs = probs / probs.sum()
    dur_scale = {s: d for s, _, d in TRAIN_SIZE_TABLE}
    tprobs = None
    if gpu_types is not None and type_probs is not None:
        tprobs = np.asarray(list(type_probs), dtype=float)
        tprobs = tprobs / tprobs.sum()
    inter = rng.exponential(3600.0 / arrival_rate_per_hour, size=n_jobs)
    arrivals = np.cumsum(inter)
    jobs: List[Job] = []
    for i in range(n_jobs):
        n_gpus = int(rng.choice(sizes, p=probs))
        n_pods, per_pod = _pods_for(n_gpus, gpus_per_node)
        duration = float(rng.exponential(
            mean_duration_s * dur_scale[n_gpus]))
        duration = max(60.0, duration)
        tenant = str(rng.choice(list(tenants)))
        if gpu_types is not None:
            jtype = int(type_rng.choice(list(gpu_types), p=tprobs))
        else:
            jtype = gpu_type
        jobs.append(Job(
            uid=start_uid + i,
            tenant=tenant,
            gpu_type=jtype,
            n_pods=n_pods,
            gpus_per_pod=per_pod,
            kind=JobKind.TRAIN,
            gang=True,
            priority=PRIO_NORMAL,
            submit_time=float(arrivals[i]),
            duration=duration,
            region=(tenant_regions or {}).get(tenant),
        ))
    return jobs


def inference_trace(n_jobs: int, *, seed: int = 0,
                    arrival_rate_per_hour: float = 30.0,
                    mean_duration_s: float = 4 * 3600.0,
                    gpu_types: Sequence[int] = (0,),
                    tenants: Sequence[str] = ("t0", "t1", "t2"),
                    tenant_regions: Optional[Dict[str, str]] = None,
                    max_replicas: int = 4,
                    start_uid: int = 100_000) -> List[Job]:
    """§5.2 inference fleets: small per-replica pods, several replicas,
    high priority, non-gang (pod-level admission)."""
    rng = np.random.default_rng(seed)
    inter = rng.exponential(3600.0 / arrival_rate_per_hour, size=n_jobs)
    arrivals = np.cumsum(inter)
    jobs: List[Job] = []
    for i in range(n_jobs):
        per_pod = int(rng.choice([1, 1, 2, 2, 4, 8]))
        replicas = int(rng.integers(1, max_replicas + 1))
        tenant = str(rng.choice(list(tenants)))
        jobs.append(Job(
            uid=start_uid + i,
            tenant=tenant,
            region=(tenant_regions or {}).get(tenant),
            gpu_type=int(rng.choice(list(gpu_types))),
            n_pods=replicas,
            gpus_per_pod=per_pod,
            kind=JobKind.INFER,
            gang=False,
            priority=PRIO_HIGH,
            submit_time=float(arrivals[i]),
            duration=max(600.0, float(rng.exponential(mean_duration_s))),
        ))
    return jobs


DAY_S = 86_400.0


def diurnal_demand(t: float, base: float, peak: float,
                   period: float = DAY_S,
                   peak_hour: float = 14.0) -> float:
    """Smooth diurnal (tidal) demand curve.

    Raised cosine over one ``period``: ``peak`` at ``peak_hour`` (in
    hours from the period start), falling to ``base`` half a period
    away.  This is the demand signal the tidal autoscaler tracks —
    inference traffic that crests mid-afternoon and bottoms out
    overnight (§2 "inference services" diurnal load; the reclaimed
    night capacity backfills training).
    """
    frac = (t % period) / period
    x = np.cos(2.0 * np.pi * (frac - peak_hour * 3600.0 / period))
    return float(base + (peak - base) * (x + 1.0) / 2.0)


def backfill_training_trace(n_jobs: int, *, seed: int = 0,
                            sizes: Sequence[int] = (8, 16, 32, 64),
                            size_probs: Sequence[float] = (.3, .3, .25,
                                                           .15),
                            duration_range_h: Tuple[float, float] = (3.0,
                                                                     5.0),
                            submit_window_s: float = 3600.0,
                            gpus_per_node: int = 8,
                            gpu_type: int = 0,
                            tenant: str = "batch",
                            start_uid: int = 500_000) -> List[Job]:
    """Low-priority, preemptible training backlog for tidal scenarios:
    chunky jobs submitted inside one window, deep enough to soak up
    whatever the tide hands back overnight and be preempted away at the
    morning ramp (exercising PriorityPreempt)."""
    rng = np.random.default_rng(seed)
    lo_h, hi_h = duration_range_h
    jobs: List[Job] = []
    for i in range(n_jobs):
        n_gpus = int(rng.choice(list(sizes), p=list(size_probs)))
        n_pods, per_pod = _pods_for(max(n_gpus, 1), gpus_per_node)
        jobs.append(Job(
            uid=start_uid + i, tenant=tenant, gpu_type=gpu_type,
            n_pods=n_pods, gpus_per_pod=per_pod,
            priority=PRIO_LOW, preemptible=True,
            submit_time=float(rng.uniform(0.0, submit_window_s)),
            duration=float(rng.uniform(lo_h, hi_h)) * 3600.0))
    return jobs


# ---------------------------------------------------------------------------
# Request-level serving workload (the serving fabric's input)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class QueryClass:
    """One class of queries in the serving mix.

    ``quality_floor`` is the minimum model capability (0..1, same scale
    as ``ReplicaSpec.capability``) that produces an acceptable answer;
    ``latency_slo_s`` bounds end-to-end latency (queue wait + prefill +
    decode).  ``weight`` is the class's share of the arrival mix."""
    name: str
    prompt_mean: int = 128          # mean prompt tokens (geometric-ish)
    output_mean: int = 64           # mean output tokens
    quality_floor: float = 0.0
    latency_slo_s: float = 30.0
    weight: float = 1.0


#: A mixed production-style query population: short chat turns dominate,
#: long-document summarisation is rare but heavy, code queries demand a
#: capable model, background embedding-style traffic tolerates anything.
DEFAULT_QUERY_CLASSES: Tuple[QueryClass, ...] = (
    QueryClass("chat", prompt_mean=96, output_mean=48,
               quality_floor=0.35, latency_slo_s=15.0, weight=0.55),
    QueryClass("code", prompt_mean=256, output_mean=128,
               quality_floor=0.70, latency_slo_s=45.0, weight=0.20),
    QueryClass("summarize", prompt_mean=1024, output_mean=96,
               quality_floor=0.50, latency_slo_s=90.0, weight=0.10),
    QueryClass("batch", prompt_mean=192, output_mean=32,
               quality_floor=0.0, latency_slo_s=300.0, weight=0.15),
)


@dataclasses.dataclass
class ServeRequest:
    """One query arriving at the serving fabric router."""
    uid: int
    qclass: QueryClass
    arrival_s: float
    prompt_tokens: int
    output_tokens: int

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.output_tokens

    @property
    def deadline_s(self) -> float:
        return self.arrival_s + self.qclass.latency_slo_s


def request_trace(n_requests: int, *, seed: int = 0,
                  classes: Sequence[QueryClass] = DEFAULT_QUERY_CLASSES,
                  base_rps: float = 2.0, peak_rps: float = 10.0,
                  period_s: float = DAY_S, peak_hour: float = 14.0,
                  burst_rate_per_hour: float = 2.0,
                  burst_duration_s: float = 120.0,
                  burst_multiplier: float = 4.0) -> List[ServeRequest]:
    """Diurnal + bursty request arrivals over a mixed query-class population.

    A nonhomogeneous Poisson process sampled by thinning: the base rate
    rides :func:`diurnal_demand` between ``base_rps`` and ``peak_rps``
    (``period_s`` compresses a whole diurnal cycle for fast benches),
    with Poisson-arriving burst windows that multiply the instantaneous
    rate by ``burst_multiplier`` for ``burst_duration_s`` — the "sudden
    hot query" spikes that separate load-aware from load-blind routing.
    Per-request prompt/output lengths are geometric around the class
    means (min 4 / min 1 tokens)."""
    rng = np.random.default_rng(seed)
    cls = list(classes)
    weights = np.asarray([c.weight for c in cls], float)
    weights = weights / weights.sum()
    # Burst window starts: Poisson over a generous horizon.
    horizon = period_s * max(4.0, 8.0 * n_requests / (base_rps * period_s))
    n_bursts = rng.poisson(burst_rate_per_hour * horizon / 3600.0)
    burst_starts = np.sort(rng.uniform(0.0, horizon, size=n_bursts))

    def rate(t: float) -> float:
        r = diurnal_demand(t, base_rps, peak_rps, period=period_s,
                           peak_hour=peak_hour)
        j = np.searchsorted(burst_starts, t, side="right") - 1
        if j >= 0 and t - burst_starts[j] < burst_duration_s:
            r *= burst_multiplier
        return r

    rate_max = peak_rps * burst_multiplier
    out: List[ServeRequest] = []
    t = 0.0
    while len(out) < n_requests:
        t += float(rng.exponential(1.0 / rate_max))
        if rng.uniform() > rate(t) / rate_max:
            continue                      # thinned away
        ci = int(rng.choice(len(cls), p=weights))
        c = cls[ci]
        out.append(ServeRequest(
            uid=len(out),
            qclass=c,
            arrival_s=t,
            prompt_tokens=max(4, int(rng.geometric(1.0 / c.prompt_mean))),
            output_tokens=max(1, int(rng.geometric(1.0 / c.output_mean))),
        ))
    return out


def trace_stats(jobs: Sequence[Job]) -> TraceStats:
    by_size: Dict[int, int] = {}
    gpu_time: Dict[int, float] = {}
    for j in jobs:
        by_size[j.n_gpus] = by_size.get(j.n_gpus, 0) + 1
        gpu_time[j.n_gpus] = gpu_time.get(j.n_gpus, 0.0) \
            + j.n_gpus * j.duration
    return TraceStats(jobs_by_size=by_size, gpu_time_by_size=gpu_time)
