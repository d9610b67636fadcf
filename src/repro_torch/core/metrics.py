"""The paper's five scheduling metrics (§4): GAR, SOR, GFR, JWTD, JTTED —
plus the dynamics-subsystem family (goodput, MTTR, restart overhead).

* **GAR** (§4.1) — instantaneous allocated/total GPUs.
* **SOR** (§4.2) — time-integrated GPU-hours allocated / GPU-hours
  available; accumulation starts at *scheduling completion* (binding),
  before the container reaches Running, exactly as the paper specifies.
* **GFR** (§4.3) — fraction of nodes neither fully idle nor fully
  occupied.
* **JWTD** (§4.4) — mean waiting time by job-size bucket (queueing +
  scheduling-decision time).
* **JTTED** (§4.5) — per-size NodeNum and NodeNetGroupNum deviation
  ratios vs. the communication-optimal placement.

Dynamics metrics (see ``docs/dynamics.md`` for definitions):

* **goodput** — GPU-seconds of *useful* (completed, non-recomputed)
  work delivered; ``goodput_fraction`` divides by allocated
  GPU-seconds, so recompute debt and restart overhead show up as loss;
* **MTTR** — mean time from an interruption to the rescheduled
  attempt's scheduling completion;
* **restart overhead / lost work** — GPU-seconds burned restoring
  checkpoints and recomputing work since the last checkpoint;
* **interrupted JTTED** — topology deviation of restarted placements
  only (do rescheduled gangs land in worse topology?).

Elastic accounting (``repro_torch.core.elastic``): completed work is credited
at the **ideal plan's** GPU count — a plan-independent yardstick, so
elastic and rigid runs of the same trace compare on identical units
(and non-elastic jobs are untouched: ``ideal_n_gpus == n_gpus``).
Voluntary checkpoint-boundary reshapes flow through
:meth:`MetricsRecorder.on_job_interrupted` with ``reshape=True``: their
cost lands in the shared lost/overhead totals *and* in the dedicated
reshape aggregates, but records no MTTR sample (nothing failed).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cluster import ClusterState
from .job import Job, JobKind, SIZE_BUCKETS, size_bucket
from .topology import ClusterTopology


def waiting_percentile(jobs: Sequence[Job], q: float) -> float:
    """P<q> of job waiting times (s) over started jobs — the headline
    tail-latency metric (P90 JWTD) shared by the federation and elastic
    benchmarks.

    With no started jobs there *is* no percentile: the result is NaN,
    not 0.0 — a zero here read as "perfect tail latency" when it meant
    "no data" (callers treat NaN as missing)."""
    waits = [j.waiting_time for j in jobs if j.waiting_time is not None]
    return float(np.percentile(waits, q)) if waits else float("nan")


@dataclasses.dataclass
class Sample:
    t: float
    gar: float
    gfr: float
    allocated: int
    capacity: int
    queue_depth: int
    # Per-workload breakdown (0 when the caller passes no running set):
    # lets the tidal benchmarks separate training backfill from
    # inference fleet allocation in the same GAR series.
    train_allocated: int = 0
    infer_allocated: int = 0


@dataclasses.dataclass
class JTTEDEntry:
    uid: int
    n_gpus: int
    node_dev: float       # actual nodes / optimal nodes
    group_dev: float      # actual groups / optimal groups
    attempt: int = 0      # 0 = first placement, >0 = post-failure restart


class MetricsRecorder:
    def __init__(self, topology: ClusterTopology) -> None:
        self.topology = topology
        # Optional telemetry facade (repro_torch.obs) — observes every sample
        # and job-lifecycle edge.  None keeps recording byte-identical
        # to an untelemetered run.
        self.obs = None
        self.samples: List[Sample] = []
        self.jtted: List[JTTEDEntry] = []
        self._finished: List[Job] = []
        # Riemann accumulation for SOR.
        self._last_t: Optional[float] = None
        self._last_alloc: int = 0
        self._last_cap: int = 0
        self._gpu_seconds_alloc: float = 0.0
        self._gpu_seconds_cap: float = 0.0
        # Dynamics accounting.
        self._interrupted_at: Dict[int, float] = {}   # uid -> kill time
        self.mttr_samples: List[float] = []
        self.useful_gpu_seconds: float = 0.0          # completed work
        self.lost_gpu_seconds: float = 0.0            # recompute debt
        self.overhead_gpu_seconds: float = 0.0        # restart overhead
        # Elastic reshaping (voluntary checkpoint-boundary interrupts).
        self.reshapes: int = 0
        self.reshape_gpu_seconds: float = 0.0

    # ------------------------------------------------------------------
    def sample(self, t: float, state: ClusterState, queue_depth: int = 0,
               running: Optional[Dict[int, Job]] = None) -> Sample:
        cap = state.total_allocatable()
        alloc = state.total_allocated()
        healthy_nodes = int(state.node_healthy.sum())
        frag = int(state.fragmented_nodes().sum())
        gfr = frag / healthy_nodes if healthy_nodes else 0.0
        gar = alloc / cap if cap else 0.0
        if self._last_t is not None:
            dt = t - self._last_t
            if dt > 0:
                # GPU-hours accrue from scheduling completion (§4.2) — the
                # allocation arrays flip at bind time, so integrating them
                # matches the paper's semantics.
                self._gpu_seconds_alloc += self._last_alloc * dt
                self._gpu_seconds_cap += self._last_cap * dt
        self._last_t, self._last_alloc, self._last_cap = t, alloc, cap
        train_alloc = infer_alloc = 0
        if running:
            for j in running.values():
                if j.kind is JobKind.INFER:
                    infer_alloc += j.n_gpus
                else:
                    train_alloc += j.n_gpus
        s = Sample(t=t, gar=gar, gfr=gfr, allocated=alloc, capacity=cap,
                   queue_depth=queue_depth, train_allocated=train_alloc,
                   infer_allocated=infer_alloc)
        self.samples.append(s)
        if self.obs is not None:
            self.obs.on_sample(s)
        return s

    def on_job_placed(self, job: Job, now: Optional[float] = None) -> None:
        """Record JTTED deviation ratios at placement time (§4.5) and,
        for post-interruption restarts, the MTTR sample."""
        t_int = self._interrupted_at.pop(job.uid, None)
        if t_int is not None:
            t = now if now is not None else job.start_time
            if t is not None:
                self.mttr_samples.append(float(t) - t_int)
        if self.obs is not None:
            self.obs.on_job_placed(job, now)
        if job.placement is None or job.kind is not JobKind.TRAIN:
            return
        topo = self.topology
        actual_nodes = len(job.placement.distinct_nodes())
        actual_groups = len({int(topo.leaf_id[n])
                             for n in job.placement.distinct_nodes()})
        opt_nodes = topo.optimal_node_num(job.n_gpus)
        opt_groups = topo.optimal_group_num(job.n_gpus)
        self.jtted.append(JTTEDEntry(
            uid=job.uid, n_gpus=job.n_gpus,
            node_dev=actual_nodes / max(1, opt_nodes),
            group_dev=actual_groups / max(1, opt_groups),
            attempt=job.attempt))

    def on_job_finished(self, job: Job) -> None:
        self._finished.append(job)
        # Completed jobs delivered their full useful work, whatever got
        # recomputed along the way — credited at the ideal plan's GPU
        # count (== n_gpus for rigid jobs) so elastic and rigid runs
        # measure goodput in the same units.
        self.useful_gpu_seconds += job.original_duration * job.ideal_n_gpus
        if self.obs is not None:
            self.obs.on_job_finished(job)

    def on_job_interrupted(self, job: Job, t: float, lost_work: float,
                           overhead: float, reshape: bool = False) -> None:
        """A failure/drain killed the job at ``t``: ``lost_work`` seconds
        since its last checkpoint must be recomputed and ``overhead``
        seconds of restore cost were added to the next attempt.

        ``reshape=True`` marks a *voluntary* checkpoint-boundary
        reshape (elastic grow): same cost accounting against the shape
        that burned it, but no MTTR sample — nothing failed — and the
        cost is additionally tracked in the reshape aggregates the
        elastic benchmark budgets."""
        if reshape:
            self.reshapes += 1
            self.reshape_gpu_seconds += (max(0.0, lost_work)
                                         + max(0.0, overhead)) * job.n_gpus
        else:
            self._interrupted_at[job.uid] = float(t)
        self.lost_gpu_seconds += max(0.0, lost_work) * job.n_gpus
        self.overhead_gpu_seconds += max(0.0, overhead) * job.n_gpus
        if self.obs is not None:
            self.obs.on_job_interrupted(job, t, lost_work, overhead,
                                        reshape)

    # ------------------------------------------------------------------
    # Aggregates
    # ------------------------------------------------------------------
    def gar_series(self) -> Tuple[np.ndarray, np.ndarray]:
        t = np.asarray([s.t for s in self.samples])
        v = np.asarray([s.gar for s in self.samples])
        return t, v

    def gfr_series(self) -> Tuple[np.ndarray, np.ndarray]:
        t = np.asarray([s.t for s in self.samples])
        v = np.asarray([s.gfr for s in self.samples])
        return t, v

    def median_gar(self) -> float:
        vals = [s.gar for s in self.samples]
        return float(np.median(vals)) if vals else 0.0

    def mean_gfr(self) -> float:
        vals = [s.gfr for s in self.samples]
        return float(np.mean(vals)) if vals else 0.0

    def sor(self) -> float:
        """Cumulative SOR over the observation window (§4.2)."""
        if self._gpu_seconds_cap <= 0:
            return 0.0
        return self._gpu_seconds_alloc / self._gpu_seconds_cap

    def gpu_seconds(self) -> Tuple[float, float]:
        """(allocated, capacity) GPU-seconds accumulated so far — the
        SOR numerator/denominator, exposed so a federation can compute
        the global SOR as Σalloc / Σcap across member recorders."""
        return self._gpu_seconds_alloc, self._gpu_seconds_cap

    def jwtd(self, jobs: Optional[Sequence[Job]] = None
             ) -> Dict[str, float]:
        """Mean waiting time per size bucket (§4.4)."""
        pool = list(jobs) if jobs is not None else self._finished
        acc: Dict[str, List[float]] = {}
        for j in pool:
            w = j.waiting_time
            if w is None:
                continue
            acc.setdefault(size_bucket(j.n_gpus), []).append(w)
        return {b: float(np.mean(acc[b])) for b in SIZE_BUCKETS if b in acc}

    def jwtd_max(self, jobs: Optional[Sequence[Job]] = None
                 ) -> Dict[str, float]:
        pool = list(jobs) if jobs is not None else self._finished
        acc: Dict[str, List[float]] = {}
        for j in pool:
            w = j.waiting_time
            if w is None:
                continue
            acc.setdefault(size_bucket(j.n_gpus), []).append(w)
        return {b: float(np.max(acc[b])) for b in SIZE_BUCKETS if b in acc}

    def jtted_by_bucket(self) -> Dict[str, Tuple[float, float]]:
        """Mean (node_dev, group_dev) per size bucket (§4.5)."""
        return self._jtted_acc(self.jtted)

    def interrupted_jtted_by_bucket(self) -> Dict[str, Tuple[float, float]]:
        """§4.5 deviation ratios restricted to restarted placements —
        the checkpoint-restart path's topology-quality check."""
        return self._jtted_acc([e for e in self.jtted if e.attempt > 0])

    @staticmethod
    def _jtted_acc(entries: Sequence[JTTEDEntry]
                   ) -> Dict[str, Tuple[float, float]]:
        acc: Dict[str, List[JTTEDEntry]] = {}
        for e in entries:
            acc.setdefault(size_bucket(e.n_gpus), []).append(e)
        return {b: (float(np.mean([e.node_dev for e in v])),
                    float(np.mean([e.group_dev for e in v])))
                for b, v in acc.items()}

    # -- dynamics aggregates -------------------------------------------
    def mttr(self) -> float:
        """Mean time from interruption to rescheduled placement (s)."""
        return float(np.mean(self.mttr_samples)) if self.mttr_samples \
            else 0.0

    def goodput_fraction(self) -> float:
        """Useful GPU-seconds / allocated GPU-seconds: 1.0 means no
        recompute debt, no restart overhead, no abandoned work."""
        if self._gpu_seconds_alloc <= 0:
            return 0.0
        return self.useful_gpu_seconds / self._gpu_seconds_alloc

    def reshape_overhead_fraction(self) -> float:
        """Reshape cost / useful work delivered — the elastic
        benchmark's ≤10% budget."""
        if self.useful_gpu_seconds <= 0:
            return 0.0
        return self.reshape_gpu_seconds / self.useful_gpu_seconds

    def report(self) -> Dict[str, object]:
        return {
            "median_gar": self.median_gar(),
            "sor": self.sor(),
            "mean_gfr": self.mean_gfr(),
            "jwtd_mean": self.jwtd(),
            "jwtd_max": self.jwtd_max(),
            "jtted": self.jtted_by_bucket(),
            "goodput_gpu_seconds": self.useful_gpu_seconds,
            "goodput_fraction": self.goodput_fraction(),
            "mttr": self.mttr(),
            "lost_gpu_seconds": self.lost_gpu_seconds,
            "overhead_gpu_seconds": self.overhead_gpu_seconds,
            "reshapes": self.reshapes,
            "reshape_gpu_seconds": self.reshape_gpu_seconds,
            "interrupted_jtted": self.interrupted_jtted_by_bucket(),
        }
