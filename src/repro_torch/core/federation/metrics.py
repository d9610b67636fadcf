"""Federated metric aggregation: global GAR/SOR/GFR/JWTD + balance.

Members sample independently (their chains can drain at different
times), so the global GAR series is built on the UNION of sample times
with step-hold semantics per member — each member contributes its last
known (allocated, capacity) pair at every union timestamp.  SOR needs
no alignment at all: it is Σ allocated GPU-seconds / Σ capacity
GPU-seconds over the member recorders' accumulators.

The **cross-cluster balance index** is Jain's fairness index over the
members' time-averaged utilization (their SOR):

    J = (Σ uᵢ)² / (M · Σ uᵢ²)   ∈ (1/M, 1]

1.0 = perfectly even load; 1/M = all load on one member.  Spillover
routing should push J up against static partitioning.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..job import Job, summarize_waits
from ..metrics import MetricsRecorder, waiting_percentile

__all__ = ["jain_index", "waiting_percentile", "allocated_gar",
           "FederatedMetrics"]


def jain_index(values: Sequence[float]) -> float:
    v = np.asarray(list(values), dtype=float)
    if len(v) == 0 or not (v > 0).any():
        return 1.0
    return float(v.sum() ** 2 / (len(v) * (v ** 2).sum()))


def allocated_gar(jobs: Sequence[Job], capacity_gpus: int,
                  t_max: float, default_end: Optional[float] = None
                  ) -> float:
    """EXACT time-averaged global GAR over ``[0, t_max]`` from job
    placement intervals (GPU-seconds allocated / capacity x window).

    The sampled :meth:`FederatedMetrics.mean_gar` estimate step-holds
    between 300 s samples, which biases small-cluster A/Bs by more than
    the effect under test; for a static-capacity federation the
    interval sum is exact.  ``default_end`` stands in for jobs still
    running at the horizon."""
    total = 0.0
    for j in jobs:
        if j.start_time is None:
            continue
        end = j.end_time if j.end_time is not None else default_end
        if end is None:
            end = t_max
        total += j.n_gpus * max(0.0, min(end, t_max) - j.start_time)
    denom = float(capacity_gpus) * t_max
    return total / denom if denom > 0 else 0.0


@dataclasses.dataclass
class FederatedMetrics:
    names: List[str]
    recorders: List[MetricsRecorder]

    # ------------------------------------------------------------------
    def global_gar_series(self) -> Tuple[np.ndarray, np.ndarray]:
        """(t, GAR) on the union of member sample times (step-hold)."""
        times = sorted({s.t for r in self.recorders for s in r.samples})
        if not times:
            return np.asarray([]), np.asarray([])
        union = np.asarray(times)
        alloc = np.zeros_like(union)
        cap = np.zeros_like(union)
        for r in self.recorders:
            if not r.samples:
                continue
            ts = np.asarray([s.t for s in r.samples])
            al = np.asarray([float(s.allocated) for s in r.samples])
            cp = np.asarray([float(s.capacity) for s in r.samples])
            idx = np.searchsorted(ts, union, side="right") - 1
            have = idx >= 0
            alloc[have] += al[np.maximum(idx, 0)][have]
            cap[have] += cp[np.maximum(idx, 0)][have]
        gar = np.where(cap > 0, alloc / np.maximum(cap, 1.0), 0.0)
        return union, gar

    def median_gar(self, t_max: Optional[float] = None) -> float:
        """Median global GAR, optionally restricted to samples at
        ``t <= t_max`` (the loaded window: with a fixed workload, a
        scheduler that finishes earlier shows a low-GAR drain tail that
        says nothing about how well it used the loaded period)."""
        t, gar = self.global_gar_series()
        if t_max is not None and len(t):
            gar = gar[t <= t_max]
        return float(np.median(gar)) if len(gar) else 0.0

    def mean_gar(self, t_max: Optional[float] = None) -> float:
        """Time-weighted mean global GAR (step integral over the union
        series), optionally up to ``t_max`` — the right aggregate for
        A/Bs with fixed work: more GPU-seconds delivered inside the
        window means a higher value, regardless of sample spacing."""
        t, gar = self.global_gar_series()
        if t_max is not None and len(t):
            keep = t <= t_max
            t, gar = t[keep], gar[keep]
        if len(t) < 2:
            return float(gar[0]) if len(gar) else 0.0
        end = t_max if t_max is not None else t[-1]
        dt = np.diff(np.append(t, end))
        span = end - t[0]
        return float((gar * dt).sum() / span) if span > 0 else 0.0

    def member_mean_gar(self, t_max: Optional[float] = None
                        ) -> List[float]:
        """Per-member mean GAR (optionally loaded-window-restricted)."""
        out = []
        for r in self.recorders:
            vals = [s.gar for s in r.samples
                    if t_max is None or s.t <= t_max]
            out.append(float(np.mean(vals)) if vals else 0.0)
        return out

    def sor(self) -> float:
        alloc = cap = 0.0
        for r in self.recorders:
            a, c = r.gpu_seconds()
            alloc += a
            cap += c
        return alloc / cap if cap > 0 else 0.0

    def mean_gfr(self) -> float:
        """Capacity-weighted mean of the members' mean GFR."""
        num = den = 0.0
        for r in self.recorders:
            caps = [s.capacity for s in r.samples]
            if not caps:
                continue
            w = float(np.mean(caps))
            num += w * r.mean_gfr()
            den += w
        return num / den if den else 0.0

    def balance_index(self, t_max: Optional[float] = None) -> float:
        """Jain's fairness index (see module doc) over member SOR — or,
        with ``t_max``, over loaded-window per-member mean GAR."""
        if t_max is not None:
            return jain_index(self.member_mean_gar(t_max))
        return jain_index([r.sor() for r in self.recorders])

    # ------------------------------------------------------------------
    def report(self, jobs: Optional[Sequence[Job]] = None
               ) -> Dict[str, object]:
        """Global aggregate + per-member breakdown.  ``jobs`` (the
        federation-wide trace) feeds the global JWTD family; member
        recorders only ever saw the jobs that finished there."""
        per_member = {name: r.report()
                      for name, r in zip(self.names, self.recorders)}
        out: Dict[str, object] = {
            "median_gar": self.median_gar(),
            "sor": self.sor(),
            "mean_gfr": self.mean_gfr(),
            "balance_index": self.balance_index(),
            "members": per_member,
        }
        if jobs is not None:
            out["jwtd_mean"] = summarize_waits(jobs)
            out["jwtd_p90_s"] = waiting_percentile(jobs, 90.0)
        return out

    def publish(self, registry) -> None:
        """Push the federation aggregates into a telemetry registry
        (duck-typed — this module never imports :mod:`repro_torch.obs`):
        global gauges plus per-member SOR labeled ``member=...``."""
        registry.gauge("federation_median_gar",
                       "global median GAR").set(self.median_gar())
        registry.gauge("federation_sor",
                       "global SOR").set(self.sor())
        registry.gauge("federation_mean_gfr",
                       "capacity-weighted mean GFR").set(self.mean_gfr())
        registry.gauge("federation_balance_index",
                       "Jain fairness over member SOR").set(
            self.balance_index())
        sor_gauge = registry.gauge("federation_member_sor",
                                   "per-member SOR")
        for name, r in zip(self.names, self.recorders):
            sor_gauge.set(r.sor(), member=name)
