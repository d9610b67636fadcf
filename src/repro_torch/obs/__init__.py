"""Unified telemetry: metric registry, tracing, decision audit, reports.

The observability layer for the whole stack (core QSCH/RSCH cycles,
dynamics, federation members, serving pools, elastic reshapes).  Four
pillars, one attach point:

* :mod:`repro_torch.obs.registry`  — Prometheus-style metrics with
  ring-buffered time series and text/JSON exposition;
* :mod:`repro_torch.obs.trace`     — Chrome trace-event tracer (Perfetto):
  wall-clock program spans at their true times on the profiler's epoch
  (cycles, their phases, RSCH, the score seam, events, collections),
  sim-time job lifecycle spans, cluster instants;
* :mod:`repro_torch.obs.audit`     — kube-scheduler-style decision audit
  (filter eliminations, per-ScorePlugin breakdown of bound nodes,
  preemption rationale) behind the ObserverPlugin extension point;
* :mod:`repro_torch.obs.report`    — ``python -m repro_torch.obs.report``
  bundle renderer (markdown / JSON).

Telemetry is strictly opt-in: with nothing attached, every core hook
is a ``None`` check and scheduling output is byte-identical to an
untelemetered build (``chip_smoke.py``'s ``obs`` phase holds this on
the card and with numpy, beside the ≤5% attached per-cycle overhead
budget).

See ``docs/observability.md``.
"""

from ..core.framework.api import ObserverPlugin
from .audit import (DecisionAudit, FilterStat, PassAudit,
                    PlacementDecision, PreemptionRecord, ScoreBreakdown,
                    build_decision)
from .registry import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                       Metric, MetricRegistry)
from .report import build_report, render_markdown
from .telemetry import CycleSpan, JobRecord, Telemetry
from .trace import PID_CLUSTER, PID_JOBS, PID_SCHED, Tracer

__all__ = [
    "Telemetry", "CycleSpan", "JobRecord",
    "MetricRegistry", "Counter", "Gauge", "Histogram", "Metric",
    "DEFAULT_BUCKETS",
    "Tracer", "PID_SCHED", "PID_JOBS", "PID_CLUSTER",
    "ObserverPlugin", "DecisionAudit", "PlacementDecision", "PassAudit",
    "FilterStat", "ScoreBreakdown", "PreemptionRecord", "build_decision",
    "build_report", "render_markdown",
]
