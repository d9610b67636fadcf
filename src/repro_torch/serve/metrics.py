"""Serving-side metrics: TTFT / TPOT / SLO attainment / cost-per-token.

Request-level counterparts of the cluster metrics in
:mod:`repro_torch.core.metrics` (GAR, SOR, GFR, JWTD, JTTED) — see
``docs/metrics.md`` for the full glossary.  A routed request produces
one :class:`RequestOutcome`; :class:`ServingMetrics` aggregates them
into the numbers the serving bench gates on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class RequestOutcome:
    """What happened to one routed request.

    ``rejected`` means the router returned no feasible replica (counts
    as an SLO miss); ``quality_ok`` means the serving replica's
    capability met the query class's quality floor.  Times are
    simulated seconds."""
    uid: int
    qclass: str
    replica: Optional[int]          # replica index, None if rejected
    rejected: bool
    ttft_s: float = 0.0             # arrival -> first output token
    tpot_s: float = 0.0             # per-token decode time
    latency_s: float = 0.0          # arrival -> last token
    slo_s: float = 0.0              # the class's latency SLO
    quality_ok: bool = False
    cost: float = 0.0               # $-like units for the whole request
    tokens: int = 0                 # prompt + output tokens served

    @property
    def slo_ok(self) -> bool:
        """SLO attainment: served, within latency SLO, quality met."""
        return (not self.rejected and self.quality_ok
                and self.latency_s <= self.slo_s)


@dataclasses.dataclass
class ServingMetrics:
    """Aggregate serving metrics over a routed trace."""

    outcomes: List[RequestOutcome] = dataclasses.field(default_factory=list)

    def record(self, o: RequestOutcome) -> None:
        self.outcomes.append(o)

    # -- headline numbers ----------------------------------------------
    def slo_attainment(self) -> float:
        """Fraction of ALL requests (rejections included) that met
        their latency SLO on a quality-feasible replica."""
        if not self.outcomes:
            return 1.0
        return sum(o.slo_ok for o in self.outcomes) / len(self.outcomes)

    def total_cost(self) -> float:
        return sum(o.cost for o in self.outcomes)

    def served_tokens(self) -> int:
        return sum(o.tokens for o in self.outcomes if not o.rejected)

    def cost_per_1k_tokens(self) -> float:
        tok = self.served_tokens()
        return 1000.0 * self.total_cost() / tok if tok else 0.0

    def rejected(self) -> int:
        return sum(o.rejected for o in self.outcomes)

    def _served(self) -> List[RequestOutcome]:
        return [o for o in self.outcomes if not o.rejected]

    def mean_ttft_s(self) -> float:
        s = self._served()
        return float(np.mean([o.ttft_s for o in s])) if s else 0.0

    def p90_ttft_s(self) -> float:
        s = self._served()
        return float(np.percentile([o.ttft_s for o in s], 90)) if s else 0.0

    def mean_tpot_s(self) -> float:
        s = self._served()
        return float(np.mean([o.tpot_s for o in s])) if s else 0.0

    # -- breakdowns -----------------------------------------------------
    def by_class(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        classes = sorted({o.qclass for o in self.outcomes})
        for c in classes:
            sub = [o for o in self.outcomes if o.qclass == c]
            out[c] = {
                "n": float(len(sub)),
                "slo_attainment": sum(o.slo_ok for o in sub) / len(sub),
                "rejected": float(sum(o.rejected for o in sub)),
                "cost": float(sum(o.cost for o in sub)),
            }
        return out

    def replica_share(self) -> Dict[int, int]:
        """Requests served per replica index."""
        share: Dict[int, int] = {}
        for o in self._served():
            share[o.replica] = share.get(o.replica, 0) + 1
        return share

    def report(self) -> Dict[str, float]:
        return {
            "requests": float(len(self.outcomes)),
            "rejected": float(self.rejected()),
            "slo_attainment": self.slo_attainment(),
            "total_cost": self.total_cost(),
            "cost_per_1k_tokens": self.cost_per_1k_tokens(),
            "mean_ttft_s": self.mean_ttft_s(),
            "p90_ttft_s": self.p90_ttft_s(),
            "mean_tpot_s": self.mean_tpot_s(),
        }

    def publish(self, registry, pool: str = "pool") -> None:
        """Push the headline numbers into a telemetry
        :class:`~repro_torch.obs.registry.MetricRegistry` (gauges labeled by
        pool name).  Duck-typed on the registry — this module never
        imports :mod:`repro_torch.obs`."""
        for key, value in self.report().items():
            registry.gauge("serving_" + key,
                           "serving fabric headline metric").set(
                value, pool=pool)
