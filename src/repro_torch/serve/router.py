"""Built-in RouterPolicy plugins (query → replica routing).

The request-level siblings of the federation's ClusterSelect policies:
round-robin and least-loaded are the load-only baselines; ECCOS-style
:class:`CapabilityCostRouter` is the two-stage capability/cost policy
the serving bench gates on.  All register in the shared framework
registry, so config-driven assemblies can mix them with out-of-tree
policies (see docs/serving.md for a worked custom-policy example).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from ..core.framework.api import RouterPolicyPlugin
from ..core.framework.registry import register
from ..core.workload import ServeRequest


@register
class RoundRobinRouter(RouterPolicyPlugin):
    """Cycle through replicas regardless of load, cost or capability."""

    name = "RoundRobinRouter"

    def __init__(self) -> None:
        self._next = 0

    def select(self, request: ServeRequest, replicas: Sequence,
               now: float) -> Optional[int]:
        idx = self._next % len(replicas)
        self._next += 1
        return idx


@register
class LeastLoadedRouter(RouterPolicyPlugin):
    """Pick the replica with the smallest queued backlog (seconds of
    work ahead of the request).  Load-aware, capability/cost-blind.
    Ties rotate round-robin — a fixed tie-break would herd every
    request onto replica 0 whenever the fleet is idle."""

    name = "LeastLoadedRouter"

    def __init__(self) -> None:
        self._tick = 0

    def select(self, request: ServeRequest, replicas: Sequence,
               now: float) -> Optional[int]:
        n = len(replicas)
        self._tick += 1
        return min(range(n),
                   key=lambda i: (replicas[i].backlog_s(now),
                                  (i - self._tick) % n))


@register
class CapabilityCostRouter(RouterPolicyPlugin):
    """ECCOS-style two-stage routing: capability predictor, then
    constrained cost minimisation.

    **Stage 1 (capability predictor).**  A cheap per-(class, replica)
    capability estimate decides which replicas can answer the query
    acceptably.  The prior is the replica's declared
    :attr:`~repro_torch.serve.replica.ReplicaSpec.capability`; with
    ``learn=True`` the estimate is refined online from
    :meth:`observe` feedback (quality outcomes of completed requests),
    so a mis-declared replica is routed around after a few misses.

    **Stage 2 (constrained cost minimiser).**  Among capability-feasible
    replicas whose *predicted* latency (queue wait + prefill + decode)
    meets the request's SLO, pick the cheapest per token; ties break
    toward lower predicted latency, then lower index.  If no replica
    passes stage 1, or ``reject_infeasible`` and none meets the SLO,
    the request is REJECTED (returns ``None``) rather than knowingly
    burning tokens on an answer that misses its floor — the pool books
    the rejection as an SLO miss, so rejection is never a free lunch
    for the attainment number.  With ``reject_infeasible=False`` an
    SLO-tight request degrades to the fastest capability-feasible
    replica instead.
    """

    name = "CapabilityCostRouter"

    def __init__(self, *, slo_margin: float = 1.0,
                 reject_infeasible: bool = True,
                 learn: bool = False, learn_rate: float = 0.2) -> None:
        self.slo_margin = slo_margin
        self.reject_infeasible = reject_infeasible
        self.learn = learn
        self.learn_rate = learn_rate
        # (qclass, replica) -> learned quality estimate (EWMA of
        # observed quality_ok); consulted only when learn=True.
        self._quality: Dict[Tuple[str, int], float] = {}

    # -- stage 1: capability prediction --------------------------------
    def predicted_capability(self, request: ServeRequest,
                             replicas: Sequence, i: int) -> float:
        prior = replicas[i].spec.capability
        if not self.learn:
            return prior
        return self._quality.get((request.qclass.name, i), prior)

    def observe(self, outcome) -> None:
        if not self.learn or outcome.rejected:
            return
        key = (outcome.qclass, outcome.replica)
        prev = self._quality.get(key)
        q = 1.0 if outcome.quality_ok else 0.0
        self._quality[key] = (q if prev is None
                              else prev + self.learn_rate * (q - prev))

    # -- stage 2: constrained cost minimisation ------------------------
    def select(self, request: ServeRequest, replicas: Sequence,
               now: float) -> Optional[int]:
        floor = request.qclass.quality_floor
        capable = [i for i in range(len(replicas))
                   if self.predicted_capability(request, replicas, i)
                   >= floor]
        if not capable:
            return None
        slo = request.qclass.latency_slo_s * self.slo_margin
        lat = {i: replicas[i].estimate_latency(request, now)
               for i in capable}
        feasible = [i for i in capable if lat[i] <= slo]
        if not feasible:
            if self.reject_infeasible:
                return None
            return min(capable, key=lambda i: (lat[i], i))
        return min(feasible,
                   key=lambda i: (replicas[i].spec.cost_per_1k_tokens,
                                  lat[i], i))
