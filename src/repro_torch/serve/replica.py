"""Replica pool: heterogeneous model replicas behind one router.

A :class:`Replica` is a timing model of one serving instance — ``slots``
parallel decode slots (the engine's batch size), a prefill/decode token
rate and a cost per token — driven in *simulated* time so a routing
bench can push thousands of requests through policy A/B runs in
milliseconds.  The slot semantics mirror :class:`repro_torch.serve.engine.
ServeEngine` (per-slot admission, no re-prefill of residents); a replica
built from an :class:`~repro_torch.configs.base.ArchConfig` via
:meth:`ReplicaSpec.from_arch` can materialise the real engine with
:meth:`Replica.build_engine` when token-level fidelity matters (tests,
the bench's prefill-count gate).

:class:`ReplicaPool` routes a request trace through a
:class:`~repro_torch.core.framework.api.RouterPolicyPlugin`, aggregates
:class:`~repro_torch.serve.metrics.ServingMetrics`, and exports the observed
replica demand to the cluster simulator's
:class:`~repro_torch.core.dynamics.tidal.TidalAutoscaler` via
:func:`demand_service` — the hand-off that makes the serving tier and
the cluster simulator talk.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence

from ..configs.base import ArchConfig
from ..core.framework.api import RouterPolicyPlugin
from ..core.workload import ServeRequest
from .metrics import RequestOutcome, ServingMetrics


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """Static description of one replica tier.

    ``capability`` is on the same 0..1 scale as
    :attr:`repro_torch.core.workload.QueryClass.quality_floor`; cost and token
    rates are per-replica constants (the timing model's parameters)."""
    name: str
    capability: float               # 0..1 answer-quality proxy
    cost_per_1k_tokens: float       # $-like units
    prefill_tokens_per_s: float = 4000.0
    decode_tokens_per_s: float = 40.0
    slots: int = 4                  # parallel decode slots (batch size)
    arch: Optional[str] = None      # repro_torch.configs arch id, if any

    @classmethod
    def from_arch(cls, arch_id: str, *, capability: Optional[float] = None,
                  cost_per_1k_tokens: Optional[float] = None,
                  slots: int = 4, smoke: bool = False,
                  flops_per_s: float = 1e15) -> "ReplicaSpec":
        """Derive a spec from an architecture's parameter count.

        Token rates follow the 2·N-FLOPs-per-token rule against a
        nominal accelerator budget; capability and cost default to
        log-param scalings (bigger ⇒ more capable, pricier, slower) —
        crude, but heterogeneous in the right direction, and every
        number can be overridden."""
        from ..configs import get_arch
        cfg = get_arch(arch_id, smoke=smoke)
        n = float(cfg.n_params())
        # 0.5 at ~1e9 params -> ~1.0 at 1e12, floor 0.1.
        cap = capability if capability is not None else min(
            1.0, max(0.1, 0.5 + 0.167 * math.log10(max(n, 1.0) / 1e9)))
        cost = (cost_per_1k_tokens if cost_per_1k_tokens is not None
                else n / 1e9)      # ~$1 per 1k tokens per B params
        tok_s = flops_per_s / (2.0 * max(n, 1.0))
        return cls(name=arch_id, capability=cap,
                   cost_per_1k_tokens=cost,
                   prefill_tokens_per_s=tok_s * 8.0,  # prefill batches well
                   decode_tokens_per_s=tok_s,
                   slots=slots, arch=arch_id)


class Replica:
    """One serving instance: ``spec.slots`` parallel decode slots in
    simulated time (an M/G/c-style free-time heap)."""

    def __init__(self, spec: ReplicaSpec) -> None:
        self.spec = spec
        # Earliest-free simulated time per slot.
        self._free: List[float] = [0.0] * spec.slots
        heapq.heapify(self._free)
        self.served = 0
        self.busy_s = 0.0

    # -- load signals ---------------------------------------------------
    def backlog_s(self, now: float) -> float:
        """Total queued work: seconds until each slot frees, summed."""
        return sum(max(0.0, f - now) for f in self._free)

    def busy_slots(self, now: float) -> int:
        return sum(1 for f in self._free if f > now)

    # -- timing model ---------------------------------------------------
    def service_times(self, req: ServeRequest, now: float
                      ) -> Dict[str, float]:
        """Predicted (wait, ttft, latency, service) for ``req`` admitted
        at ``now`` — the router's feasibility oracle and the commit
        path share this arithmetic."""
        wait = max(0.0, self._free[0] - now)
        prefill = req.prompt_tokens / self.spec.prefill_tokens_per_s
        decode = req.output_tokens / self.spec.decode_tokens_per_s
        return {"wait": wait, "ttft": wait + prefill,
                "latency": wait + prefill + decode,
                "service": prefill + decode}

    def estimate_latency(self, req: ServeRequest, now: float) -> float:
        return self.service_times(req, now)["latency"]

    def admit(self, req: ServeRequest, now: float, index: int
              ) -> RequestOutcome:
        """Commit ``req`` to this replica's earliest-free slot."""
        t = self.service_times(req, now)
        start = heapq.heappop(self._free)
        start = max(start, now)
        heapq.heappush(self._free, start + t["service"])
        self.served += 1
        self.busy_s += t["service"]
        cost = self.spec.cost_per_1k_tokens * req.total_tokens / 1000.0
        return RequestOutcome(
            uid=req.uid, qclass=req.qclass.name, replica=index,
            rejected=False,
            ttft_s=t["ttft"],
            tpot_s=1.0 / self.spec.decode_tokens_per_s,
            latency_s=t["latency"],
            slo_s=req.qclass.latency_slo_s,
            quality_ok=self.spec.capability >= req.qclass.quality_floor,
            cost=cost, tokens=req.total_tokens)

    # -- token-level fidelity ------------------------------------------
    def build_engine(self, params, *, max_seq: int = 256,
                     smoke: bool = False, per_slot_prefill: bool = True,
                     device=None):
        """Materialise the real :class:`~repro_torch.serve.engine.ServeEngine`
        for this replica's architecture (requires ``spec.arch``).

        ``params`` is the model's state dict (``Model.state_dict()``);
        the engine serves it on ``device`` (``None`` = CUDA, raises
        without it)."""
        if self.spec.arch is None:
            raise ValueError(f"replica {self.spec.name!r} has no arch id")
        from ..configs import get_arch
        from .engine import ServeEngine
        cfg = get_arch(self.spec.arch, smoke=smoke)
        return ServeEngine(cfg, params, batch_size=self.spec.slots,
                           max_seq=max_seq,
                           per_slot_prefill=per_slot_prefill, device=device)


class ReplicaPool:
    """Heterogeneous replicas + a pluggable router policy."""

    def __init__(self, specs: Sequence[ReplicaSpec],
                 policy: RouterPolicyPlugin,
                 demand_bucket_s: float = 300.0) -> None:
        if not specs:
            raise ValueError("a pool needs at least one replica")
        self.replicas = [Replica(s) for s in specs]
        self.policy = policy
        self.metrics = ServingMetrics()
        # Observed arrival counts per time bucket (the demand signal
        # exported to the tidal autoscaler).
        self.demand_bucket_s = float(demand_bucket_s)
        self._arrivals: Dict[int, int] = {}
        self._service_s_sum = 0.0
        self._service_n = 0

    # -- routing --------------------------------------------------------
    def route(self, req: ServeRequest, now: Optional[float] = None
              ) -> RequestOutcome:
        now = req.arrival_s if now is None else now
        self._arrivals[int(now // self.demand_bucket_s)] = \
            self._arrivals.get(int(now // self.demand_bucket_s), 0) + 1
        idx = self.policy.select(req, self.replicas, now)
        if idx is None:
            out = RequestOutcome(uid=req.uid, qclass=req.qclass.name,
                                 replica=None, rejected=True,
                                 slo_s=req.qclass.latency_slo_s)
        else:
            rep = self.replicas[idx]
            out = rep.admit(req, now, idx)
            self._service_s_sum += out.latency_s - out.ttft_s \
                + req.prompt_tokens / rep.spec.prefill_tokens_per_s
            self._service_n += 1
        self.metrics.record(out)
        self.policy.observe(out)
        return out

    def route_trace(self, trace: Sequence[ServeRequest]) -> ServingMetrics:
        for req in sorted(trace, key=lambda r: r.arrival_s):
            self.route(req)
        return self.metrics

    # -- telemetry ------------------------------------------------------
    def bind_registry(self, registry, name: str = "pool") -> None:
        """Register a pull collector on a telemetry registry: on every
        ``collect()`` the pool publishes its headline serving metrics
        plus the observed-load signal (requests routed, Little's-law
        replica demand at the latest bucket)."""

        def collect(reg) -> None:
            self.metrics.publish(reg, pool=name)
            last_bucket = max(self._arrivals) if self._arrivals else 0
            t = last_bucket * self.demand_bucket_s
            reg.gauge("serving_observed_rps",
                      "observed arrival rate, latest bucket").set(
                self.observed_rps(t), pool=name)
            reg.gauge("serving_replica_demand",
                      "Little's-law replicas needed, latest bucket").set(
                self.replica_demand(t), pool=name)
            reg.gauge("serving_replicas", "replicas in the pool").set(
                len(self.replicas), pool=name)

        registry.add_collector(collect)

    # -- demand export --------------------------------------------------
    def observed_rps(self, t: float) -> float:
        """Observed arrival rate (requests/s) in the bucket holding
        ``t`` — piecewise-constant, zero where nothing arrived."""
        return (self._arrivals.get(int(t // self.demand_bucket_s), 0)
                / self.demand_bucket_s)

    def mean_service_s(self) -> float:
        if not self._service_n:
            return 1.0
        return self._service_s_sum / self._service_n

    def replica_demand(self, t: float) -> float:
        """Replicas needed to serve the observed rate at ``t``: Little's
        law (rate × mean service time = busy slots) over slots/replica."""
        slots = max(1, self.replicas[0].spec.slots)
        return self.observed_rps(t) * self.mean_service_s() / slots


def demand_service(pool: ReplicaPool, *, name: str = "serving",
                   min_replicas: int = 1, max_replicas: int = 8,
                   gpus_per_replica: int = 1, tenant: str = "svc",
                   gpu_type: int = 0):
    """Build a :class:`~repro_torch.core.dynamics.tidal.TidalService` whose
    demand curve is the pool's OBSERVED request load — the serving
    fabric's hand-off to the cluster simulator's TidalAutoscaler."""
    from ..core.dynamics.tidal import TidalService
    return TidalService(name=name, tenant=tenant, gpu_type=gpu_type,
                        gpus_per_replica=gpus_per_replica,
                        min_replicas=min_replicas,
                        max_replicas=max_replicas,
                        demand=pool.replica_demand)
