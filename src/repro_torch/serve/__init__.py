"""Serving fabric: continuous-batching engine, replica pool, router.

* :mod:`repro_torch.serve.engine`   — per-slot continuous-batching engine:
  admit prefills the new request alone and splices its cache rows into
  the live batch; residents are never re-prefilled (the legacy
  whole-batch re-prefill shim survives as ``per_slot_prefill=False``).
* :mod:`repro_torch.serve.replica`  — heterogeneous :class:`ReplicaPool` in
  simulated time, with demand export to the TidalAutoscaler.
* :mod:`repro_torch.serve.router`   — pluggable RouterPolicy plugins:
  round-robin, least-loaded, ECCOS-style capability/cost.
* :mod:`repro_torch.serve.requests` — workload-level ↔ engine-level request
  bridging.
* :mod:`repro_torch.serve.metrics`  — TTFT / TPOT / SLO attainment / cost.
* :mod:`repro_torch.serve.step`     — prefill/decode step factories.

See ``docs/serving.md`` for the architecture and the router policy
contract, ``docs/metrics.md`` for the metric definitions.
"""

from .engine import Request, ServeEngine
from .metrics import RequestOutcome, ServingMetrics
from .replica import Replica, ReplicaPool, ReplicaSpec, demand_service
from .requests import to_engine_request
from .router import (CapabilityCostRouter, LeastLoadedRouter,
                     RoundRobinRouter)
from .step import make_decode_step, make_prefill_step

__all__ = ["Request", "ServeEngine", "make_decode_step",
           "make_prefill_step", "RequestOutcome", "ServingMetrics",
           "Replica", "ReplicaPool", "ReplicaSpec", "demand_service",
           "to_engine_request", "CapabilityCostRouter",
           "LeastLoadedRouter", "RoundRobinRouter"]
