"""Failure and maintenance models: seeded trace generators.

Each injector is a :class:`~repro_torch.core.framework.api.DynamicsPlugin`
whose :meth:`schedule` pre-samples a reproducible event trace from the
engine's seeded RNG — the whole failure history of a run is determined
by ``DynamicsConfig.seed``, which is what makes the dynamics benchmarks
comparable run-to-run (``benchmarks/run.py --seed``).

* :class:`NodeFailureInjector` — per-node Weibull (shape ``k``) failure
  process; ``k = 1`` degenerates to exponential (memoryless), ``k < 1``
  models infant mortality, ``k > 1`` wear-out.  Each failure is paired
  with an exponential repair time (NODE_RECOVER).
* :class:`GpuFailureInjector` — cluster-level Poisson process of
  single-device (ECC/thermal) failures, uniform over devices.
* :class:`DrainWindow` — one planned maintenance window over a fixed
  node set (DRAIN_START/DRAIN_END); ``evict=True`` additionally kills
  resident jobs at window start (they recover via checkpoint-restart),
  otherwise they run to completion while new placements are kept out.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

from ..events import EventKind
from ..framework.api import DynamicsPlugin
from ..framework.registry import register

Trace = List[Tuple[float, EventKind, object]]


@register
class NodeFailureInjector(DynamicsPlugin):
    """Seeded per-node Weibull failure + exponential repair process."""

    name = "NodeFailureInjector"

    def __init__(self, mtbf_s: float, repair_s: float = 1800.0,
                 shape: float = 1.0,
                 nodes: Optional[Sequence[int]] = None,
                 max_failures: Optional[int] = None) -> None:
        if mtbf_s <= 0 or repair_s < 0 or shape <= 0:
            raise ValueError("mtbf/repair/shape must be positive")
        self.mtbf_s = float(mtbf_s)
        self.repair_s = float(repair_s)
        self.shape = float(shape)
        self.nodes = None if nodes is None else [int(n) for n in nodes]
        self.max_failures = max_failures
        # Weibull scale chosen so the mean inter-failure time is the
        # configured MTBF: E[X] = scale * Gamma(1 + 1/k).
        self._scale = self.mtbf_s / math.gamma(1.0 + 1.0 / self.shape)

    def schedule(self, engine, rng) -> Trace:
        nodes = (self.nodes if self.nodes is not None
                 else range(engine.state.n_nodes))
        horizon = engine.horizon
        failures = []                  # (t, node, repair)
        for node in nodes:
            t = 0.0
            while True:
                t += float(rng.weibull(self.shape)) * self._scale
                if t > horizon:
                    break
                repair = float(rng.exponential(self.repair_s))
                failures.append((t, int(node), repair))
                t += repair
        if self.max_failures is not None:
            # Cap the TRACE, not a per-node budget walked in node-index
            # order — the earliest failures cluster-wide survive, so a
            # capped run still exercises the whole fleet.
            failures.sort()
            failures = failures[:self.max_failures]
        trace: Trace = []
        for t, node, repair in failures:
            trace.append((t, EventKind.NODE_FAIL, {"node": node}))
            trace.append((t + repair, EventKind.NODE_RECOVER,
                          {"node": node}))
        return trace


@register
class GpuFailureInjector(DynamicsPlugin):
    """Cluster-level Poisson process of single-device failures."""

    name = "GpuFailureInjector"

    def __init__(self, rate_per_gpu_hour: float,
                 repair_s: float = 3600.0) -> None:
        if rate_per_gpu_hour <= 0 or repair_s < 0:
            raise ValueError("rate/repair must be positive")
        self.rate_per_gpu_hour = float(rate_per_gpu_hour)
        self.repair_s = float(repair_s)

    def schedule(self, engine, rng) -> Trace:
        state = engine.state
        n_devices = state.n_nodes * state.gpus_per_node
        rate_per_s = self.rate_per_gpu_hour * n_devices / 3600.0
        trace: Trace = []
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rate_per_s))
            if t > engine.horizon:
                break
            node = int(rng.integers(state.n_nodes))
            gpu = int(rng.integers(state.gpus_per_node))
            trace.append((t, EventKind.GPU_FAIL,
                          {"node": node, "gpu": gpu}))
            trace.append((t + float(rng.exponential(self.repair_s)),
                          EventKind.GPU_RECOVER,
                          {"node": node, "gpu": gpu}))
        return trace


@register
class DrainWindow(DynamicsPlugin):
    """One planned maintenance window over a fixed node set."""

    name = "DrainWindow"

    def __init__(self, nodes: Iterable[int], start: float,
                 duration: float, evict: bool = False) -> None:
        self.nodes = [int(n) for n in nodes]
        self.start = float(start)
        self.duration = float(duration)
        self.evict = evict

    def schedule(self, engine, rng) -> Trace:
        payload = {"nodes": self.nodes, "evict": self.evict}
        return [(self.start, EventKind.DRAIN_START, payload),
                (self.start + self.duration, EventKind.DRAIN_END, payload)]
