"""Inference services from a fixed deck: every pairing of a pod size with
a replica count, submitted whole each tick.

A traffic file (``kantbench/traffic/<name>.json``) names this module under
``"generator"`` and gives:

``deck``
    ``{"gpus_per_pod": [...], "replicas": [...], "tenants": [...]}``:
    each tick submits one service for every pairing of a pod size with a
    replica count, pod sizes in the outer loop, in the order listed, so
    a deck of B = len(gpus_per_pod) * len(replicas) services is exactly
    the population's expectation, not a sample of it.  Tenants take the
    services in turn, by uid.
``population``
    What every service is besides its shape: ``kind``, ``gang``,
    ``priority`` (low / normal / high) and ``gpu_type``.
``arrivals``
    ``{"lifetime_ticks": L}``: each service runs exactly L ticks once
    bound, so that L * B services are in flight once the cluster holds
    them.
``warmup_ticks``
    Untimed cycles of set-up before the window opens.

Every seed sees the same jobs, in the same order, as with
``stationary.py``, whose interface (``initial``, ``after_cycle``,
``warmup_ticks``) and job dicts this module shares.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from kantbench.generators.stationary import PRIORITY


class Generator:
    def __init__(self, traffic: Dict, config: Dict, seed: int) -> None:
        deck = traffic["deck"]
        self.deck = [(int(g), int(n)) for g in deck["gpus_per_pod"]
                     for n in deck["replicas"]]
        self.tenants = list(deck["tenants"])
        self.pop = traffic["population"]
        self.life = int(traffic["arrivals"]["lifetime_ticks"])
        self.warmup_ticks = int(traffic["warmup_ticks"])
        sim = config["sim"]
        self.tick = float(sim["tick_interval_s"])
        self.binding_latency = float(sim["binding_latency_s"])
        self.next_uid = 0

    def _deck(self, t: float) -> List[Dict]:
        p = self.pop
        # Bound at a tick t_b, a service runs from t_b + binding latency
        # and its END falls on the tick t_b + life * tick, ahead of its
        # cycle.
        duration = self.life * self.tick - self.binding_latency
        jobs = []
        for gpus, n_pods in self.deck:
            uid = self.next_uid
            jobs.append({"uid": uid, "n_pods": n_pods, "gpus_per_pod": gpus,
                         "duration": duration, "kind": p["kind"],
                         "gang": bool(p["gang"]),
                         "priority": PRIORITY[p["priority"]],
                         "tenant": self.tenants[uid % len(self.tenants)],
                         "gpu_type": int(p["gpu_type"]),
                         "submit_time": float(t)})
            self.next_uid += 1
        return jobs

    def initial(self) -> List[Dict]:
        """The deck submitted at t = 0, before the first cycle."""
        return self._deck(0.0)

    def after_cycle(self, t: float, pending: int
                    ) -> List[Tuple[float, Dict]]:
        """Submissions due after the cycle at ``t``: (submit time, job).
        ``pending`` is the queue depth after the cycle (unused here)."""
        t_next = t + self.tick
        return [(t_next, job) for job in self._deck(t_next)]
