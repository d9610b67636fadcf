"""The general traffic generator: stationary gang streams from a data file.

A traffic file (``kantbench/traffic/<name>.json``) names this module under
``"generator"`` and gives three groups of parameters:

``population``
    What a job is: ``shape``, ``{"n_pods": n, "gpus_per_pod": g}``, plus
    ``kind`` (train / infer), ``gang``, ``priority`` (low / normal /
    high), ``tenant`` and ``gpu_type``.
``arrivals``
    ``{"per_tick": B, "lifetime_ticks": L}``: B jobs are submitted for
    every tick, and each runs exactly L ticks once bound, so that L * B
    jobs are in flight once the cluster holds them.
``warmup_ticks``
    Untimed cycles of set-up before the window opens.

Every seed thus sees the same jobs; the seed changes the cluster's
background (``kantbench/inputs.py``), not the stream.

Jobs are plain dicts (``uid``, ``n_pods``, ``gpus_per_pod``,
``duration``, ``kind``, ``gang``, ``priority``, ``tenant``,
``gpu_type``, ``submit_time``): the harness turns them into the
program's jobs, and the reference reads the same dicts.  A traffic that
needs another stream names another generator module with the same
interface (``initial``, ``after_cycle``, ``warmup_ticks``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PRIORITY = {"low": 10, "normal": 50, "high": 100}


class Generator:
    def __init__(self, traffic: Dict, config: Dict, seed: int) -> None:
        self.pop = traffic["population"]
        self.arr = traffic["arrivals"]
        self.warmup_ticks = int(traffic["warmup_ticks"])
        sim = config["sim"]
        self.tick = float(sim["tick_interval_s"])
        self.binding_latency = float(sim["binding_latency_s"])
        self.next_uid = 0

    def _job(self, t: float) -> Dict:
        p, shape = self.pop, self.pop["shape"]
        life = int(self.arr["lifetime_ticks"])
        # Bound at a tick t_b, the job runs from t_b + binding latency and
        # its END falls on the tick t_b + life * tick, ahead of its cycle.
        job = {"uid": self.next_uid, "n_pods": int(shape["n_pods"]),
               "gpus_per_pod": int(shape["gpus_per_pod"]),
               "duration": life * self.tick - self.binding_latency,
               "kind": p["kind"], "gang": bool(p["gang"]),
               "priority": PRIORITY[p["priority"]], "tenant": p["tenant"],
               "gpu_type": int(p["gpu_type"]), "submit_time": float(t)}
        self.next_uid += 1
        return job

    def initial(self) -> List[Dict]:
        """The jobs submitted at t = 0, before the first cycle."""
        return [self._job(0.0) for _ in range(int(self.arr["per_tick"]))]

    def after_cycle(self, t: float, pending: int
                    ) -> List[Tuple[float, Dict]]:
        """Submissions due after the cycle at ``t``: (submit time, job).
        ``pending`` is the queue depth after the cycle (unused here)."""
        t_next = t + self.tick
        return [(t_next, self._job(t_next))
                for _ in range(int(self.arr["per_tick"]))]
