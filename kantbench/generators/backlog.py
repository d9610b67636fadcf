"""A training backlog held at a fixed depth, from a fixed deck of job
sizes.

A traffic file (``kantbench/traffic/<name>.json``) names this module under
``"generator"`` and gives:

``deck``
    ``{"gpus": [...], "jobs": [...], "duration_scale": [...]}``: one deck
    of ``sum(jobs)`` training jobs, ``jobs[i]`` of them of ``gpus[i]``
    GPUs.  The sizes are interleaved by smooth weighted round robin (each
    step adds every size's count to its credit, takes the size of most
    credit, the first listed on a tie, and takes the deck's length off
    its credit), so each size recurs at even intervals; the deck repeats.
    A job of up to a node's GPUs is one pod, a larger one whole-node pods
    (``core/workload.py::_pods_for``).
``population``
    What every job is besides its size: ``kind``, ``gang``, ``priority``
    (low / normal / high), ``tenant`` and ``gpu_type``.
``arrivals``
    ``{"held_depth": D, "lifetime_unit_ticks": L0}``: D jobs are
    submitted at t = 0, and after each cycle D less the jobs then pending
    (never fewer than none) for the next tick, so that every cycle starts
    with D jobs queued.  A job of size i runs ``round(L0 *
    duration_scale[i])`` ticks once bound.
``warmup_ticks``
    Untimed cycles of set-up before the window opens.

Every seed sees the same jobs in the same order (how many are submitted
at a tick follows the queue); the seed changes the cluster's background
(``kantbench/inputs.py``).  The interface (``initial``, ``after_cycle``,
``warmup_ticks``) and the job dicts are ``stationary.py``'s.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from kantbench.generators.stationary import PRIORITY


def interleave(counts: Sequence[int]) -> List[int]:
    """The deck's order: indices into ``counts``, each ``counts[i]``
    times, by smooth weighted round robin."""
    total = sum(counts)
    credit = [0] * len(counts)
    order = []
    for _ in range(total):
        for i, c in enumerate(counts):
            credit[i] += c
        best = max(range(len(counts)), key=lambda i: (credit[i], -i))
        credit[best] -= total
        order.append(best)
    return order


class Generator:
    def __init__(self, traffic: Dict, config: Dict, seed: int) -> None:
        deck = traffic["deck"]
        self.pop = traffic["population"]
        arrivals = traffic["arrivals"]
        self.depth = int(arrivals["held_depth"])
        self.warmup_ticks = int(traffic["warmup_ticks"])
        sim = config["sim"]
        self.tick = float(sim["tick_interval_s"])
        self.binding_latency = float(sim["binding_latency_s"])
        per_node = int(config["topology"]["gpus_per_node"])
        unit = float(arrivals["lifetime_unit_ticks"])
        self.kinds = []
        for gpus, scale in zip(deck["gpus"], deck["duration_scale"]):
            gpus = int(gpus)
            if gpus <= per_node:
                shape = (1, gpus)
            elif gpus % per_node:
                raise ValueError(f"a job of {gpus} GPUs is no whole number "
                                 f"of {per_node}-GPU nodes")
            else:
                shape = (gpus // per_node, per_node)
            self.kinds.append((shape, int(round(unit * float(scale)))))
        self.order = interleave([int(n) for n in deck["jobs"]])
        self.next_uid = 0

    def _job(self, t: float) -> Dict:
        p = self.pop
        (n_pods, gpus_per_pod), life = self.kinds[
            self.order[self.next_uid % len(self.order)]]
        # Bound at a tick t_b, the job runs from t_b + binding latency and
        # its END falls on the tick t_b + life * tick, ahead of its cycle.
        job = {"uid": self.next_uid, "n_pods": n_pods,
               "gpus_per_pod": gpus_per_pod,
               "duration": life * self.tick - self.binding_latency,
               "kind": p["kind"], "gang": bool(p["gang"]),
               "priority": PRIORITY[p["priority"]], "tenant": p["tenant"],
               "gpu_type": int(p["gpu_type"]), "submit_time": float(t)}
        self.next_uid += 1
        return job

    def initial(self) -> List[Dict]:
        """The D jobs submitted at t = 0, before the first cycle."""
        return [self._job(0.0) for _ in range(self.depth)]

    def after_cycle(self, t: float, pending: int
                    ) -> List[Tuple[float, Dict]]:
        """Submissions due after the cycle at ``t``: (submit time, job),
        as many as bring the ``pending`` jobs back to D."""
        t_next = t + self.tick
        return [(t_next, self._job(t_next))
                for _ in range(max(0, self.depth - pending))]
