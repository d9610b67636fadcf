"""The plain reference of the Backfill queue, in NumPy alone.

It imports nothing of the program.  From a configuration, the cluster
columns the benchmark made from the seed and a fresh generator of the
cell's traffic, it replays the traffic through a Backfill queue of its
own (Table 1, §3.2) on its own copy of the cluster
(:class:`~kantbench.reference.ClusterReference`), tick by tick:

* the ENDs due at or before the tick release their jobs;
* the cycle takes the pending jobs in QueueSort order (priority
  descending, submit time, size in GPUs, uid);
* the head is tried first; a job is bound when admission passes (the
  pod slots of its pool, ``free // gpus_per_pod`` summed over the pool's
  nodes, reach its pods) and ``ClusterReference.decide`` places it;
* a head blocked since a tick at least ``backfill_head_timeout_s``
  before this one runs the head-timeout rule: if the pool could hold it
  empty and its free GPUs and those of the backfilled jobs reach the
  head's, it evicts backfilled jobs newest first (bind order among jobs
  bound at one tick), at most ``max_preemptions_per_cycle``, each only
  while the head still cannot be admitted and placed; an evicted job is
  pending again with its submit time, and runs its whole duration when
  bound again; then the head is tried again;
* every job behind the head is tried in order, marked backfilled when
  the head stayed blocked;
* after the cycle the generator is told how many jobs are pending and
  submits its jobs for the next tick.

It gives the sequence of binds ``(uid, pods, tick)`` and of preemptions
``(uid, tick)``.  It refuses what it does not hold: another queue policy,
more than one priority class (priority preemption would then act), and
a quota that can bind (a tenant's quota under the cluster's GPUs).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from .reference import ClusterReference, Pods

Bind = Tuple[int, Pods, float]
Preemption = Tuple[int, float]


def n_gpus(job: Dict) -> int:
    return int(job["n_pods"]) * int(job["gpus_per_pod"])


class QueueReference:
    """A Backfill queue over its own copy of one cluster, fed by a
    traffic generator (``initial``, ``after_cycle``)."""

    def __init__(self, config: Dict, columns: Dict[str, np.ndarray],
                 generator) -> None:
        sched = config["scheduler"]
        if sched["queue_policy"] != "backfill":
            raise ValueError("the queue reference holds Backfill only")
        topo = config["topology"]
        total = int(topo["n_nodes"]) * int(topo["gpus_per_node"])
        if any(int(q) < total for q in config["quota"].values()):
            raise ValueError("the queue reference holds quotas that never "
                             "bind only")
        self.cluster = ClusterReference(config, columns)
        self.timeout = float(sched["backfill_head_timeout_s"])
        self.max_preemptions = int(sched["max_preemptions_per_cycle"])
        self.tick = float(config["sim"]["tick_interval_s"])
        self.latency = float(config["sim"]["binding_latency_s"])
        self.gen = generator
        self.priority: Optional[int] = None
        self.pending: Dict[int, Dict] = {}
        #: uid -> (job, bind tick, backfilled), in the order of the
        #: latest binds
        self.running: Dict[int, Tuple[Dict, float, bool]] = {}
        self.end_of: Dict[int, float] = {}
        #: (END time, bind number, uid); an END whose job was evicted
        #: since is stale
        self.ends: List[Tuple[float, int, int]] = []
        self.blocked_since: Dict[int, float] = {}
        self.binds: List[Bind] = []
        self.preemptions: List[Preemption] = []
        self.now = 0.0
        for job in generator.initial():
            self.submit(job)

    # -- the queue -----------------------------------------------------------
    def submit(self, job: Dict) -> None:
        prio = int(job["priority"])
        if self.priority is None:
            self.priority = prio
        elif prio != self.priority:
            raise ValueError("the queue reference holds one priority "
                             "class only")
        self.pending[int(job["uid"])] = job

    def run(self, until: float) -> None:
        """Run every tick from the next one up to and including
        ``until``."""
        while self.now <= until:
            t = self.now
            while self.ends and self.ends[0][0] <= t:
                end, _, uid = heapq.heappop(self.ends)
                if self.end_of.get(uid) == end:
                    job, _, _ = self.running.pop(uid)
                    del self.end_of[uid]
                    self.cluster.release(job, end, False)
            self.cycle(t)
            for _, job in self.gen.after_cycle(t, len(self.pending)):
                self.submit(job)
            self.now = t + self.tick

    def cycle(self, t: float) -> None:
        order = sorted(self.pending.values(),
                       key=lambda j: (-int(j["priority"]),
                                      float(j["submit_time"]), n_gpus(j),
                                      int(j["uid"])))
        if not order:
            return
        head = order[0]
        uid = int(head["uid"])
        blocked = True
        if self.try_place(head, t, False):
            blocked = False
        elif t - self.blocked_since.setdefault(uid, t) >= self.timeout:
            self.head_timeout(head, t)
            blocked = not self.try_place(head, t, False)
        if not blocked:
            self.blocked_since.pop(uid, None)
        for job in order[1:]:
            self.try_place(job, t, blocked)

    # -- admission, placement, eviction --------------------------------------
    def admits(self, job: Dict) -> bool:
        """Dynamic admission: the pool's pod slots reach the job's pods."""
        pool = self.cluster.pool(job["gpu_type"])
        slots = self.cluster.free()[pool] // int(job["gpus_per_pod"])
        return int(slots.sum()) >= int(job["n_pods"])

    def try_place(self, job: Dict, t: float, backfilled: bool) -> bool:
        if not self.admits(job):
            return False
        pods, _ = self.cluster.decide(job)
        if pods is None:
            return False
        uid = int(job["uid"])
        self.cluster.bind(job, pods, t)
        del self.pending[uid]
        self.running[uid] = (job, t, backfilled)
        end = (t + self.latency) + float(job["duration"])
        self.end_of[uid] = end
        self.binds.append((uid, pods, t))
        heapq.heappush(self.ends, (end, len(self.binds), uid))
        return True

    def head_timeout(self, head: Dict, t: float) -> None:
        cluster = self.cluster
        pool = cluster.pool(head["gpu_type"])
        # the pool, empty, could hold the head
        slots = cluster.healthy_count[pool] // int(head["gpus_per_pod"])
        if int(slots.sum()) < int(head["n_pods"]):
            return
        victims = [(job, start) for job, start, backfilled
                   in self.running.values()
                   if backfilled and job["gpu_type"] == head["gpu_type"]]
        victims.sort(key=lambda v: -v[1])
        pool_free = int(cluster.free()[pool].sum())
        if pool_free + sum(n_gpus(j) for j, _ in victims) < n_gpus(head):
            return
        budget = self.max_preemptions
        for job, _ in victims:
            if budget <= 0:
                break
            if self.admits(head) and cluster.decide(head)[0] is not None:
                return
            uid = int(job["uid"])
            del self.running[uid]
            del self.end_of[uid]
            cluster.release(job, t, True)
            self.pending[uid] = job
            self.preemptions.append((uid, t))
            budget -= 1


def replay(config: Dict, columns: Dict[str, np.ndarray], generator,
           until: float) -> QueueReference:
    """The queue reference run over every tick up to ``until``."""
    ref = QueueReference(config, columns, generator)
    ref.run(until)
    return ref


def differ(got: List, want: List) -> int:
    """Entries of two sequences that differ, position by position (every
    entry past the shorter one's end counts)."""
    return (sum(1 for a, b in zip(got, want) if a != b)
            + abs(len(got) - len(want)))
