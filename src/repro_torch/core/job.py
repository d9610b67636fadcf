"""Job and placement model (paper §2, §3.2).

Kant schedules three kinds of AI jobs (§2 "Diverse Task Types"):

* LLM distributed training  — gang-scheduled, throughput-oriented;
* inference services        — pod-level scheduling, latency/HA-oriented;
* development / debugging   — small, flexibility-oriented.

A job consists of ``n_pods`` pods, each requesting ``gpus_per_pod`` GPUs of
one GPU type.  Gang jobs (§3.3.2) are admitted, scheduled and preempted at
job granularity (all-or-nothing); non-gang jobs at pod granularity.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:   # elastic imports JobKind; keep the cycle static-only
    from .elastic.spec import ElasticSpec, ParallelismPlan


class JobKind(enum.Enum):
    TRAIN = "train"
    INFER = "infer"
    DEBUG = "debug"


class JobState(enum.Enum):
    PENDING = "pending"        # submitted, waiting in the tenant queue
    ADMITTED = "admitted"      # passed static + dynamic admission
    RUNNING = "running"        # bound to devices
    COMPLETED = "completed"
    PREEMPTED = "preempted"    # evicted; will be requeued
    INTERRUPTED = "interrupted"  # killed by a failure/drain; requeued
    FAILED = "failed"


# Priority values: larger is more important.  These match the paper's
# qualitative tiers (inference/HA > training > debug/backfill fodder).
PRIO_HIGH = 100
PRIO_NORMAL = 50
PRIO_LOW = 10


@dataclasses.dataclass
class PodPlacement:
    """Concrete device assignment for one pod (fine-grained, §3.3.1)."""

    node: int
    gpu_indices: Tuple[int, ...]      # device slots on that node
    nic: int = 0                      # paired RDMA NIC (§3.3.1)

    def __post_init__(self) -> None:
        if len(set(self.gpu_indices)) != len(self.gpu_indices):
            raise ValueError("duplicate GPU indices in a pod placement")


@dataclasses.dataclass
class Placement:
    """Full placement of a job: one ``PodPlacement`` per pod."""

    pods: List[PodPlacement]

    @property
    def nodes(self) -> List[int]:
        return [p.node for p in self.pods]

    @property
    def n_gpus(self) -> int:
        return sum(len(p.gpu_indices) for p in self.pods)

    def distinct_nodes(self) -> List[int]:
        return sorted(set(self.nodes))

    def index_form(self, keep: bool = True
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The pods' nodes as an ``(n_pods,)`` int64 array and their GPU
        slots as an ``(n_pods, gpus_per_pod)`` int64 array, or None when
        the pods differ in size (or there are none).  With ``keep`` it
        is kept on the instance for later calls (a placement's ``pods``
        are not mutated once it is made); without, a kept one is taken
        off, so a placement whose devices are freed holds no arrays
        (finished jobs keep their placements)."""
        index = self.__dict__.pop("_index", False)
        if index is False:
            pods = self.pods
            slots = [p.gpu_indices for p in pods]
            k = len(slots[0]) if slots else 0
            index = None
            if k and all(len(s) == k for s in slots):
                index = (np.fromiter([p.node for p in pods], dtype=np.int64,
                                     count=len(pods)),
                         np.fromiter(itertools.chain.from_iterable(slots),
                                     dtype=np.int64, count=k * len(pods)
                                     ).reshape(len(pods), k))
        if keep:
            self._index = index
        return index


@dataclasses.dataclass
class Job:
    uid: int
    tenant: str
    gpu_type: int
    n_pods: int
    gpus_per_pod: int
    kind: JobKind = JobKind.TRAIN
    gang: bool = True
    priority: int = PRIO_NORMAL
    submit_time: float = 0.0
    duration: float = 3600.0
    preemptible: bool = True
    # Home region of the job's tenant/data (federation subsystem): the
    # GSCH locality plugin prefers member clusters in this region, and
    # cross-region forwarding pays the locality penalty.  None = no
    # affinity (single-cluster runs never look at it).
    region: Optional[str] = None
    # Elastic-training contract (repro_torch.core.elastic): the menu of
    # alternative parallelism plans this job may run at.  None (the
    # default) keeps the job rigid — the scheduler never looks at it
    # and every placement stays byte-identical to the classic path.
    # The job's declared (n_pods, gpus_per_pod) must be the spec's
    # ideal plan; ``duration``/``original_duration`` are ideal-plan
    # seconds.
    elastic: Optional["ElasticSpec"] = None
    # Free-form descriptive text (model/framework/dataset tags): the
    # semantic soft-affinity contrib plugin scores token overlap over
    # it.  None = no description; affinity falls back to the tenant
    # name.  The scheduler core never reads it.
    metadata: Optional[str] = None

    # Mutable scheduling bookkeeping -----------------------------------
    state: JobState = JobState.PENDING
    admit_time: Optional[float] = None
    start_time: Optional[float] = None      # scheduling completion (binding)
    run_time: Optional[float] = None        # container actually running
    end_time: Optional[float] = None
    placement: Optional[Placement] = None
    backfilled: bool = False                # scheduled by bypassing the head
    preempt_count: int = 0
    requeue_count: int = 0
    borrowed_quota: int = 0                 # GPUs borrowed via shared quota
    # Checkpoint-restart bookkeeping (dynamics subsystem).  ``duration``
    # is the remaining wall time of the CURRENT attempt (the simulator
    # schedules END from it); ``original_duration`` is the total useful
    # work the job represents, fixed at construction.
    original_duration: float = 0.0
    attempt: int = 0                        # restart attempts so far
    interrupt_count: int = 0                # failure/drain kills
    checkpointed_progress: float = 0.0      # work safely persisted (s)
    lost_work: float = 0.0                  # recompute debt accrued (s)
    restart_overhead: float = 0.0           # restore overhead accrued (s)
    # Elastic bookkeeping: the plan the current/most recent attempt runs
    # at (None until the ElasticManager picks one) and how many
    # voluntary checkpoint-boundary reshapes the job has gone through.
    active_plan: Optional["ParallelismPlan"] = None
    reshape_count: int = 0

    def __post_init__(self) -> None:
        if self.n_pods <= 0 or self.gpus_per_pod <= 0:
            raise ValueError("jobs must request at least one pod and GPU")
        if not self.gang and self.kind == JobKind.TRAIN and self.n_pods > 1:
            # The paper gang-schedules all distributed training (§3.2.1).
            raise ValueError("multi-pod training jobs must be gang jobs")
        if not self.original_duration:
            self.original_duration = self.duration
        if self.elastic is not None:
            self.elastic.validate_for(self)

    @property
    def n_gpus(self) -> int:
        return self.n_pods * self.gpus_per_pod

    # -- elastic accounting (identity values for rigid jobs) -----------
    @property
    def work_rate(self) -> float:
        """Relative progress rate of the active plan: 1.0 for rigid
        jobs and for elastic jobs at their ideal plan; below 1.0 while
        shrunk.  One wall second on the active shape advances
        ``work_rate`` seconds of (ideal-plan) work."""
        if self.elastic is None or self.active_plan is None:
            return 1.0
        return self.active_plan.throughput / self.elastic.ideal().throughput

    @property
    def ideal_n_gpus(self) -> int:
        """GPU count of the ideal plan — the plan-independent yardstick
        goodput accounting multiplies completed work by."""
        if self.elastic is None:
            return self.n_gpus
        return self.elastic.ideal().n_gpus

    def apply_plan(self, plan: "ParallelismPlan") -> None:
        """Adopt ``plan`` as the next attempt's shape.  Only legal
        while the job is not bound to devices (quota charges and the
        allocator validate against the current shape)."""
        if self.state is JobState.RUNNING:
            raise ValueError("cannot reshape a bound job in place")
        self.n_pods = plan.n_pods
        self.gpus_per_pod = plan.gpus_per_pod
        self.active_plan = plan

    @property
    def waiting_time(self) -> Optional[float]:
        if self.start_time is None:
            return None
        return self.start_time - self.submit_time

    def order_key(self) -> Tuple[int, float, int, int]:
        """Global queue ordering (§3.2.2): priority desc, submit time asc,
        then size asc as the tie-breaker, uid for determinism."""
        return (-self.priority, self.submit_time, self.n_gpus, self.uid)


def size_bucket(n_gpus: int) -> str:
    """JWTD size buckets (§4.4 uses 'fewer than 8' / 'more than 64' bands;
    we refine to the sizes of Fig 4/8)."""
    for bound, name in ((8, "<=8"), (64, "9-64"), (256, "65-256"),
                        (1024, "257-1024"), (2048, "1025-2048")):
        if n_gpus <= bound:
            return name
    return ">2048"


SIZE_BUCKETS: Sequence[str] = ("<=8", "9-64", "65-256", "257-1024",
                               "1025-2048", ">2048")


def summarize_waits(jobs: Sequence[Job]) -> Dict[str, float]:
    """Mean waiting time per size bucket over started jobs."""
    acc: Dict[str, List[float]] = {}
    for j in jobs:
        w = j.waiting_time
        if w is None:
            continue
        acc.setdefault(size_bucket(j.n_gpus), []).append(w)
    return {k: sum(v) / len(v) for k, v in acc.items() if v}
