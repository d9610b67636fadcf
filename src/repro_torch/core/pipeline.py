"""Optimistic cycle pipelining: overlap snapshot+score of cycle N+1
with the bind commit of cycle N.

Production schedulers hide scheduling latency behind binding I/O (image
pulls, container starts — §4.2 measures ~45 s of it): while cycle N's
placements commit, the scheduler can already snapshot and score cycle
N+1's head job.  The simulator is single-threaded, so the pipeline
models the *decision dependency structure* rather than real threads:

* at the end of cycle N (:meth:`CyclePipeline.end_cycle`), the retained
  incremental snapshot is **speculatively refreshed** — dirty rows fold
  in WITHOUT a version bump (``IncrementalSnapshotter.refresh``) — and
  RSCH pre-computes a :class:`~repro_torch.core.rsch.ScheduleResult` for the
  *predicted* head job of cycle N+1 (the first pending job passing
  static admission, which every built-in QueuePolicy attempts first);
* at the start of cycle N+1 (:meth:`CyclePipeline.begin_cycle`), a
  **conflict re-check** decides whether the speculation is still valid:
  any dirty rows or invariant changes on the live state since the
  speculative refresh (job ENDs, failures, drains, autoscaling), or
  further mutations folded into the snapshot (``mut_count`` drift),
  abandon it — the cycle recomputes from scratch, which is always
  correct;
* RSCH consumes an armed speculation in :meth:`~repro_torch.core.rsch.RSCH.
  schedule` only after re-verifying the job's identity and shape, the
  snapshot identity and mutation count, and the score-weight
  fingerprint (a self-tuning controller may have nudged plugin weights
  between cycles).

Coverage argument: every observable input of ``RSCH.schedule`` is either
(a) the snapshot — guarded by ``mut_count`` + the live state's dirty
tracking, since *all* placement/health mutations go through the
sanctioned ``ClusterState`` writers; (b) the job — guarded by
uid/shape/fingerprint; or (c) plugin-visible cluster context.  Running-
set and quota changes always accompany a state mutation (allocate/
release), so (c) is covered by (a) for the built-in plugins.  The one
documented unsupported case is a custom Score plugin reading
``CycleContext.now`` (speculation passes a plain ``SchedulingContext``,
which has no clock) — such profiles should keep ``pipelined_cycles``
off.

A correct-but-stale prediction (head job changed, admission flipped) is
never an error: the speculation simply goes unconsumed and is counted
as a miss.  With the pipeline off, none of this code runs and the
simulator is byte-identical to the unpipelined implementation; with it
on, placements are identical whenever speculations are only consumed
under the guards above (asserted by ``benchmarks/sched_scale_bench.py``
over multi-day traces).

Speculation runs RSCH's device pass, so a kernel fault can surface there
first.  An exception raised on the device path (the kernels' build,
launch and wrappers, the seam: :data:`DEVICE_PATH`) propagates; only
other exceptions, a plugin's, abort the speculation and count in
``errors``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Optional

from .framework.api import CycleContext, CycleResult, SchedulingContext

if TYPE_CHECKING:
    from .cluster import ClusterState
    from .qsch import QSCH

_PORT = __name__.split(".")[0]
#: Modules of the device path: the kernels, their build and wrappers, the
#: packed seam and device resolution.
DEVICE_PATH = (f"{_PORT}.kernels.", f"{_PORT}.core.scoring",
               f"{_PORT}.device")


def raised_on_device_path(exc: BaseException) -> bool:
    """Whether ``exc`` was raised in, or passed through, a frame of the
    device path (:data:`DEVICE_PATH`)."""
    tb = exc.__traceback__
    while tb is not None:
        if tb.tb_frame.f_globals.get("__name__", "").startswith(
                DEVICE_PATH):
            return True
        tb = tb.tb_next
    return False


@dataclasses.dataclass
class _Speculation:
    """One precomputed head-job schedule plus its validity guards."""

    job_uid: int
    shape: tuple                  # (n_pods, gpus_per_pod, gpu_type, kind)
    snap: object                  # Snapshot identity (is-check)
    mut: int                      # snap.mut_count at speculation time
    fingerprint: tuple            # score-weight fingerprint
    result: object                # ScheduleResult
    consumed: bool = False


class CyclePipeline:
    """Per-QSCH pipeline state + hit/conflict/miss accounting.

    ``spec_seconds`` accumulates the wall time spent inside speculative
    work — the portion of per-cycle cost that overlaps binding in a
    pipelined deployment.  The scale benchmark reports critical-path
    cycle time as (total cycle time − spec_seconds).
    """

    def __init__(self, qsch: "QSCH") -> None:
        self.qsch = qsch
        self.speculated = 0   # speculations computed
        self.hits = 0         # consumed by RSCH under all guards
        self.conflicts = 0    # invalidated by the begin-of-cycle re-check
        self.misses = 0       # armed but never consumed (prediction miss)
        self.errors = 0       # speculation aborted by a plugin's exception
        self.spec_seconds = 0.0

    # ------------------------------------------------------------------
    def begin_cycle(self, state: "ClusterState") -> None:
        """Conflict re-check: arm the speculation for this cycle, or
        abandon it if anything mutated since the speculative refresh."""
        spec = self._spec
        self._spec = None
        self._armed = None
        if spec is None:
            return
        if (not state.dirty_nodes and not state.invariants_dirty
                and spec.snap.mut_count == spec.mut):
            self.qsch.rsch.speculation = spec
            self._armed = spec
        else:
            self.conflicts += 1

    def end_cycle(self, state: "ClusterState", now: float) -> None:
        """Account this cycle's speculation outcome, then speculate for
        the next cycle against the freshly-folded snapshot."""
        rsch = self.qsch.rsch
        armed, self._armed = self._armed, None
        rsch.speculation = None
        if armed is not None:
            if armed.consumed:
                self.hits += 1
            else:
                self.misses += 1
        self._speculate(state, now)

    # ------------------------------------------------------------------
    _spec: Optional[_Speculation] = None
    _armed: Optional[_Speculation] = None

    def _predict_head(self, ctx: CycleContext):
        """The job whose ``RSCH.schedule`` call opens the next cycle:
        head of the QueueSort-merged pending queue that passes BOTH
        admission tiers — ``try_place`` only reaches ``schedule`` past
        static quota and dynamic feasibility, so a blocked head must be
        skipped here exactly as the cycle will skip it.  Both Admit
        chains are pure reads (quota/feasibility), so probing them
        speculatively has no side effects.  A wrong prediction is
        harmless (counted as a miss, never consumed)."""
        qsch = self.qsch
        strict = getattr(qsch.queue_policy, "strict_head", False)
        for job in qsch.pending_jobs():
            if not qsch.static_admit(job, ctx):
                continue          # never enters the global pass
            if qsch.dynamic_admit(job, ctx):
                return job
            # Dynamically blocked: try_place bounces off before the
            # schedule call.  Best-Effort/Backfill move on to the next
            # job; Strict FIFO ends the cycle at its blocked head.
            if strict:
                return None
        return None

    def _speculate(self, state: "ClusterState", now: float) -> None:
        qsch = self.qsch
        rsch = qsch.rsch
        # Elastic shape selection happens inside try_place (before
        # schedule) and telemetry records speculative phases it should
        # not — both regimes schedule unspeculated.
        if (qsch.elastic is not None or qsch.obs is not None
                or rsch.obs is not None):
            return
        t0 = time.perf_counter()
        try:
            snap = qsch.snapshotter.refresh(state)
            ctx = CycleContext(running=qsch.running, quota=qsch.quota,
                               sched=qsch, rsch=rsch, state=state,
                               snap=snap, now=now, result=CycleResult())
            head = self._predict_head(ctx)
            if head is None:
                return
            fingerprint = rsch._weights_fingerprint(head, snap)
            mut = snap.mut_count
            result = rsch.schedule(
                head, snap,
                SchedulingContext(running=qsch.running, quota=qsch.quota))
            self._spec = _Speculation(
                job_uid=head.uid,
                shape=(head.n_pods, head.gpus_per_pod,
                       int(head.gpu_type), head.kind),
                snap=snap, mut=mut, fingerprint=fingerprint,
                result=result)
            self.speculated += 1
        except Exception as exc:
            # Speculation is an optimization, never a correctness
            # dependency: a plugin that cannot run outside a live cycle
            # (e.g. reads CycleContext.now) disables it for that cycle.
            # A fault of the device path (kernel build or launch, the
            # seam) is no plugin's: counting it would hide it behind the
            # cycle's recompute, so it propagates.
            if raised_on_device_path(exc):
                raise
            self._spec = None
            self.errors += 1
        finally:
            self.spec_seconds += time.perf_counter() - t0

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {"speculated": self.speculated, "hits": self.hits,
                "conflicts": self.conflicts, "misses": self.misses,
                "errors": self.errors,
                "spec_seconds": self.spec_seconds}
