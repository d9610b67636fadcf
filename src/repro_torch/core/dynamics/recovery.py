"""Checkpoint-restart recovery model.

When a failure (or drain eviction) kills a job, the engine asks this
model what the *next attempt* costs.  The model mirrors the model-level
checkpointing story (:mod:`repro.ckpt.store`, wired into
``examples/train_e2e.py``) at scheduler granularity:

* training writes a checkpoint every ``interval_s`` seconds of
  progress; work since the last checkpoint is recomputed ("lost work");
* every restart pays ``restart_overhead_s`` up front (restore the
  checkpoint, rebuild the gang, warm caches);
* the ``scratch`` baseline never checkpoints: every failure restarts
  the job from zero — the paper-motivating ablation for
  ``benchmarks/dynamics_bench.py``;
* inference/debug pods are stateless services: interrupted serving time
  is not recomputed, only the restart overhead is paid.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..job import Job, JobKind


@dataclasses.dataclass
class CheckpointModel:
    """``mode`` is ``"checkpoint"`` (periodic checkpoints) or
    ``"scratch"`` (restart from zero)."""

    interval_s: float = 600.0
    restart_overhead_s: float = 120.0
    mode: str = "checkpoint"

    def __post_init__(self) -> None:
        if self.mode not in ("checkpoint", "scratch"):
            raise ValueError(f"unknown recovery mode {self.mode!r}")
        if self.interval_s <= 0:
            raise ValueError("checkpoint interval must be positive")

    # ------------------------------------------------------------------
    def attempt_overhead(self, job: Job) -> float:
        """Restore overhead baked into the front of the current attempt
        (zero for the first run — nothing to restore)."""
        return self.restart_overhead_s if job.attempt > 0 else 0.0

    def on_interrupt(self, job: Job, t: float
                     ) -> Tuple[float, float, float]:
        """Account a kill at time ``t``; returns ``(remaining, lost,
        overhead)``:

        * ``remaining`` — wall seconds the next attempt needs at the
          job's CURRENT shape (work left after the surviving
          checkpoint, plus restart overhead).  If an elastic job is
          restarted at a different plan, the
          :class:`~repro_torch.core.elastic.manager.ElasticManager`
          recomputes the attempt duration at placement time from the
          same checkpoint state;
        * ``lost`` — recompute debt: *wall* seconds this attempt spent
          past its last checkpoint (metrics multiply by the shape that
          burned them);
        * ``overhead`` — the restore cost added to the next attempt.

        Elastic jobs progress at ``job.work_rate`` work-seconds per
        wall second (1.0 for rigid jobs, making every expression below
        bit-identical to the pre-elastic model): checkpoints still
        happen every ``interval_s`` *wall* seconds, but the work they
        persist is scaled by the rate.

        Mutates the job's checkpoint bookkeeping
        (``checkpointed_progress`` / ``lost_work`` /
        ``restart_overhead``); the caller requeues with ``remaining``.
        """
        elapsed = 0.0
        if job.run_time is not None:
            # Killed before the container came up -> no progress at all.
            elapsed = max(0.0, float(t) - job.run_time)
        rate = job.work_rate
        # Wall seconds of actual progress this attempt, capped at the
        # wall time the remaining work takes at the active rate.
        progress = max(0.0, elapsed - self.attempt_overhead(job))
        work_left = job.original_duration - job.checkpointed_progress
        if rate > 0:
            progress = min(progress, work_left / rate)

        if job.kind is JobKind.TRAIN and self.mode == "checkpoint":
            saved = (progress // self.interval_s) * self.interval_s
        elif job.kind is JobKind.TRAIN:   # scratch: all progress redone
            saved = 0.0
        else:
            # Stateless service: serving time is never recomputed.
            saved = progress
        lost = progress - saved
        job.checkpointed_progress = min(
            job.original_duration, job.checkpointed_progress + saved * rate)

        overhead = self.restart_overhead_s
        remaining_work = job.original_duration - job.checkpointed_progress
        if rate > 0:
            remaining_work = remaining_work / rate
        remaining = remaining_work + overhead
        job.lost_work += lost
        job.restart_overhead += overhead
        return remaining, lost, overhead
