"""Tenant quota management (paper §3.2.1 "Static Quota Admission").

GPU quotas are kept per tenant *and per GPU model* (node pools, §3.4.1).
Two modes:

* **Isolated** — a tenant can never exceed its own quota (strong isolation);
* **Shared** — a tenant may borrow unused quota from other tenants; the
  owner can later *reclaim* the loan via preemption (§3.2.3 "Quota
  Reclamation Preemption").

The ledger tracks how many GPUs of each running job were satisfied from
borrowed quota so reclamation can pick concrete victims.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

from .job import Job


class QuotaMode(enum.Enum):
    ISOLATED = "isolated"
    SHARED = "shared"


@dataclasses.dataclass
class QuotaManager:
    # quota[tenant][gpu_type] -> GPUs granted.
    quota: Dict[str, Dict[int, int]]
    mode: QuotaMode = QuotaMode.ISOLATED
    # used[tenant][gpu_type] -> GPUs currently charged.
    used: Dict[str, Dict[int, int]] = dataclasses.field(default_factory=dict)
    # borrows[(borrower, gpu_type)] -> GPUs taken beyond own quota.
    borrows: Dict[Tuple[str, int], int] = dataclasses.field(
        default_factory=dict)

    # ------------------------------------------------------------------
    def _get(self, table: Dict[str, Dict[int, int]], tenant: str,
             gpu_type: int) -> int:
        return table.get(tenant, {}).get(gpu_type, 0)

    def _bump(self, tenant: str, gpu_type: int, delta: int) -> None:
        self.used.setdefault(tenant, {}).setdefault(gpu_type, 0)
        self.used[tenant][gpu_type] += delta
        if self.used[tenant][gpu_type] < 0:
            raise AssertionError("negative quota usage")

    def tenant_quota(self, tenant: str, gpu_type: int) -> int:
        return self._get(self.quota, tenant, gpu_type)

    def tenant_used(self, tenant: str, gpu_type: int) -> int:
        return self._get(self.used, tenant, gpu_type)

    def total_quota(self, gpu_type: int) -> int:
        return sum(q.get(gpu_type, 0) for q in self.quota.values())

    def total_used(self, gpu_type: int) -> int:
        return sum(u.get(gpu_type, 0) for u in self.used.values())

    # ------------------------------------------------------------------
    # Admission (§3.2.1)
    # ------------------------------------------------------------------
    def can_admit(self, job: Job) -> bool:
        """Static quota admission check (does not mutate)."""
        own_free = (self.tenant_quota(job.tenant, job.gpu_type)
                    - self.tenant_used(job.tenant, job.gpu_type))
        if own_free >= job.n_gpus:
            return True
        if self.mode is QuotaMode.ISOLATED:
            return False
        # Shared mode: borrow from the pool-wide unused quota.
        pool_free = (self.total_quota(job.gpu_type)
                     - self.total_used(job.gpu_type))
        return pool_free >= job.n_gpus

    def charge(self, job: Job) -> None:
        """Charge a job's GPUs against quota; records borrowing."""
        if not self.can_admit(job):
            raise ValueError(f"job {job.uid} fails static quota admission")
        own_free = (self.tenant_quota(job.tenant, job.gpu_type)
                    - self.tenant_used(job.tenant, job.gpu_type))
        borrowed = max(0, job.n_gpus - max(0, own_free))
        self._bump(job.tenant, job.gpu_type, job.n_gpus)
        if borrowed:
            key = (job.tenant, job.gpu_type)
            self.borrows[key] = self.borrows.get(key, 0) + borrowed
            job.borrowed_quota = borrowed

    def refund(self, job: Job) -> None:
        self._bump(job.tenant, job.gpu_type, -job.n_gpus)
        if job.borrowed_quota:
            key = (job.tenant, job.gpu_type)
            left = self.borrows.get(key, 0) - job.borrowed_quota
            if left > 0:
                self.borrows[key] = left
            else:
                self.borrows.pop(key, None)
            job.borrowed_quota = 0

    # ------------------------------------------------------------------
    # Quota reclamation (§3.2.3)
    # ------------------------------------------------------------------
    def reclaim_candidates(self, owner: str, gpu_type: int,
                           running_jobs: List[Job]) -> List[Job]:
        """Jobs whose borrowed quota blocks ``owner`` from using its own.

        Returns borrower jobs (most recently started first) whose
        preemption would return quota to the owner's pool.  Only relevant
        in shared mode when the owner is below its quota but the pool is
        exhausted.
        """
        if self.mode is not QuotaMode.SHARED:
            return []
        own_free = (self.tenant_quota(owner, gpu_type)
                    - self.tenant_used(owner, gpu_type))
        if own_free <= 0:
            return []
        victims = [j for j in running_jobs
                   if j.tenant != owner and j.gpu_type == gpu_type
                   and j.borrowed_quota > 0 and j.preemptible]
        victims.sort(key=lambda j: (j.priority, -(j.start_time or 0.0)))
        return victims

    def snapshot(self) -> Dict[str, Dict[int, int]]:
        return {t: dict(u) for t, u in self.used.items()}
