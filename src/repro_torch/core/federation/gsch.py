"""GSCH — the federation's global scheduler.

Sits above the per-member QSCH/RSCH stacks and makes exactly two kinds
of decisions, both through the **ClusterSelect** extension point
(:class:`~repro_torch.core.framework.api.ClusterSelectPlugin`):

* **routing** — on arrival, pick the member a job is forwarded to:
  structural-fit mask ∧ plugin feasibility masks, then argmax of the
  summed plugin scores (+ a configurable bonus for members that can
  place the job *immediately*).  Ties break toward the lower member
  index.  O(members) per job: everything reads the cached
  :class:`~repro_torch.core.federation.summary.FederationSummary`.
* **spillover** — a job pending at a member past ``spill_deadline_s``
  is pulled back and re-routed to a member that can place it now,
  paying ``forward_delay_s`` (plus ``locality_penalty_s`` when leaving
  the job's home region) before it re-enters a tenant queue.  Instead
  of starving behind one member's backlog, capacity anywhere in the
  federation absorbs it.  With one member — or ``spillover=False`` —
  this is structurally a no-op, which is what keeps the degenerate
  single-member federation byte-identical to a plain Simulator run.

Federation-level tenant quotas (``federation_quota``) layer over the
members' own managers: a job that fails the global grant is held in the
GSCH backlog (never forwarded) until a completion frees quota; member
quotas still apply unchanged at admission inside each member.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..framework.api import ClusterSelectPlugin
from ..job import Job, JobState
from ..quota import QuotaManager
from .member import FederatedCluster
from .plugins import (LeastLoadedSelect, LocalityAffinitySelect,
                      QuotaFitSelect)
from .summary import FederationSummary, summarize


def default_select() -> Tuple[ClusterSelectPlugin, ...]:
    """The default routing chain: member-quota fit, load balance,
    region affinity."""
    return (QuotaFitSelect(), LeastLoadedSelect(),
            LocalityAffinitySelect())


@dataclasses.dataclass
class GSCHConfig:
    select: Sequence[ClusterSelectPlugin] = dataclasses.field(
        default_factory=default_select)
    # Spillover (anti-starvation re-routing).
    spillover: bool = True
    spill_deadline_s: float = 1800.0
    forward_delay_s: float = 60.0
    locality_penalty_s: float = 240.0
    max_spills_per_job: int = 4
    # Prefer members able to place the job this instant: added on top of
    # the plugin scores for immediate-fit members (0 disables).
    immediate_fit_bonus: float = 1000.0
    # Federation-level tenant quotas layered over member quotas.
    federation_quota: Optional[QuotaManager] = None
    # Summary staleness tolerance: the matrix is rebuilt (one O(nodes)
    # walk) at most once per window; decisions in between run on the
    # cached matrix plus the `committed` routing charges.  Keeps GSCH
    # cost per cycle O(members) even under dense arrival bursts.
    summary_max_age_s: float = 15.0


@dataclasses.dataclass
class RouteRecord:
    member: int
    since: float          # waiting at `member` since (arrival there)
    spills: int = 0


@dataclasses.dataclass
class RoutingStats:
    # Per-member count of jobs CURRENTLY routed there (a spill moves
    # the count with the job; `spills` keeps the forward history).
    routed: List[int]
    spills: int = 0
    cross_region_forwards: int = 0
    backlogged: int = 0               # federation-quota holds (events)
    summary_refreshes: int = 0


class GSCH:
    def __init__(self, fed: FederatedCluster,
                 config: Optional[GSCHConfig] = None) -> None:
        self.fed = fed
        self.config = config or GSCHConfig()
        self.stats = RoutingStats(routed=[0] * len(fed))
        self.routes: Dict[int, RouteRecord] = {}
        # Jobs held by the federation quota, FIFO.
        self.backlog: List[Job] = []
        self._charged: Dict[int, Job] = {}
        self._gpu_types = fed.gpu_types()
        self._summary: Optional[FederationSummary] = None
        # Per-member lower bound on the earliest `since` of a routed,
        # possibly-still-pending job: lets the per-TICK spill check
        # return in O(1) until a deadline can actually have expired.
        self._earliest_since: Dict[int, float] = {}

    # ------------------------------------------------------------------
    # Summary cache: at most one node-array walk per staleness window
    # ------------------------------------------------------------------
    def summary(self, t: float) -> FederationSummary:
        s = self._summary
        if (s is None or t < s.t
                or t - s.t > self.config.summary_max_age_s):
            self._summary = summarize(self.fed.members, t,
                                      gpu_types=self._gpu_types)
            self.stats.summary_refreshes += 1
        return self._summary

    def invalidate(self) -> None:
        """Drop the cached summary (tests / external state surgery)."""
        self._summary = None

    # ------------------------------------------------------------------
    # Member selection (the ClusterSelect chain)
    # ------------------------------------------------------------------
    def select_member(self, job: Job, summary: FederationSummary,
                      exclude: Optional[int] = None,
                      require_immediate: bool = False,
                      extra_mask: Optional[np.ndarray] = None
                      ) -> Optional[int]:
        mask = summary.structural_fit(job)
        if exclude is not None:
            mask = mask.copy()
            mask[exclude] = False
        if require_immediate:
            mask = mask & summary.immediate_fit(job)
        if extra_mask is not None:
            mask = mask & extra_mask
        if not mask.any():
            if require_immediate or exclude is not None:
                return None            # spillover: no viable target
            # Nothing fits structurally (pool absent / gang too wide
            # everywhere): park the job at the biggest pool so it waits
            # exactly like it would on a lone cluster.
            c = summary.col(job.gpu_type)
            if c is None:
                return 0
            return int(np.argmax(summary.capacity[:, c]))
        scores = np.zeros(summary.n_members)
        for plugin in self.config.select:
            fm = plugin.feasible(job, summary)
            if fm is not None:
                narrowed = mask & np.asarray(fm, dtype=bool)
                if narrowed.any():
                    # A veto that would empty the mask is ignored: a
                    # plugin may delay preference but not strand a job.
                    mask = narrowed
            term = plugin.score(job, summary)
            if term is not None:
                scores = scores + np.asarray(term, dtype=float)
        if self.config.immediate_fit_bonus:
            scores = scores + (self.config.immediate_fit_bonus
                               * summary.immediate_fit(job))
        scores = np.where(mask, scores, -np.inf)
        return int(np.argmax(scores))   # ties -> lowest member index

    # ------------------------------------------------------------------
    # Routing (arrival path)
    # ------------------------------------------------------------------
    def route(self, job: Job, t: float) -> Optional[int]:
        """Pick a member for an arriving job; ``None`` = held in the
        federation-quota backlog."""
        fq = self.config.federation_quota
        if fq is not None and not fq.can_admit(job):
            self.backlog.append(job)
            self.stats.backlogged += 1
            return None
        summary = self.summary(t)
        target = self.select_member(job, summary)
        if fq is not None:
            fq.charge(job)
            self._charged[job.uid] = job
        summary.commit(target, job)
        self.routes[job.uid] = RouteRecord(member=target, since=t)
        self._note_pending(target, t)
        self.stats.routed[target] += 1
        return target

    def _note_pending(self, member: int, since: float) -> None:
        cur = self._earliest_since.get(member)
        if cur is None or since < cur:
            self._earliest_since[member] = since

    def drain_backlog(self, t: float) -> List[Tuple[Job, int]]:
        """Re-try federation-quota holds (after completions freed
        quota).  Returns ``(job, member)`` routes to forward."""
        fq = self.config.federation_quota
        if fq is None or not self.backlog:
            return []
        out: List[Tuple[Job, int]] = []
        held: List[Job] = []
        for job in self.backlog:
            if fq.can_admit(job):
                summary = self.summary(t)
                target = self.select_member(job, summary)
                fq.charge(job)
                self._charged[job.uid] = job
                summary.commit(target, job)
                self.routes[job.uid] = RouteRecord(member=target, since=t)
                self._note_pending(target, t)
                self.stats.routed[target] += 1
                out.append((job, target))
            else:
                held.append(job)
        self.backlog = held
        return out

    def on_job_finished(self, job: Job) -> None:
        """Completion observed on a member bus: release the federation-
        level grant (member quota was already refunded by its QSCH)."""
        if self._charged.pop(job.uid, None) is not None:
            self.config.federation_quota.refund(job)

    # ------------------------------------------------------------------
    # Spillover (anti-starvation re-routing)
    # ------------------------------------------------------------------
    def forward_delay(self, job: Job, target: int) -> float:
        """Forwarding cost: base delay + locality penalty when the job
        leaves its home region (checkpoint/data transfer, ECCOS-style
        cross-cluster cost)."""
        delay = self.config.forward_delay_s
        if (job.region is not None
                and self.fed[target].region != job.region):
            delay += self.config.locality_penalty_s
        return delay

    def maybe_spill(self, member: int, t: float
                    ) -> List[Tuple[Job, int, float]]:
        """After member ``member`` ran a cycle at ``t``: pull jobs that
        waited past the deadline and re-route each to a member that can
        place it NOW.  Returns ``(job, target, arrival_t)`` forwards
        (the federated simulator pushes the SUBMITs).  O(pending) scan +
        O(members) per overdue job — and an empty list without touching
        the summary when nothing is overdue."""
        cfg = self.config
        if not cfg.spillover or len(self.fed) == 1:
            return []
        # Cheap early-out: nothing routed here long enough ago for any
        # deadline to have expired (the bound is refreshed below).  A
        # cleared bound re-arms at `t` while pending work exists, so a
        # job requeued by preemption/failure still gets rescued one
        # deadline later.
        qsch = self.fed[member].qsch
        earliest = self._earliest_since.get(member)
        if earliest is None:
            if qsch.queue_depth():
                self._earliest_since[member] = t
            return []
        if t - earliest < cfg.spill_deadline_s:
            return []
        overdue: List[Tuple[float, int, Job]] = []
        waiting_since: List[float] = []
        for q in qsch.queues.values():
            for job in q:
                if job.state is not JobState.PENDING:
                    continue
                rec = self.routes.get(job.uid)
                if rec is None or rec.member != member:
                    continue
                if rec.spills >= cfg.max_spills_per_job:
                    continue
                if t - rec.since >= cfg.spill_deadline_s:
                    overdue.append((rec.since, job.uid, job))
                else:
                    waiting_since.append(rec.since)
        if not overdue:
            # Tighten the bound to the true earliest still-pending job
            # so the scan does not repeat every tick.
            if waiting_since:
                self._earliest_since[member] = min(waiting_since)
            else:
                self._earliest_since.pop(member, None)
            return []
        overdue.sort(key=lambda e: (e[0], e[1]))
        out: List[Tuple[Job, int, float]] = []
        summary = self.summary(t)
        for since, _, job in overdue:
            c = summary.col(job.gpu_type)
            if c is None:
                continue                      # no such pool anywhere
            if summary.immediate_fit(job)[member]:
                # Home can place it right now (a completion just freed
                # capacity): the next local cycle is cheaper than any
                # forward.
                waiting_since.append(since)
                continue
            # A spill target must have free capacity beyond what its
            # OWN pending backlog in THIS pool already claims: by
            # submit order an old forwarded job jumps the target queue,
            # so landing it on a backlogged member just moves the
            # starvation.
            headroom = (summary.free[:, c] - summary.committed[:, c]
                        - summary.pending_gang_by_type[:, c])
            uncongested = headroom >= job.n_gpus
            target = self.select_member(job, summary, exclude=member,
                                        require_immediate=True,
                                        extra_mask=uncongested)
            if target is None:
                waiting_since.append(since)   # still stuck here
                continue
            qsch._remove_from_queue(job)
            delay = self.forward_delay(job, target)
            arrival = t + delay
            summary.commit(target, job)
            rec = self.routes[job.uid]
            rec.member = target
            rec.since = arrival
            rec.spills += 1
            self.stats.spills += 1
            if self.fed[target].region != self.fed[member].region:
                self.stats.cross_region_forwards += 1
            self.stats.routed[member] -= 1
            self.stats.routed[target] += 1
            out.append((job, target, arrival))
        if waiting_since:
            self._earliest_since[member] = min(waiting_since)
        else:
            self._earliest_since.pop(member, None)
        return out
