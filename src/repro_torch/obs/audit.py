"""Scheduling decision audit log (kube-scheduler style).

Answers "why did this job land *there*?" / "why was it rejected?" per
decision, the way kube-scheduler's scheduling framework reports filter
and score results:

* per placement attempt, each :class:`FilterStat` records how many
  nodes a Filter plugin (or a structural stage: drain windows, the
  inference-zone selector) eliminated, replaying the chain
  sequentially;
* for the pass that won, a :class:`ScoreBreakdown` per distinct bound
  node decomposes the fused score into per-ScorePlugin terms — their
  sum reproduces the fused kernel's score for that node (asserted in
  ``tests/test_torch_obs.py``);
* every eviction is a :class:`PreemptionRecord` naming the victim, the
  beneficiary it was evicted for, and the Preempt plugin that chose it.

:class:`DecisionAudit` is the built-in
:class:`~repro_torch.core.framework.api.ObserverPlugin` that retains these
records (ring-capped); any custom observer registered on the Telemetry
facade receives the same objects through ``on_bind`` / ``on_reject`` /
``on_preempt``.

The raw capture dicts are produced inside RSCH/QSCH (so the core never
imports this package); :func:`build_decision` lifts them into the
typed records.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional

import numpy as np

from ..core.framework.api import ObserverPlugin
from ..core.framework.registry import register

__all__ = ["FilterStat", "ScoreBreakdown", "PassAudit",
           "PlacementDecision", "PreemptionRecord", "DecisionAudit",
           "build_decision"]


@dataclasses.dataclass(frozen=True)
class FilterStat:
    """One Filter-chain stage: nodes remaining before/after its mask."""

    plugin: str
    nodes_before: int
    nodes_after: int

    @property
    def eliminated(self) -> int:
        return self.nodes_before - self.nodes_after


@dataclasses.dataclass(frozen=True)
class ScoreBreakdown:
    """Per-ScorePlugin decomposition of one bound node's fused score.

    ``sum(terms.values())`` reproduces ``total`` (the fused
    filter+score kernel's value at the node, including snapshot-static
    extra terms) up to float32-vs-float64 rounding."""

    node: int
    total: float
    terms: Dict[str, float]


@dataclasses.dataclass
class PassAudit:
    """One PlacementPass attempt inside a decision."""

    zone: Optional[str]
    reason: str
    filters: List[FilterStat]
    pool_size: int
    breakdown: List[ScoreBreakdown] = dataclasses.field(
        default_factory=list)
    colocate_per_pod: float = 0.0


class PlacementDecision:
    """One placement or rejection, with full attribution.

    Not a dataclass: ``passes`` lifts the raw RSCH capture into typed
    :class:`PassAudit` records lazily, on first read — the bind hot
    path only stashes a reference (the ≤5% attached-overhead budget of
    ``chip_smoke.py``'s ``obs`` phase counts on this)."""

    __slots__ = ("uid", "tenant", "kind", "outcome", "reason", "t",
                 "profile", "member", "_nodes", "_placement",
                 "_raw_passes", "_passes")

    def __init__(self, uid: int, tenant: str, kind: str, outcome: str,
                 reason: str, t: float, profile: str = "",
                 member: Optional[str] = None,
                 nodes: Optional[List[int]] = None,
                 raw_passes=()) -> None:
        self.uid = uid
        self.tenant = tenant
        self.kind = kind
        self.outcome = outcome                # "bound" | "rejected"
        self.reason = reason                  # "ok" | rejection reason
        self.t = t
        self.profile = profile
        self.member = member
        self._nodes: Optional[List[int]] = (list(nodes) if nodes
                                            else None)
        self._placement = None
        self._raw_passes = tuple(raw_passes)
        self._passes: Optional[List[PassAudit]] = None

    @property
    def nodes(self) -> List[int]:
        """Sorted distinct bound nodes (lazy off the stashed placement)."""
        if self._nodes is None:
            pl = self._placement
            self._nodes = (sorted({p.node for p in pl.pods})
                           if pl is not None else [])
        return self._nodes

    @nodes.setter
    def nodes(self, value) -> None:
        self._nodes = list(value)

    @property
    def passes(self) -> List[PassAudit]:
        if self._passes is None:
            self._passes = [_lift_pass(p) for p in self._raw_passes]
        return self._passes

    def as_dict(self) -> Dict[str, object]:
        return {"uid": self.uid, "tenant": self.tenant,
                "kind": self.kind, "outcome": self.outcome,
                "reason": self.reason, "t": self.t,
                "profile": self.profile, "member": self.member,
                "nodes": self.nodes,
                "passes": [dataclasses.asdict(p) for p in self.passes]}

    def __repr__(self) -> str:
        return (f"<PlacementDecision uid={self.uid} {self.outcome}"
                f" reason={self.reason!r}>")


@dataclasses.dataclass
class PreemptionRecord:
    """One eviction: who was killed, for whom, and which plugin said so."""

    victim_uid: int
    victim_tenant: str
    victim_n_gpus: int
    beneficiary_uid: Optional[int]
    plugin: str
    t: float
    member: Optional[str] = None

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def _lift_pass(p: Dict) -> PassAudit:
    stats = [FilterStat(plugin=name, nodes_before=before,
                        nodes_after=after)
             for name, before, after in p.get("filters", ())]
    breakdown: List[ScoreBreakdown] = []
    bd = p.get("breakdown")
    if bd:
        # The capture is gathers-only (see RSCH._audit_breakdown); the
        # fused-term arithmetic mirroring node_scores_np and the
        # per-node pivot happen here, off the bind hot path.
        used_norm = bd["used"].astype(np.float64) / bd["g"]
        exact_fit = (bd["free"] == bd["request"]).astype(np.float64)
        gload = bd["gload"].astype(np.float64)
        tpref = bd["tpref"].astype(np.float64)
        cols: Dict[str, "np.ndarray"] = {}
        for name, w_used, w_fit, w_group, w_topo in bd["weights"]:
            val = (w_used * used_norm + w_fit * exact_fit
                   + w_group * gload + w_topo * tpref)
            cols[name] = cols[name] + val if name in cols else val
        for name, term in bd["extra"].items():
            term = np.asarray(term, dtype=np.float64)
            cols[name] = cols[name] + term if name in cols else term
        totals = bd["totals"].astype(np.float64)
        terms = {k: [float(v) for v in col] for k, col in cols.items()}
        for i, node in enumerate(bd["nodes"]):
            breakdown.append(ScoreBreakdown(
                node=int(node), total=float(totals[i]),
                terms={k: terms[k][i] for k in terms}))
    return PassAudit(
        zone=p.get("zone"), reason=p.get("reason", ""),
        filters=stats, pool_size=int(p.get("pool", 0)),
        breakdown=breakdown,
        colocate_per_pod=float(p.get("colocate_per_pod", 0.0)))


def build_decision(job, capture: Optional[Dict], outcome: str,
                   reason: str, t: float,
                   member: Optional[str] = None) -> PlacementDecision:
    """Wrap RSCH's raw capture dict in a decision record (typed pass
    audits materialize lazily through ``decision.passes``).

    ``capture`` is ``None`` for decisions made before RSCH ran (static
    admission / dynamic feasibility rejections) — the decision then
    carries no pass audits, only the outcome."""
    if capture is None:
        capture = {}
    return PlacementDecision(
        uid=job.uid, tenant=job.tenant, kind=job.kind.name,
        outcome=outcome, reason=reason, t=float(t),
        profile=capture.get("profile", ""), member=member,
        raw_passes=capture.get("passes", ()))


@register
class DecisionAudit(ObserverPlugin):
    """Built-in observer retaining the decision/preemption history.

    ``max_records`` bounds memory on long runs: the oldest records are
    dropped (FIFO) and counted in ``dropped`` — never silently."""

    name = "DecisionAudit"

    def __init__(self, max_records: int = 20_000) -> None:
        self.decisions: Deque[PlacementDecision] = collections.deque(
            maxlen=max_records)
        self.preemptions: Deque[PreemptionRecord] = collections.deque(
            maxlen=max_records)
        # Tuning parameter moves (repro_torch.core.tuning ParamChange records).
        self.param_changes: Deque = collections.deque(maxlen=max_records)
        self._seen_decisions = 0
        self._seen_preemptions = 0
        self._seen_param_changes = 0

    # -- ObserverPlugin hooks ------------------------------------------
    def on_bind(self, job, decision, ctx) -> None:
        if decision is not None:
            self._seen_decisions += 1
            self.decisions.append(decision)

    def on_reject(self, job, decision, ctx) -> None:
        if decision is not None:
            self._seen_decisions += 1
            self.decisions.append(decision)

    def on_preempt(self, record, ctx) -> None:
        if record is not None:
            self._seen_preemptions += 1
            self.preemptions.append(record)

    def on_param_change(self, change, scope=None) -> None:
        self._seen_param_changes += 1
        self.param_changes.append(change)

    # -- accessors -----------------------------------------------------
    @property
    def dropped(self) -> int:
        return ((self._seen_decisions - len(self.decisions))
                + (self._seen_preemptions - len(self.preemptions))
                + (self._seen_param_changes - len(self.param_changes)))

    def bound(self) -> List[PlacementDecision]:
        return [d for d in self.decisions if d.outcome == "bound"]

    def rejected(self) -> List[PlacementDecision]:
        return [d for d in self.decisions if d.outcome == "rejected"]

    def rejections_by_reason(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.rejected():
            out[d.reason] = out.get(d.reason, 0) + 1
        return out

    def summary(self) -> Dict[str, object]:
        return {
            "decisions": self._seen_decisions,
            "bound": len(self.bound()),
            "rejected": len(self.rejected()),
            "rejections_by_reason": self.rejections_by_reason(),
            "preemptions": self._seen_preemptions,
            "param_changes": self._seen_param_changes,
            "dropped": self.dropped,
        }

    def to_json(self) -> Dict[str, object]:
        return {
            "summary": self.summary(),
            "decisions": [d.as_dict() for d in self.decisions],
            "preemptions": [p.as_dict() for p in self.preemptions],
            "param_changes": [c.as_dict() for c in self.param_changes],
        }
