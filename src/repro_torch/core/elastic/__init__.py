"""Elastic training: scheduler × parallelism co-design.

A training job declares an :class:`ElasticSpec` — alternative DP×TP
parallelism plans at different GPU counts, each with a throughput
estimate (from a dry-run roofline via
:mod:`~repro_torch.core.elastic.estimate`, or supplied directly) — and an
**ElasticPolicy** plugin decides when to *shrink* the gang into
currently-free fragmented capacity instead of queueing for the ideal
shape, and when to *grow* it back at the next checkpoint boundary.
Reshapes reuse the checkpoint-restart machinery
(:mod:`repro_torch.core.dynamics.recovery`): the cost is restart overhead
plus work since the last checkpoint, and the simulator scales the
remaining work by the active plan's relative throughput.

* :mod:`~repro_torch.core.elastic.spec`     — ParallelismPlan / ElasticSpec;
* :mod:`~repro_torch.core.elastic.estimate` — plan throughput from dry-run
  artifacts (memoized; host only);
* :mod:`~repro_torch.core.elastic.policy`   — the built-in GreedyElastic
  policy (largest fitting plan, payback-gated grow);
* :mod:`~repro_torch.core.elastic.manager`  — the ElasticManager executing
  decisions through QSCH.

Enable with ``QSCH(..., elastic=ElasticManager())``; jobs without an
``ElasticSpec`` are scheduled byte-identically to the rigid path (gated
by ``benchmarks/elastic_bench.py``).  See ``docs/elastic.md``.
"""

from .estimate import (plan_cache, plan_cache_stats, scaling_artifacts,
                       spec_from_artifacts, step_time_from_terms)
from .manager import ElasticConfig, ElasticManager
from .policy import GreedyElastic
from .spec import ElasticSpec, ParallelismPlan

__all__ = [
    "ElasticSpec", "ParallelismPlan",
    "ElasticConfig", "ElasticManager", "GreedyElastic",
    "spec_from_artifacts", "scaling_artifacts", "step_time_from_terms",
    "plan_cache", "plan_cache_stats",
]
