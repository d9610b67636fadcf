"""Plan throughput estimation from dry-run analysis artifacts.

A dry-run writes one JSON per (arch × shape × mesh) combo with roofline
terms over the *partitioned per-device* program:

* ``compute_term_s``    — flops_per_device / peak_flops
* ``memory_term_s``     — bytes_per_device / memory bandwidth
* ``collective_term_s`` — collective bytes_per_device / link bandwidth

:mod:`repro_torch.launch.dryrun` writes them
(``experiments/dryrun/*.json``); :func:`scaling_artifacts` stands in
whenever no sweep exists, as it does in the reference.

This module turns those artifacts into :class:`ParallelismPlan`s: the
roofline step-time estimate overlaps compute with memory traffic
(``max``) and adds the exposed collective time, and a plan's throughput
is ``1 / step_time`` — the same global batch is processed every step,
so relative throughput across chip counts is exactly the inverse
step-time ratio.

Plan derivation is memoized through the
:class:`~repro_torch.launch.combo_cache.ComboCache` machinery, keyed by
(arch, shape, chip-count tuple): enumerating the candidate plans of
every elastic job in a trace hits the cache after the first job of
each model family (the elastic benchmark reports the counters).

Artifacts are plain dicts, read from JSON or synthesized via
:func:`scaling_artifacts`; nothing on this path touches a device.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

from ...launch.combo_cache import ComboCache
from .spec import ElasticSpec, ParallelismPlan

__all__ = ["step_time_from_terms", "plan_from_artifact",
           "spec_from_artifacts", "scaling_artifacts", "plan_cache",
           "plan_cache_stats"]

#: Shared memo for derived plan tuples (see module docstring).
_PLAN_CACHE = ComboCache("elastic-plans")


def plan_cache() -> ComboCache:
    return _PLAN_CACHE


def plan_cache_stats() -> Dict[str, int]:
    """Hit/miss counters of the plan-derivation memo (reported by the
    elastic benchmark)."""
    return _PLAN_CACHE.stats()


# ----------------------------------------------------------------------
def step_time_from_terms(artifact: Mapping[str, float]) -> float:
    """Roofline step-time estimate from one dry-run artifact: compute
    overlapped with HBM traffic, plus exposed collective time."""
    compute = float(artifact.get("compute_term_s", 0.0))
    memory = float(artifact.get("memory_term_s", 0.0))
    collective = float(artifact.get("collective_term_s", 0.0))
    step = max(compute, memory) + collective
    if step <= 0:
        raise ValueError("artifact has no positive roofline term")
    return step


def plan_from_artifact(artifact: Mapping[str, object], *,
                       gpus_per_node: int = 8) -> ParallelismPlan:
    """One artifact (``chips`` + roofline terms) -> one plan, packed at
    node granularity like the workload generators."""
    chips = int(artifact["chips"])
    step = step_time_from_terms(artifact)
    if chips <= gpus_per_node:
        n_pods, per_pod = 1, chips
    else:
        if chips % gpus_per_node:
            raise ValueError(f"chip count {chips} not a multiple of "
                             f"gpus_per_node={gpus_per_node}")
        n_pods, per_pod = chips // gpus_per_node, gpus_per_node
    return ParallelismPlan(
        n_pods=n_pods, gpus_per_pod=per_pod, throughput=1.0 / step,
        name=f"{artifact.get('arch', '?')}@{chips}")


def spec_from_artifacts(artifacts: Sequence[Mapping[str, object]], *,
                        gpus_per_node: int = 8) -> ElasticSpec:
    """Artifacts for the SAME (arch, shape) at different chip counts ->
    an :class:`ElasticSpec`, memoized on (arch, shape, chip counts)."""
    if not artifacts:
        raise ValueError("need at least one dry-run artifact")
    archs = {str(a.get("arch")) for a in artifacts}
    shapes = {str(a.get("shape")) for a in artifacts}
    if len(archs) > 1 or len(shapes) > 1:
        raise ValueError(f"artifacts span multiple combos: "
                         f"{sorted(archs)} x {sorted(shapes)}")
    key = (archs.pop(), shapes.pop(),
           tuple(sorted(int(a["chips"]) for a in artifacts)),
           int(gpus_per_node))
    return _PLAN_CACHE.get_or(key, lambda: ElasticSpec(plans=tuple(
        plan_from_artifact(a, gpus_per_node=gpus_per_node)
        for a in artifacts)))


# ----------------------------------------------------------------------
def scaling_artifacts(arch: str, shape: str, chip_counts: Sequence[int], *,
                      base_step_s: float = 1.0, alpha: float = 0.85,
                      collective_frac: float = 0.15
                      ) -> List[Dict[str, object]]:
    """Synthetic artifacts following a power-law scaling model — the
    stand-in when no dry-run sweep exists (benchmarks, tests).

    Aggregate throughput scales as ``n^alpha`` (``alpha < 1``: growing
    the gang pays increasing collective overhead), so the per-combo
    step time is ``base_step_s / (n / n_max)^alpha`` relative to the
    largest count.  ``collective_frac`` of each step is attributed to
    the collective term so ``dominant_term``-style consumers see a
    plausible split.
    """
    if not chip_counts:
        raise ValueError("need at least one chip count")
    n_max = max(int(n) for n in chip_counts)
    out: List[Dict[str, object]] = []
    for n in chip_counts:
        step = float(base_step_s) / (int(n) / n_max) ** float(alpha)
        coll = step * float(collective_frac)
        out.append({
            "arch": arch, "shape": shape, "chips": int(n),
            "compute_term_s": step - coll, "memory_term_s": 0.0,
            "collective_term_s": coll,
        })
    return out
