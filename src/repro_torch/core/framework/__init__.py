"""Pluggable scheduling framework: extension points + per-workload profiles.

Kube-scheduler-style plugin API for QSCH/RSCH (paper §3.2-§3.4): queue
policies, admission, vectorized node filtering/scoring, transactional
gang commit and preemption are all named extension points; a
:class:`SchedulingProfile` bundles one plugin chain per point and a
:class:`ProfileSet` selects a profile per workload kind
(train / inference / best-effort).

* :mod:`repro_torch.core.framework.api`      — plugin base classes + profiles;
* :mod:`repro_torch.core.framework.registry` — name -> plugin factory registry;
* :mod:`repro_torch.core.framework.builtin`  — the paper's behaviors as plugins
  plus the default train/inference/best-effort profiles;
* :mod:`repro_torch.core.framework.contrib`  — beyond-paper example plugins
  (GFR-aware fragmentation score, tenant and semantic soft-affinity).

See ``docs/plugins.md`` for the extension-point contract and a worked
"write your own Score plugin" example.
"""

from .api import (AdmitPlugin, ClusterSelectPlugin, ControllerPlugin,
                  CycleContext, CycleResult, DynamicsPlugin,
                  ElasticPolicyPlugin, FilterPlugin, ObserverPlugin,
                  PermitPlugin, PlacementPass, Plugin, PostBindPlugin,
                  PreemptPlugin, ProfileSet, QueuePolicyPlugin,
                  QueueSortPlugin, ReservePlugin, RouterPolicyPlugin,
                  SchedulingContext, SchedulingProfile, ScorePlugin,
                  obs_phase, obs_span, single_pass_plan)
from .builtin import (BackfillHeadTimeout, BackfillPolicy,
                      BestEffortFIFOPolicy, BinpackScore, ColocateBonus,
                      DefaultQueueSort, DynamicFeasibility, GpuTypeFilter,
                      GroupConsolidation, HealthFilter, PriorityPreempt,
                      QuotaAdmit, QuotaReclaimPreempt, QuotaReserve,
                      SpreadScore, StrictFIFOPolicy, TopoAnchor,
                      WeightSetScore, binpack_pass, default_profiles,
                      ebinpack_pass, espread_plan, espread_zone_pass,
                      make_profile, spread_pass)
from .contrib import (GfrAwareScore, SemanticSoftAffinity,
                      TenantSoftAffinity, token_similarity)
from .registry import available_plugins, create_plugin, register

__all__ = [
    # api
    "Plugin", "QueueSortPlugin", "AdmitPlugin", "FilterPlugin",
    "ScorePlugin", "ReservePlugin", "PermitPlugin", "PostBindPlugin",
    "PreemptPlugin", "QueuePolicyPlugin", "DynamicsPlugin",
    "ClusterSelectPlugin", "RouterPolicyPlugin", "ElasticPolicyPlugin",
    "ObserverPlugin", "ControllerPlugin", "PlacementPass",
    "SchedulingProfile", "ProfileSet", "SchedulingContext", "CycleContext",
    "CycleResult", "single_pass_plan", "obs_phase", "obs_span",
    # registry
    "register", "create_plugin", "available_plugins",
    # builtin
    "DefaultQueueSort", "QuotaAdmit", "DynamicFeasibility", "GpuTypeFilter",
    "HealthFilter", "WeightSetScore", "BinpackScore", "SpreadScore",
    "GroupConsolidation", "TopoAnchor", "ColocateBonus", "QuotaReserve",
    "PriorityPreempt", "QuotaReclaimPreempt", "BackfillHeadTimeout",
    "StrictFIFOPolicy", "BestEffortFIFOPolicy", "BackfillPolicy",
    "binpack_pass", "spread_pass", "ebinpack_pass", "espread_zone_pass",
    "espread_plan", "make_profile", "default_profiles",
    # contrib
    "GfrAwareScore", "TenantSoftAffinity", "SemanticSoftAffinity",
    "token_similarity",
]
