"""Kant's core, ported: cluster model, QSCH, RSCH, plugin framework
(with the contrib plugins), simulator, cycle pipelining, cluster
dynamics, federation, elastic training and self-tuning, with the
Level-2 filter+score pass on a CUDA device.

Same layout and names as ``repro.core``.  Host bookkeeping stays numpy;
the device seam is :func:`repro_torch.core.scoring.compute_node_scores`
and :func:`~repro_torch.core.scoring.compute_node_scores_and_slots`,
which RSCH calls for every ``score_backend`` other than ``"np"``.
"""

from .bridge import state_from_arrays
from .cluster import ClusterState
from .dynamics import (CheckpointModel, ClusterDynamics, DrainWindow,
                       DynamicsConfig, DynamicsSummary, GpuFailureInjector,
                       NodeFailureInjector, TidalAutoscaler, TidalService)
from .elastic import (ElasticConfig, ElasticManager, ElasticSpec,
                      GreedyElastic, ParallelismPlan, scaling_artifacts,
                      spec_from_artifacts)
from .events import Event, EventBus, EventKind
from .federation import (FederatedCluster, FederatedResult,
                         FederatedSimulator, FederationSummary, GSCH,
                         GSCHConfig, MemberCluster, make_member)
from .framework import (CycleResult, PlacementPass, ProfileSet,
                        SchedulingProfile, default_profiles)
from .job import (Job, JobKind, JobState, Placement, PodPlacement,
                  PRIO_HIGH, PRIO_LOW, PRIO_NORMAL, size_bucket)
from .metrics import MetricsRecorder, waiting_percentile
from .qsch import QSCH, QSCHConfig, QueuePolicy
from .quota import QuotaManager, QuotaMode
from .rsch import RSCH, RSCHConfig, Strategy, profiles_from_config
from .scoring import (BINPACK, E_BINPACK, E_SPREAD, SPREAD, ScoreWeights,
                      combine_weights, compute_node_scores,
                      compute_node_scores_and_slots, node_scores_np,
                      select_gang_slots)
from .simulator import SimConfig, Simulator, SimResult
from .snapshot import (FullSnapshotter, IncrementalSnapshotter, Snapshot,
                       snapshots_equal)
from .topology import ClusterTopology, small_topology, \
    training_cluster_topology
from .tuning import (HillClimbController, NoOpController,
                     ObjectiveWeights, ParamChange, ParamSpace,
                     StarvationEscalator, TuningManager, TuningProfile,
                     TuningWindow)
from .workload import (DEFAULT_QUERY_CLASSES, QueryClass, ServeRequest,
                       backfill_training_trace, diurnal_demand,
                       inference_trace, request_trace, trace_stats,
                       training_trace)

__all__ = [
    "state_from_arrays",
    "ClusterState", "Job", "JobKind", "JobState", "Placement",
    "PodPlacement", "PRIO_HIGH", "PRIO_LOW", "PRIO_NORMAL", "size_bucket",
    "MetricsRecorder", "waiting_percentile",
    "QSCH", "QSCHConfig", "QueuePolicy", "QuotaManager",
    "QuotaMode", "RSCH", "RSCHConfig", "Strategy", "BINPACK", "E_BINPACK",
    "E_SPREAD", "SPREAD", "ScoreWeights", "combine_weights",
    "compute_node_scores", "compute_node_scores_and_slots",
    "node_scores_np", "select_gang_slots",
    "SimConfig", "Simulator", "SimResult", "FullSnapshotter",
    "IncrementalSnapshotter", "Snapshot", "snapshots_equal",
    "ClusterTopology", "small_topology", "training_cluster_topology",
    "backfill_training_trace", "diurnal_demand", "inference_trace",
    "trace_stats", "training_trace", "QueryClass", "ServeRequest",
    "DEFAULT_QUERY_CLASSES", "request_trace",
    # events + dynamics (full surface in repro_torch.core.dynamics)
    "Event", "EventBus", "EventKind", "ClusterDynamics", "DynamicsConfig",
    "DynamicsSummary", "NodeFailureInjector", "GpuFailureInjector",
    "DrainWindow", "CheckpointModel", "TidalAutoscaler", "TidalService",
    "CycleResult", "PlacementPass", "ProfileSet", "SchedulingProfile",
    "default_profiles", "profiles_from_config",
    # federation (full surface in repro_torch.core.federation)
    "FederatedCluster", "FederatedResult", "FederatedSimulator",
    "FederationSummary", "GSCH", "GSCHConfig", "MemberCluster",
    "make_member",
    # elastic training (full surface in repro_torch.core.elastic)
    "ElasticSpec", "ParallelismPlan", "ElasticConfig", "ElasticManager",
    "GreedyElastic", "spec_from_artifacts", "scaling_artifacts",
    # self-tuning (full surface in repro_torch.core.tuning)
    "TuningManager", "ParamSpace", "ParamChange", "TuningProfile",
    "TuningWindow", "ObjectiveWeights", "HillClimbController",
    "StarvationEscalator", "NoOpController",
]
