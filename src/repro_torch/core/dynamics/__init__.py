"""Cluster dynamics subsystem: failures, drains, tidal autoscaling.

Opens the scenario axis of the reproduction: the simulator's event bus
(:mod:`repro_torch.core.events`) carries NODE_FAIL / NODE_RECOVER /
GPU_FAIL / GPU_RECOVER / DRAIN_START / DRAIN_END / SCALE_DECISION
events alongside the classic SUBMIT/TICK/END, and this package supplies

* :mod:`~repro_torch.core.dynamics.failures` — seeded Weibull/exponential
  node and GPU failure injectors plus planned drain windows;
* :mod:`~repro_torch.core.dynamics.recovery` — the checkpoint-restart
  recovery model (and its restart-from-scratch ablation);
* :mod:`~repro_torch.core.dynamics.tidal`    — the tidal train/inference
  autoscaler riding the diurnal demand curve;
* :mod:`~repro_torch.core.dynamics.engine`   — the engine binding it all to a
  :class:`~repro_torch.core.simulator.Simulator`.

Enable with ``SimConfig(dynamics=DynamicsConfig(plugins=[...]))``; with
no config the simulator is byte-identical to the static-cluster one.
See ``docs/dynamics.md``.
"""

from .engine import ClusterDynamics, DynamicsConfig, DynamicsSummary
from .failures import DrainWindow, GpuFailureInjector, NodeFailureInjector
from .recovery import CheckpointModel
from .tidal import DemandSample, TidalAutoscaler, TidalService

__all__ = [
    "ClusterDynamics", "DynamicsConfig", "DynamicsSummary",
    "NodeFailureInjector", "GpuFailureInjector", "DrainWindow",
    "CheckpointModel", "TidalAutoscaler", "TidalService", "DemandSample",
]
