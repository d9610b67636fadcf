"""Carry a cluster state across from plain arrays.

For a scheduler the state takes the place of a model's weights: to hold
the port against the reference at one mid-run moment, the reference's
state is exported as arrays (the six ground-truth columns of
:class:`~repro_torch.core.columns.StateColumns` plus the
:class:`~repro_torch.core.topology.ClusterTopology` constructor fields)
and rebuilt here.  Derived columns (free/used/busy/healthy counts,
fragmentation) are re-derived from the bitmaps, never copied, so the
port's state cannot inherit drift.  The allocation ledger starts empty:
the rebuilt state is a placement target, not a replay of who holds what.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .cluster import ClusterState
from .columns import StateColumns
from .topology import ClusterTopology

# Ground-truth columns and their dtypes (StateColumns layout contract).
GROUND_TRUTH = {"gpu_type": np.int32, "gpu_busy": np.bool_,
                "gpu_healthy": np.bool_, "node_healthy": np.bool_,
                "inference_zone": np.bool_, "node_draining": np.bool_}


def topology_fields_of(topology) -> Dict[str, int]:
    """The constructor fields of a topology object (either package's)."""
    return {f.name: getattr(topology, f.name)
            for f in dataclasses.fields(ClusterTopology) if f.init}


def state_from_arrays(topology_fields: Dict[str, int],
                      columns: Dict[str, np.ndarray]) -> ClusterState:
    """Build the port's :class:`ClusterState` from topology fields and
    the six ground-truth columns; raises ``ValueError`` on a missing
    column or a shape that disagrees with the topology."""
    topo = ClusterTopology(**topology_fields)
    n, g = topo.n_nodes, topo.gpus_per_node
    missing = set(GROUND_TRUTH) - set(columns)
    if missing:
        raise ValueError(f"missing ground-truth columns: {sorted(missing)}")
    truth = {}
    for name, dtype in GROUND_TRUTH.items():
        a = np.array(columns[name], dtype=dtype, copy=True)
        want = (n, g) if name in ("gpu_busy", "gpu_healthy") else (n,)
        if a.shape != want:
            raise ValueError(f"{name} has shape {a.shape}, expected {want}")
        truth[name] = a
    cols = StateColumns(
        **truth,
        free_gpus=np.zeros(n, dtype=np.int32),
        used_gpus=np.zeros(n, dtype=np.int32),
        busy_count=np.zeros(n, dtype=np.int32),
        healthy_count=np.zeros(n, dtype=np.int32),
        fragmented=np.zeros(n, dtype=bool))
    state = ClusterState(topo, cols)
    state.refresh_all_derived()
    return state
