"""What the benchmark makes from a configuration and the seed, and hands
alike to the program and to the reference: the cluster's ground-truth
columns (GPU types, busy and healthy bitmaps, node health, the inference
zone, drains)."""

from __future__ import annotations

from typing import Dict

import numpy as np

#: a tag mixed into the seed, so the background's stream is its own
STREAM = 0x6267           # "bg"


def topology_fields(config: Dict) -> Dict[str, int]:
    return {k: int(v) for k, v in config["topology"].items()}


def cluster_columns(config: Dict, seed: int) -> Dict[str, np.ndarray]:
    """The six ground-truth columns at t = 0.  A ``background`` makes
    each node busy with probability ``busy_node_share``, holding a number
    of busy GPUs drawn uniformly from ``busy_gpus_low`` .. ``busy_gpus_high``,
    node by node from the seed (``chip_smoke.py::fragmented_state``, the
    reference's ``sched_scale_bench.py::make_state``); a busy node's busy
    GPUs are its lowest slots, belong to no job and stay busy."""
    topo = config["topology"]
    n, g = int(topo["n_nodes"]), int(topo["gpus_per_node"])
    busy = np.zeros((n, g), dtype=bool)
    bg = config.get("background")
    if bg:
        rng = np.random.default_rng([seed % 2 ** 64, STREAM])
        busy_nodes = rng.random(n) < float(bg["busy_node_share"])
        busy_count = rng.integers(int(bg["busy_gpus_low"]),
                                  int(bg["busy_gpus_high"]) + 1, size=n)
        busy = (np.arange(g) < busy_count[:, None]) & busy_nodes[:, None]
    zone = np.zeros(n, dtype=bool)
    zone[:int(config.get("inference_zone_nodes", 0))] = True
    return {"gpu_type": np.zeros(n, dtype=np.int32),
            "gpu_busy": busy,
            "gpu_healthy": np.ones((n, g), dtype=bool),
            "node_healthy": np.ones(n, dtype=bool),
            "inference_zone": zone,
            "node_draining": np.zeros(n, dtype=bool)}
