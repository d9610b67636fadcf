"""Cluster interconnect topology model (paper §3.3.5, §3.4.2).

Kant reasons about two interconnect hierarchies:

* **Scale-Out** — the RDMA fabric: access (Leaf) -> aggregation (Spine) ->
  core (Superspine) switches.  Each LeafGroup is abstracted as a
  ``NodeNetGroup``, the basic unit of Kant's hierarchical two-level
  scheduling (§3.4.2).  Communication quality degrades with the lowest
  common switch tier: same-leaf < same-spine < same-superspine < cross.
* **Scale-Up** — hyper-node HBD (Hyper Bandwidth Domain) domains in which
  every GPU of every member node is directly interconnected; EP/TP jobs
  are scheduled at HBD granularity.

Intra-node, GPUs are connected by links of decreasing bandwidth
(NVLink > PCIe > NUMA-remote, §3.3.5); we model this with integer *link
classes* (0 is best).  The scheduling logic only ever compares classes,
so it is hardware agnostic.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# Inter-node distance tiers (lowest common ancestor in the scale-out tree).
DIST_SAME_NODE = 0
DIST_SAME_LEAF = 1
DIST_SAME_SPINE = 2
DIST_SAME_SUPERSPINE = 3
DIST_CROSS = 4


@dataclasses.dataclass(frozen=True)
class ClusterTopology:
    """Static interconnect description for a cluster of ``n_nodes`` hosts.

    All per-node ids are dense ``np.ndarray[int32]`` of shape ``(n_nodes,)``
    so that scheduler scoring stays fully vectorized.
    """

    n_nodes: int
    gpus_per_node: int
    nodes_per_leaf: int
    leaves_per_spine: int
    spines_per_superspine: int
    nodes_per_hbd: int
    # GPUs [0, island) and [island, G) form two NVLink-class islands; a
    # value >= gpus_per_node means one flat all-to-all island (e.g. an
    # NVSwitch baseboard).
    nvlink_island: int = 8
    numa_split: int = 4  # GPUs below this index sit on NUMA node 0.

    leaf_id: np.ndarray = dataclasses.field(init=False, repr=False)
    spine_id: np.ndarray = dataclasses.field(init=False, repr=False)
    superspine_id: np.ndarray = dataclasses.field(init=False, repr=False)
    hbd_id: np.ndarray = dataclasses.field(init=False, repr=False)

    def __post_init__(self) -> None:
        if self.n_nodes <= 0:
            raise ValueError("n_nodes must be positive")
        if self.gpus_per_node <= 0:
            raise ValueError("gpus_per_node must be positive")
        if min(self.nodes_per_leaf, self.leaves_per_spine,
               self.spines_per_superspine, self.nodes_per_hbd) <= 0:
            raise ValueError("hierarchy arities must be positive")
        idx = np.arange(self.n_nodes, dtype=np.int32)
        leaf = idx // self.nodes_per_leaf
        spine = leaf // self.leaves_per_spine
        sspine = spine // self.spines_per_superspine
        hbd = idx // self.nodes_per_hbd
        object.__setattr__(self, "leaf_id", leaf)
        object.__setattr__(self, "spine_id", spine)
        object.__setattr__(self, "superspine_id", sspine)
        object.__setattr__(self, "hbd_id", hbd)

    # ------------------------------------------------------------------
    # Derived sizes
    # ------------------------------------------------------------------
    @property
    def n_gpus(self) -> int:
        return self.n_nodes * self.gpus_per_node

    @property
    def n_leaf_groups(self) -> int:
        return int(self.leaf_id[-1]) + 1

    @property
    def n_hbds(self) -> int:
        return int(self.hbd_id[-1]) + 1

    def leaf_members(self, leaf: int) -> np.ndarray:
        """Node indices belonging to NodeNetGroup ``leaf``."""
        return np.nonzero(self.leaf_id == leaf)[0].astype(np.int32)

    def hbd_members(self, hbd: int) -> np.ndarray:
        return np.nonzero(self.hbd_id == hbd)[0].astype(np.int32)

    # ------------------------------------------------------------------
    # Distances
    # ------------------------------------------------------------------
    def node_distance(self, a: int, b: int) -> int:
        """Scale-out distance tier between two nodes (§3.3.5 preference)."""
        if a == b:
            return DIST_SAME_NODE
        if self.leaf_id[a] == self.leaf_id[b]:
            return DIST_SAME_LEAF
        if self.spine_id[a] == self.spine_id[b]:
            return DIST_SAME_SPINE
        if self.superspine_id[a] == self.superspine_id[b]:
            return DIST_SAME_SUPERSPINE
        return DIST_CROSS

    def pairwise_node_distance(self, nodes: np.ndarray) -> np.ndarray:
        """Vectorized pairwise distance matrix for a set of node indices."""
        nodes = np.asarray(nodes, dtype=np.int32)
        leaf = self.leaf_id[nodes]
        spine = self.spine_id[nodes]
        ss = self.superspine_id[nodes]
        same = nodes[:, None] == nodes[None, :]
        d = np.full((len(nodes), len(nodes)), DIST_CROSS, dtype=np.int32)
        d = np.where(ss[:, None] == ss[None, :], DIST_SAME_SUPERSPINE, d)
        d = np.where(spine[:, None] == spine[None, :], DIST_SAME_SPINE, d)
        d = np.where(leaf[:, None] == leaf[None, :], DIST_SAME_LEAF, d)
        d = np.where(same, DIST_SAME_NODE, d)
        return d

    # ------------------------------------------------------------------
    # Intra-node GPU topology (§3.3.5 "Intra-Node GPU Topology")
    # ------------------------------------------------------------------
    def gpu_link_class(self) -> np.ndarray:
        """(G, G) matrix of link classes between GPU slots on one node.

        0 = same NVLink island (best), 1 = cross-island same NUMA (PCIe),
        2 = NUMA-remote.  Diagonal is 0.
        """
        g = self.gpus_per_node
        idx = np.arange(g)
        island = idx // max(1, self.nvlink_island)
        numa = (idx >= self.numa_split).astype(np.int32)
        cls = np.where(island[:, None] == island[None, :], 0,
                       np.where(numa[:, None] == numa[None, :], 1, 2))
        np.fill_diagonal(cls, 0)
        return cls.astype(np.int32)

    def nic_for_gpu(self) -> np.ndarray:
        """Best RDMA-NIC index per GPU slot (one NIC per NVLink island)."""
        idx = np.arange(self.gpus_per_node)
        return (idx // max(1, self.nvlink_island)).astype(np.int32)

    # ------------------------------------------------------------------
    # Optimal placement reference for JTTED (§4.5)
    # ------------------------------------------------------------------
    def optimal_node_num(self, n_gpus: int) -> int:
        """Minimum node count able to host ``n_gpus`` (ceil division)."""
        return -(-n_gpus // self.gpus_per_node)

    def optimal_group_num(self, n_gpus: int) -> int:
        """Minimum NodeNetGroup count for ``n_gpus``.

        "Optimal node number" in §4.5 is the minimum node count keeping
        all-to-all traffic inside a single LeafGroup when possible; a job
        larger than one group necessarily spans ``ceil(nodes/group_size)``
        groups.
        """
        nodes = self.optimal_node_num(n_gpus)
        return -(-nodes // self.nodes_per_leaf)


def small_topology(n_nodes: int = 16, gpus_per_node: int = 8,
                   nodes_per_leaf: int = 4) -> ClusterTopology:
    """Convenience topology for tests and examples."""
    return ClusterTopology(
        n_nodes=n_nodes,
        gpus_per_node=gpus_per_node,
        nodes_per_leaf=nodes_per_leaf,
        leaves_per_spine=2,
        spines_per_superspine=2,
        nodes_per_hbd=nodes_per_leaf,
        nvlink_island=gpus_per_node,  # flat island by default
        numa_split=gpus_per_node // 2,
    )


def training_cluster_topology(n_gpus: int = 8000, gpus_per_node: int = 8,
                              nodes_per_leaf: int = 32) -> ClusterTopology:
    """Paper §5.1: homogeneous 8 000-GPU training cluster."""
    n_nodes = n_gpus // gpus_per_node
    return ClusterTopology(
        n_nodes=n_nodes,
        gpus_per_node=gpus_per_node,
        nodes_per_leaf=nodes_per_leaf,
        leaves_per_spine=4,
        spines_per_superspine=4,
        nodes_per_hbd=nodes_per_leaf,
        nvlink_island=gpus_per_node,
        numa_split=gpus_per_node // 2,
    )
