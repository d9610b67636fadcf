"""The yardstick's table of peaks, and the operations and bytes of the
node-score kernel."""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet (dense, at the full 700 W power limit)
H100 = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12}

#: bytes a node-score pass reads per node: free, used (int32), mask
#: (bool), group_load, topo_pref (f32)
NODE_SCORE_READ_BYTES = 4 + 4 + 1 + 4 + 4
#: operations per node: 1 division, 4 multiplications, 3 additions
NODE_SCORE_FLOPS = 8


def node_score_bytes(rows: int, with_slots: bool) -> int:
    """Each input column read once and each output written once (scores
    f32, and slots int32 on the gang path) for ``rows`` nodes, the rows a
    call was given and not its padding."""
    return rows * (NODE_SCORE_READ_BYTES + 4 + (4 if with_slots else 0))


def node_score_least_s(rows: int, with_slots: bool, peaks=H100) -> float:
    """The least time one pass could take: bytes over HBM bandwidth or
    operations over the float32 peak, whichever is longer."""
    return max(node_score_bytes(rows, with_slots) / peaks["hbm_bytes_per_s"],
               rows * NODE_SCORE_FLOPS / peaks["f32_flops_per_s"])
