"""Member clusters of a federation.

The paper deploys Kant across *multiple* AI data-center clusters; a
:class:`MemberCluster` is one of them — a full single-cluster scheduling
stack (topology, state, QSCH/RSCH with its own profile set and
:class:`~repro_torch.core.quota.QuotaManager`, optionally its own cluster
dynamics) plus the federation-facing attributes the global scheduler
routes on: region, per-pool cost and capability tables.

Members are deliberately heterogeneous: different node counts,
``gpus_per_node``, GPU-type pools, scheduling profiles and failure
models can coexist in one :class:`FederatedCluster`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..cluster import ClusterState
from ..qsch import QSCH, QSCHConfig, QueuePolicy
from ..quota import QuotaManager, QuotaMode
from ..rsch import RSCH, RSCHConfig, Strategy
from ..simulator import SimConfig
from ..topology import ClusterTopology


@dataclasses.dataclass
class MemberCluster:
    """One member: a self-contained scheduling stack + routing traits."""

    name: str
    topology: ClusterTopology
    state: ClusterState
    qsch: QSCH
    sim_config: SimConfig = dataclasses.field(default_factory=SimConfig)
    region: str = "default"
    # Routing traits (ECCOS-style capability/cost coordination): relative
    # $-cost and capability score per GPU type hosted by this member.
    cost_per_gpu_hour: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    capability: Dict[int, float] = dataclasses.field(default_factory=dict)

    @property
    def quota(self) -> QuotaManager:
        return self.qsch.quota

    def gpu_types(self) -> List[int]:
        """GPU-type pools hosted by this member."""
        return [int(t) for t in np.unique(self.state.gpu_type)]


@dataclasses.dataclass
class FederatedCluster:
    """N heterogeneous members fronted by the GSCH (see ``gsch.py``)."""

    members: List[MemberCluster]

    def __post_init__(self) -> None:
        if not self.members:
            raise ValueError("a federation needs at least one member")
        names = [m.name for m in self.members]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate member names: {names}")

    def __len__(self) -> int:
        return len(self.members)

    def __getitem__(self, i: int) -> MemberCluster:
        return self.members[i]

    def gpu_types(self) -> List[int]:
        """Sorted union of GPU types across members (summary columns)."""
        out = set()
        for m in self.members:
            out.update(m.gpu_types())
        return sorted(out)

    def index_of(self, name: str) -> int:
        for i, m in enumerate(self.members):
            if m.name == name:
                return i
        raise KeyError(name)


def make_member(name: str, *,
                gpu_pools: Sequence[Tuple[int, int]] = ((0, 128),),
                gpus_per_node: int = 8,
                nodes_per_leaf: int = 8,
                region: str = "default",
                policy: QueuePolicy = QueuePolicy.BACKFILL,
                strategy: Strategy = Strategy.E_BINPACK,
                quota: Optional[Dict[str, Dict[int, int]]] = None,
                tenants: Sequence[str] = ("t0",),
                quota_mode: QuotaMode = QuotaMode.ISOLATED,
                inference_zone_nodes: int = 0,
                sim_config: Optional[SimConfig] = None,
                cost_per_gpu_hour: Optional[Dict[int, float]] = None,
                capability: Optional[Dict[int, float]] = None,
                device: Optional[str] = None,
                score_backend: str = "kernel") -> MemberCluster:
    """Assemble one member from scenario-level knobs.

    ``gpu_pools`` is an ordered ``(gpu_type, n_nodes)`` list: the member
    hosts contiguous node blocks per GPU-type pool (§3.4.1), so two
    members can expose entirely different pool mixes to the federation.
    ``quota`` defaults to an effectively unlimited grant for every
    hosted type × every name in ``tenants`` (the federation layer is
    then the only admission gate); pass an explicit ``quota`` for
    member-level isolation experiments.

    ``device`` and ``score_backend`` go to the member's
    :class:`~repro_torch.core.rsch.RSCHConfig`: ``device=None`` runs the
    filter+score pass on CUDA (and raises without a card), ``"cpu"`` on
    the host; ``score_backend="np"`` is the host numpy A/B path.  The
    reference's ``make_member`` has neither keyword.
    """
    n_nodes = sum(n for _, n in gpu_pools)
    topo = ClusterTopology(
        n_nodes=n_nodes, gpus_per_node=gpus_per_node,
        nodes_per_leaf=nodes_per_leaf, leaves_per_spine=4,
        spines_per_superspine=4, nodes_per_hbd=nodes_per_leaf,
        nvlink_island=gpus_per_node, numa_split=max(1, gpus_per_node // 2))
    gpu_type = np.concatenate([
        np.full(n, t, dtype=np.int32) for t, n in gpu_pools])
    state = ClusterState.create(topo, gpu_type=gpu_type,
                                inference_zone_nodes=inference_zone_nodes)
    if quota is None:
        quota = {str(tn): {int(t): 10 ** 6 for t, _ in gpu_pools}
                 for tn in tenants}
    qm = QuotaManager(quota, mode=quota_mode)
    rsch = RSCH(topo, RSCHConfig(train_strategy=strategy, device=device,
                                 score_backend=score_backend))
    qsch = QSCH(qm, rsch, QSCHConfig(policy=policy))
    return MemberCluster(
        name=name, topology=topo, state=state, qsch=qsch,
        sim_config=sim_config or SimConfig(), region=region,
        cost_per_gpu_hour=dict(cost_per_gpu_hour or {}),
        capability=dict(capability or {}))
