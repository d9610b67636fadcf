"""Federation subsystem: a global scheduler over heterogeneous members.

The paper deploys Kant in *multiple* AI data-center clusters; this
package adds the layer that decides which cluster a job lands in:

* :mod:`member`    — :class:`MemberCluster` (a full per-cluster
  scheduling stack + routing traits) and :class:`FederatedCluster`;
* :mod:`summary`   — the per-cluster summary matrix routing is
  vectorized over (O(members) per decision, never a node-array walk);
* :mod:`plugins`   — built-in **ClusterSelect** routing policies:
  quota-fit, least-loaded, GFR-aware, data-locality, capability/cost;
* :mod:`gsch`      — the GSCH: routing, spillover re-routing with
  forwarding delay + locality penalty, federation-level tenant quotas;
* :mod:`simulator` — :class:`FederatedSimulator`, driving the member
  event buses in one lockstep loop (single-member degenerate case is
  byte-identical to a plain :class:`~repro_torch.core.simulator.Simulator`);
* :mod:`metrics`   — federated GAR/SOR/GFR/JWTD aggregation, P90
  waits, and the cross-cluster balance index.

See ``docs/federation.md`` for the architecture and the ClusterSelect
contract.
"""

from .gsch import GSCH, GSCHConfig, RouteRecord, RoutingStats, \
    default_select
from .member import FederatedCluster, MemberCluster, make_member
from .metrics import (FederatedMetrics, allocated_gar, jain_index,
                      waiting_percentile)
from .plugins import (CapabilityCostSelect, GfrAwareSelect,
                      LeastLoadedSelect, LocalityAffinitySelect,
                      QuotaFitSelect)
from .simulator import FederatedResult, FederatedSimulator
from .summary import FederationSummary, summarize

__all__ = [
    "MemberCluster", "FederatedCluster", "make_member",
    "FederationSummary", "summarize",
    "GSCH", "GSCHConfig", "RouteRecord", "RoutingStats", "default_select",
    "QuotaFitSelect", "LeastLoadedSelect", "GfrAwareSelect",
    "LocalityAffinitySelect", "CapabilityCostSelect",
    "FederatedSimulator", "FederatedResult",
    "FederatedMetrics", "allocated_gar", "jain_index",
    "waiting_percentile",
]
