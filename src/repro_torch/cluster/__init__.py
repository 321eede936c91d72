"""Multi-shell cluster fabric, the port of ``repro.cluster``: N
``Shell``+``Scheduler`` nodes (by default every shell on ``cuda:0``) behind
one ``ClusterFrontend.submit()`` API, with a pluggable global router,
checkpoint-based cross-shell task migration, and heartbeat-driven
failover."""
from repro_torch.cluster.frontend import (ClusterError, ClusterFrontend,
                                          ClusterTaskHandle)
from repro_torch.cluster.node import ClusterNode, NodePowerModel
from repro_torch.cluster.router import (ROUTER_NAMES, BitstreamAffinity,
                                        LeastLoaded, PowerAware,
                                        RouterPolicy, make_router_policy)

__all__ = [
    "ClusterError", "ClusterFrontend", "ClusterTaskHandle", "ClusterNode",
    "NodePowerModel", "ROUTER_NAMES", "BitstreamAffinity", "LeastLoaded",
    "PowerAware", "RouterPolicy", "make_router_policy",
]
