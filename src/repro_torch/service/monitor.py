"""Fleet health for the sweep runner: the glue that turns the runtime
scaffolding (``runtime/heartbeat.py``, ``runtime/straggler.py``) from
tested-in-isolation modules into live inputs of the CGRA sweep path.

One ``FleetMonitor`` watches the logical workers of a campaign (mesh
devices when sharded, in-process workers otherwise): the runner beats
the bus for every node that participates in a unit, feeds per-unit wall
times to the straggler policy, and asks ``confirmed_failed()`` before
each unit -- a confirmed failure triggers the elastic re-plan + resume
path in ``runner.py``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Set

from ..runtime import (FailureDetector, HeartbeatBus, StragglerDetector,
                       StragglerPolicy)


class FleetMonitor:
    """Heartbeat failure detection + straggler policy over one node set."""

    def __init__(self, nodes: Sequence[str], *,
                 clock: Callable[[], float] = time.monotonic,
                 timeout: float = 10.0, suspect_factor: float = 0.5,
                 policy: Optional[StragglerPolicy] = None):
        self.bus = HeartbeatBus(clock=clock)
        self.detector = FailureDetector(self.bus, list(nodes),
                                        timeout=timeout,
                                        suspect_factor=suspect_factor)
        self.straggler = StragglerDetector(list(nodes), policy)

    @property
    def nodes(self) -> List[str]:
        """Nodes still in the fleet (evicted ones removed)."""
        return list(self.detector.nodes)

    def beat(self, node: str):
        self.bus.beat(node)

    def observe_unit(self, node: str, seconds: float) -> Dict[str, str]:
        """Feed one unit's wall time; returns straggler actions
        ({node: "rebalance" | "replace"})."""
        return self.straggler.step({node: seconds})

    def confirmed_failed(self) -> Set[str]:
        return self.detector.failed()

    def evict(self, node: str):
        """Remove a confirmed-failed (or persistently straggling) node
        from both watch lists so it stops re-triggering."""
        self.detector.remove(node)
        self.straggler.remove(node)
