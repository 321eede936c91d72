"""Global router: which shell gets a submitted task.

A copy of the reference's ``repro.cluster.router``, behaviour unchanged;
"DESIGN.md" section references point at the reference's note at the
repository root.  Mirrors ``core/policy.py``'s registry pattern one level
up: the node-local ``SchedulingPolicy`` decides *which queued task runs
next on a shell*; a ``RouterPolicy`` decides *which shell a task queues on
at all*.  Related work schedules tasks across FPGA fleets with exactly
this split (arXiv 2311.11015); the policies here are the three signals a
fleet actually has:

- ``least-loaded`` — queue pressure per region-second of capacity
  (``ClusterNode.load()``: outstanding tasks over dispatchable regions).
- ``bitstream-affinity`` — prefer a shell whose reconfig cache already
  holds the task's executable key (the cluster-level version of the seed
  scheduler's per-region affinity rule): routing there saves the whole
  bitstream generation.  Load-tied fallback to least-loaded, and a
  *hot-spot guard*: affinity never wins when the warm shell is more than
  ``max_load_gap`` ahead of the coldest one — a cache must not turn into
  a convoy.
- ``power-aware`` — weight each shell's load by its energy model
  (``NodePowerModel.cost_per_region_second``): heterogeneous fleets route
  to the cheapest incremental joules, not the emptiest queue.
- ``phase-affinity`` — serving disaggregation (DESIGN.md §9): tasks
  tagged with a ``Task.phase`` (prefill/decode) stick to a per-phase home
  shell, so each phase's bitstreams stay warm on their own silicon;
  phase-less work is steered off the phase homes when alternatives exist.

Every policy only ever *ranks healthy candidates the frontend hands it* —
health filtering and footprint feasibility stay in the frontend, so a
policy can never route onto a dead or too-narrow shell.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.task import Task

ROUTER_NAMES = ("least-loaded", "bitstream-affinity", "power-aware",
                "phase-affinity")


class RouterPolicy:
    """Protocol: ``choose(task, nodes) -> node`` from a non-empty sequence
    of healthy, placement-feasible candidates.  Deterministic: ties break
    toward the lowest node id so traces replay identically."""

    name = "base"

    def choose(self, task: Task, nodes: Sequence) -> object:
        raise NotImplementedError


class LeastLoaded(RouterPolicy):
    name = "least-loaded"

    def choose(self, task, nodes):
        return min(nodes, key=lambda n: (n.load(), n.node_id))


class BitstreamAffinity(RouterPolicy):
    name = "bitstream-affinity"

    def __init__(self, max_load_gap: float = 4.0):
        if max_load_gap <= 0:
            raise ValueError(
                f"max_load_gap must be > 0, got {max_load_gap}")
        self.max_load_gap = max_load_gap

    def choose(self, task, nodes):
        coldest = min(n.load() for n in nodes)
        warm = [n for n in nodes
                if n.has_bitstream(task)
                and n.load() - coldest <= self.max_load_gap]
        pool = warm or nodes
        return min(pool, key=lambda n: (n.load(), n.node_id))


class PowerAware(RouterPolicy):
    name = "power-aware"

    def choose(self, task, nodes):
        def joules(n):
            # incremental cost of putting one more task here: the shell's
            # per-region-second energy, inflated by how backlogged it is
            # (a loaded shell serves the task later AND keeps more silicon
            # powered while it waits)
            return (n.power.cost_per_region_second(n.n_dispatchable())
                    * (1.0 + n.load()))
        return min(nodes, key=lambda n: (joules(n), n.node_id))


class PhaseAffinity(RouterPolicy):
    """Serving-phase disaggregation: each distinct ``Task.phase`` gets a
    sticky *home shell* (least-loaded at first sight), so its bitstream
    kind stays permanently warm there.  The home is abandoned — and
    re-picked — only when it dies or falls ``max_load_gap`` behind the
    coldest candidate, mirroring ``BitstreamAffinity``'s convoy guard.
    Phase-less tasks avoid the homes whenever other shells exist."""

    name = "phase-affinity"

    def __init__(self, max_load_gap: float = 4.0):
        if max_load_gap <= 0:
            raise ValueError(
                f"max_load_gap must be > 0, got {max_load_gap}")
        self.max_load_gap = max_load_gap
        self._home: dict = {}  # phase -> node_id

    def choose(self, task, nodes):
        phase = getattr(task, "phase", None)
        if phase is None:
            homes = set(self._home.values())
            pool = [n for n in nodes if n.node_id not in homes] or nodes
            return min(pool, key=lambda n: (n.load(), n.node_id))
        coldest = min(n.load() for n in nodes)
        home = self._home.get(phase)
        if home is not None:
            for n in nodes:
                if (n.node_id == home
                        and n.load() - coldest <= self.max_load_gap):
                    return n
        # (re)pick a home, preferring shells not serving another phase
        others = {nid for p, nid in self._home.items() if p != phase}
        pool = [n for n in nodes if n.node_id not in others] or nodes
        pick = min(pool, key=lambda n: (n.load(), n.node_id))
        self._home[phase] = pick.node_id
        return pick


def make_router_policy(name: str,
                       max_load_gap: Optional[float] = None) -> RouterPolicy:
    """Build a router policy by registry name (mirrors ``make_policy``);
    unknown names raise ``ValueError``."""
    key = (name or "").lower()
    if key == "least-loaded":
        return LeastLoaded()
    if key == "bitstream-affinity":
        return (BitstreamAffinity() if max_load_gap is None
                else BitstreamAffinity(max_load_gap=max_load_gap))
    if key == "power-aware":
        return PowerAware()
    if key == "phase-affinity":
        return (PhaseAffinity() if max_load_gap is None
                else PhaseAffinity(max_load_gap=max_load_gap))
    raise ValueError(
        f"unknown router policy {name!r}; known: {', '.join(ROUTER_NAMES)}")
