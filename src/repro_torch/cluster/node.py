"""One cluster node: a ``Shell`` + ``Scheduler`` pair served by its own
loop thread.  The port of ``repro/cluster/node.py``, behaviour unchanged.

The paper treats a single FPGA shell as a preemptive multi-tasking server;
a node wraps exactly that server so the cluster fabric (``frontend.py``)
can run N of them behind one ``submit()`` API.  The node owns lifecycle
(``start``/``shutdown``), exposes the health signal the frontend's
heartbeat monitor polls (``healthy`` — the scheduler loop is live and at
least one region is), and carries the per-shell energy model the
power-aware router weighs.

Node death is the whole-shell analogue of the paper's region failure: every
region is killed (``inject_failure``), the scheduler loop notices the
all-dead fabric, fails its outstanding handles and exits — at which point
``healthy`` flips false and the frontend re-admits the node's tasks from
their last checkpoints on surviving shells.

On the one H100 every node's shell is a ``Shell`` on ``cuda:0`` (the
default; ``devices=`` in the node's shell keywords says otherwise, as the
CPU tests' ``devices=["cpu"]`` does), so every shell's regions are CUDA
streams that time-share the card, as the regions of one shell do.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.scheduler import Scheduler, SchedulerConfig
from repro_torch.core.shell import Shell
from repro_torch.core.submit import TaskHandle
from repro_torch.core.task import Task


@dataclass
class NodePowerModel:
    """Per-shell energy model for the power-aware router: a shell burns
    ``idle_w`` just by being up and ``active_w`` more per busy region.
    Heterogeneous fleets (an efficient small FPGA next to a large hungry
    one) are modelled by giving nodes different coefficients."""
    idle_w: float = 25.0
    active_w: float = 15.0

    def cost_per_region_second(self, n_regions: int) -> float:
        """Joules one region-second costs on this shell, with the idle
        draw amortized over its regions (the router's placement signal)."""
        return self.active_w + self.idle_w / max(1, n_regions)

    def energy_j(self, wall_s: float, busy_region_s: float) -> float:
        """Joules actually burned over a run: idle draw for the whole wall
        window plus active draw only for busy region-seconds."""
        return self.idle_w * wall_s + self.active_w * busy_region_s


class ClusterNode:
    """A shell + scheduler behind a named serving thread.

    ``outstanding`` is maintained by the owning ``ClusterFrontend`` (under
    its routing lock): the number of cluster tasks currently admitted to
    this node.  Load is therefore frontend-consistent — it never races the
    node's own event loop the way reading the policy queues would.
    """

    def __init__(self, node_id: int, *, n_regions: int = 1,
                 shell: Optional[Shell] = None,
                 config: Optional[SchedulerConfig] = None,
                 power: Optional[NodePowerModel] = None,
                 **shell_kwargs):
        self.node_id = node_id
        self.shell = shell if shell is not None else Shell(
            n_regions=n_regions, **shell_kwargs)
        self.scheduler = Scheduler(self.shell, config)
        self._trace_track = ("node", node_id)
        self.power = power or NodePowerModel()
        self.outstanding = 0         # maintained by the frontend
        self.crash: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._stopped = False

    # -- lifecycle -------------------------------------------------------
    def start(self, timeout: float = 30.0) -> "ClusterNode":
        if self._started:
            return self
        self._started = True
        self._thread = threading.Thread(
            target=self._serve, name=f"cluster-node-{self.node_id}",
            daemon=True)
        self._thread.start()
        if not self.scheduler.wait_until_serving(timeout):
            raise RuntimeError(
                f"node {self.node_id} scheduler did not start serving "
                f"within {timeout}s")
        return self

    def _serve(self):
        """Node serving thread: a scheduler crash (e.g. the whole fabric
        failed) is node death — record it for the frontend's failover
        instead of spraying a traceback from a daemon thread."""
        try:
            self.scheduler.run_forever()
        except RuntimeError as e:
            self.crash = e
            if self.tracer is not None:
                self.tracer.emit("node_crash", self._trace_track,
                                 error=str(e))

    def shutdown(self, timeout: float = 10.0) -> None:
        """Idempotent teardown: stop the scheduler loop (cancelling queued
        tasks), join the serving thread, and shut the shell's worker and
        prefetcher threads down."""
        if self._stopped:
            return
        self._stopped = True
        try:
            self.scheduler.shutdown(timeout=timeout)
        except (TimeoutError, RuntimeError):
            pass  # a crashed loop already closed itself
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self.shell.shutdown()

    # -- health ----------------------------------------------------------
    @property
    def started(self) -> bool:
        return self._started

    @property
    def healthy(self) -> bool:
        """Heartbeat: the loop serves and the fabric has a live region.
        False before ``start()`` and after any death/stop."""
        return (self._started and not self._stopped
                and self.scheduler.serving
                and any(r.alive for r in self.shell.regions))

    @property
    def tracer(self):
        """The shared flight recorder, if the shell carries one."""
        return getattr(self.shell, "tracer", None)

    @property
    def metrics(self):
        """The shared live-metrics registry, if the shell carries one."""
        return getattr(self.shell, "metrics", None)

    def inject_failure(self) -> None:
        """Kill the whole node: every region fails (the scheduler loop
        notices the dead fabric, fails outstanding handles and exits)."""
        if self.tracer is not None:
            self.tracer.emit("node_failure", self._trace_track)
        for r in self.shell.regions:
            r.inject_failure()
        self.scheduler._kick()  # wake a loop blocked in WaitForInterrupt

    # -- load / placement signals ---------------------------------------
    def n_dispatchable(self) -> int:
        return sum(1 for r in self.shell.regions if r.dispatchable)

    def load(self) -> float:
        """Queue pressure per unit of capacity: outstanding cluster tasks
        over dispatchable regions (the frontend's router sorts on this)."""
        return self.outstanding / max(1, self.n_dispatchable())

    def max_width(self) -> int:
        """Widest dispatchable region (cluster-level placement check)."""
        return max((len(r.devices) for r in self.shell.regions
                    if r.dispatchable), default=0)

    def has_bitstream(self, task: Task) -> bool:
        """True when this shell's reconfig cache already holds the task's
        executable for any current region geometry — routing here saves
        the bitstream generation entirely (the affinity router's signal)."""
        engine = self.shell.engine
        sig = task.args.signature()
        program = self.shell.prefetcher.program  # this shell's program kind
        return any(engine.cache_key(task.kernel, sig, g, program)
                   in engine.cache for g in self.shell.geometries())

    def submit(self, task: Task) -> TaskHandle:
        return self.scheduler.submit(task)

    def __repr__(self):
        return (f"ClusterNode({self.node_id}, regions="
                f"{len(self.shell.regions)}, outstanding="
                f"{self.outstanding}, healthy={self.healthy})")
