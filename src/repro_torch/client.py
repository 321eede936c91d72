"""``repro_torch.Client`` — the front door of the port.

    with repro_torch.Client(n_regions=2) as client:      # cuda:0
        h = client.launch("MedianBlur", (img, out), H=128, W=128, iters=2)
        ping, pong = h.result(timeout=60)

        s = client.stream([5, 9, 2], max_new_tokens=8)    # token serving
        print(list(s))                                    # iterate tokens

    repro_torch.Client(n_regions=2, device="cpu")        # plain kernels
    repro_torch.Client(serving={"lm": "attention"})      # paged-KV LM
    repro_torch.Client(backend=Scheduler(shell, pool=RegionPool(shell)))
    repro_torch.Client(n_shells=2)                       # cluster fabric
    repro_torch.Client(backend=ClusterFrontend(...))     # ... adopted
    repro_torch.Client(tracer=Tracer(), metrics=MetricsRegistry())

``submit(task) -> handle``, ``launch(kernel, hittiles, ...)`` and
``stream(prompt) -> SequenceHandle`` bind uniformly: the handle API is the
same whether the work lands on one shell's scheduler (with or without an
elastic pool) or on a cluster frontend (``repro_torch.cluster``) — the
Client hides which.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence as Seq

from repro_torch.controller.hittile import HitTile
from repro_torch.controller.kernels import get_kernel
from repro_torch.core.scheduler import Scheduler, SchedulerConfig
from repro_torch.core.shell import Shell
from repro_torch.core.task import Task


class Client:
    """Submission facade over Shell / Scheduler / cluster.

    Exactly one backend is bound per Client:

    - ``backend=None`` (default): builds, on ``device`` (``None`` =
      ``cuda:0``; raises without CUDA), ``Shell(n_regions, ...)`` and a
      ``Scheduler`` whose ``run_forever`` loop runs on a thread of its
      own (``n_shells=1``), or a ``ClusterFrontend`` of ``n_shells``
      shells of ``n_regions`` regions each; the Client owns them.
    - ``backend=Shell``: wraps it in a ``Scheduler`` (the Client owns the
      loop, not the shell).
    - ``backend=Scheduler``: adopts it (a pool-backed one included); if
      its loop is not serving, the Client starts (and owns) a
      ``run_forever`` thread.
    - ``backend=ClusterFrontend`` (anything with ``submit`` +
      ``shutdown``): adopts it as-is.

    ``serving`` (a ``ServingConfig``, or a kwargs dict for one — e.g.
    ``serving={"lm": "attention"}`` to stream from the paged-KV attention
    backend) configures the lazily-created token-serving engine behind
    ``stream()``; its LM lives on the (first node's) shell's device.

    ``tracer=`` and ``metrics=`` (``repro_torch.obs``) pass through
    ``shell_kwargs`` to the ``Shell`` (or the frontend, which hands them to
    every node's shell); the scheduler, frontend and serving engine adopt
    them from there."""

    def __init__(self, backend=None, *, n_regions: int = 2,
                 n_shells: int = 1,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 device=None, serving=None, **shell_kwargs):
        self._own_shell = False
        self._own_cluster = False
        self._own_loop = False
        self._loop_thread: Optional[threading.Thread] = None
        self._serving_cfg = serving
        self._engine = None
        self._engine_lock = threading.Lock()
        self.shell: Optional[Shell] = None
        self.scheduler: Optional[Scheduler] = None
        self.cluster = None

        if backend is None:
            devices = None if device is None else [device]
            if n_shells > 1:
                from repro_torch.cluster.frontend import ClusterFrontend

                self.cluster = ClusterFrontend(
                    n_shells=n_shells, regions_per_shell=n_regions,
                    config=scheduler_config, devices=devices,
                    **shell_kwargs)
                self._own_cluster = True
            else:
                self.shell = Shell(n_regions=n_regions, devices=devices,
                                   **shell_kwargs)
                self._own_shell = True
                try:
                    self.scheduler = Scheduler(self.shell, scheduler_config)
                except BaseException:
                    self.shell.shutdown()  # a refused config leaks no workers
                    raise
                self._start_loop()
        elif isinstance(backend, Shell):
            self.shell = backend
            self.scheduler = Scheduler(backend, scheduler_config)
            self._start_loop()
        elif isinstance(backend, Scheduler):
            self.scheduler = backend
            self.shell = backend.shell
            if not backend.serving:
                self._start_loop()
        elif hasattr(backend, "submit") and hasattr(backend, "shutdown"):
            self.cluster = backend
        else:
            raise TypeError(
                f"backend must be a Shell, Scheduler, cluster frontend, or "
                f"None; got {type(backend).__name__}")

    def _start_loop(self):
        self._own_loop = True
        self._loop_thread = threading.Thread(
            target=self.scheduler.run_forever, name="client-scheduler",
            daemon=True)
        self._loop_thread.start()
        if not self.scheduler.wait_until_serving(10.0):
            raise RuntimeError("scheduler loop failed to start")

    @property
    def backend(self):
        """Whatever ``submit`` goes to: the cluster frontend or the
        scheduler."""
        return self.cluster if self.cluster is not None else self.scheduler

    # -- task submission -------------------------------------------------
    def submit(self, task: Task):
        """Submit a prepared ``Task``; returns its future (a ``TaskHandle``
        or ``ClusterTaskHandle`` — same wait/result/cancel surface either
        way)."""
        return self.backend.submit(task)

    def launch(self, kernel: str, hittiles: Seq = (), priority: int = 4,
               tenant: str = "default", **scalars):
        """Build the ``Task`` from a registered kernel's declared argument
        names and submit it immediately."""
        kd = get_kernel(kernel)
        # HitTiles unwrap; raw arrays pass as-is (a numpy array's own
        # ``.data`` is a memoryview, so duck-typing on it is wrong)
        bufs = tuple(h.data if isinstance(h, HitTile) else h
                     for h in hittiles)
        task = Task(kernel=kernel, args=kd.bundle(*bufs, **scalars),
                    priority=priority, tenant=tenant)
        return self.submit(task)

    # -- token serving ---------------------------------------------------
    @property
    def serving(self):
        """The lazily-started ``ServingEngine`` behind ``stream()``."""
        with self._engine_lock:
            if self._engine is None:
                from repro_torch.serving.engine import (ServingConfig,
                                                        ServingEngine)

                cfg = self._serving_cfg or ServingConfig()
                if isinstance(cfg, dict):
                    cfg = ServingConfig(**cfg)
                self._engine = ServingEngine(self.backend, cfg).start()
            return self._engine

    def stream(self, prompt, params=None, tenant: str = "default",
               **param_kwargs):
        """Submit one generation sequence; returns a ``SequenceHandle``
        (iterate it for tokens as they stream, or ``result()`` for the
        full list).  ``prompt`` is a token-id sequence or a prepared
        ``Sequence``; sampling knobs come as a ``SamplingParams`` or as
        keywords (``max_new_tokens=...``, ``seed=...``)."""
        from repro_torch.serving.sequence import SamplingParams, Sequence

        if isinstance(prompt, Sequence):
            if params is not None or param_kwargs:
                raise ValueError(
                    "pass sampling params inside the Sequence, not both")
            return self.serving.submit_sequence(prompt)
        if params is None:
            params = SamplingParams(**param_kwargs)
        elif param_kwargs:
            raise ValueError("pass params= or keywords, not both")
        return self.serving.submit(prompt, params, tenant=tenant)

    # -- observability ---------------------------------------------------
    @property
    def tracer(self):
        """The flight recorder threaded through the backend (``tracer=``
        shell kwarg), or ``None`` when tracing is off."""
        return getattr(self.backend, "tracer", None)

    @property
    def metrics(self):
        """The live metrics registry threaded through the backend
        (``metrics=`` shell kwarg), or ``None`` when telemetry is off."""
        return getattr(self.backend, "metrics", None)

    @property
    def alerts(self) -> list:
        """Currently-firing alerts from the attached ``TelemetryMonitor``
        (empty when telemetry is off or no monitor is sampling)."""
        reg = self.metrics
        mon = getattr(reg, "monitor", None) if reg is not None else None
        return mon.alerts() if mon is not None else []

    def report(self) -> dict:
        """The backend's versioned report (layer ``scheduler`` or
        ``cluster``; see ``core/reporting.py``)."""
        return self.backend.report()

    def serving_report(self) -> Optional[dict]:
        """The serving engine's report (layer ``serving``), or ``None``
        if ``stream()`` was never used."""
        with self._engine_lock:
            return self._engine.report() if self._engine else None

    # -- lifecycle -------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> dict:
        """Graceful stop: finish all streamed sequences and submitted
        tasks, then stop whatever this Client owns.  Returns the final
        backend report."""
        with self._engine_lock:
            engine = self._engine
        if engine is not None:
            engine.drain(timeout)
        if self.cluster is not None:
            if self._own_cluster:
                return self.cluster.shutdown() or self.report()
            return self.cluster.drain(timeout) or self.report()
        rep = None
        if self._own_loop:
            rep = self.scheduler.drain(timeout)
        if self._own_shell:
            self.shell.shutdown()
        return rep if rep is not None else self.report()

    def shutdown(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Stop now: cancel queued work, let running tasks finish, tear
        down owned resources."""
        with self._engine_lock:
            engine = self._engine
        if engine is not None:
            engine.shutdown(timeout)
        rep = None
        if self.cluster is not None:
            if self._own_cluster:
                rep = self.cluster.shutdown()
        elif self._own_loop:
            rep = self.scheduler.shutdown(timeout)
        if self._own_shell:
            self.shell.shutdown()
        return rep

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown()
        return False
