"""Serving drivers, the port of the reference's ``serve <subcommand>``
CLI (``repro/launch/serve.py``):

    python -m repro_torch.launch.serve <lm|scheduler|cluster|decode> ...

Every subcommand runs on ``cuda:0`` unless ``--device`` names another
device (``--device cpu`` runs the plain PyTorch kernels); without CUDA and
without ``--device cpu`` it raises.  Legacy ``--mode X`` invocations are
translated to the ``X`` subcommand (with a deprecation note); bare
invocations default to ``lm``.  Each subcommand accepts only its own
flags.

LM mode: draw a model's weights and prompts from one seeded generator,
prefill the batch, then decode greedily:

    python -m repro_torch.launch.serve lm --arch rwkv6-1.6b            # cuda:0
    python -m repro_torch.launch.serve lm --arch recurrentgemma-9b --reduced \
        --device cpu

Scheduler mode: a blur-task stream through the preemptive scheduler under
``--policy fcfs|edf|wfq``, as a batch replay (the paper's harness) or, with
``--open-loop``, submitted live from a client thread; ``--autoscale`` puts
the regions under the elastic pool:

    python -m repro_torch.launch.serve scheduler --n-tasks 16 --regions 2
    python -m repro_torch.launch.serve scheduler --policy wfq --open-loop \
        --tenants 2 --arrival-rate 4 --device cpu

Cluster mode: the same bursty open-loop trace through ``--shells N``
shells behind one ``ClusterFrontend`` (router, checkpoint migration,
failover):

    python -m repro_torch.launch.serve cluster --shells 2 --n-tasks 12 \
        --burst 4 --force-migrations 2 --fail-shell 1 --seed 7

Decode mode: continuous-batching token serving through the
``ServingEngine``, every stream verified against its oracle;
``--engine megakernel`` runs each prefill and decode round as one
persistent launch on the card (the surrogate's M2/M3, ``csrc/seq_lm.cu``;
with ``--lm attention`` M4/M5, ``csrc/attn_lm.cu``):

    python -m repro_torch.launch.serve decode --sequences 64 --slots 32 \
        --round-tokens 8 --preempt-every 3 --engine megakernel

``--metrics-out`` writes the final report as JSON, ``--trace-out`` a
Chrome/Perfetto trace, ``--metrics-port``/``--metrics-stream`` live
telemetry.  All modes take ``--seed``, so task streams, arrival gaps,
payloads and prompts replay identically.
"""
from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.shell import resolve_devices
from repro_torch.models import transformer as TF
from repro_torch.models.lm import make_decode_step, make_prefill_step


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def draw(cfg: ModelConfig, *, batch: int, prompt_len: int, seed: int,
         device) -> tuple:
    """The seeded weights and inputs ``serve`` uses, from one generator on
    ``device``: the parameters, ``[batch, prompt_len]`` prompt tokens, then
    the frontend input, standard normal (``[batch, n_frontend_tokens, D]``
    patch embeddings for vision, ``[batch, encoder_seq, D]`` frames for
    audio; ``None`` without a frontend).  The same arguments give the same
    draws."""
    g = torch.Generator(device=device).manual_seed(seed)
    params = TF.init_params(cfg, generator=g, device=device)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=g, device=device)
    frontend = None
    if cfg.frontend is not None:
        n = (cfg.n_frontend_tokens if cfg.frontend == "vision"
             else cfg.encoder_seq)
        frontend = torch.randn((batch, n, cfg.d_model), generator=g,
                               device=device)
    return params, prompts, frontend


def _make_tracer(trace_out):
    """A fresh flight recorder when ``--trace-out`` asked for one, else
    ``None`` (the zero-cost-disabled default every layer checks for)."""
    if not trace_out:
        return None
    from repro_torch.obs import Tracer
    return Tracer()


def _write_trace(tracer, trace_out, quiet: bool, tag: str):
    """Export the run's events as a Chrome/Perfetto trace JSON."""
    if tracer is None or not trace_out:
        return
    from repro_torch.obs import export_chrome_trace
    export_chrome_trace(tracer, path=trace_out)
    if not quiet:
        print(f"[{tag}] trace written to {trace_out} "
              f"({len(tracer)} events, {tracer.dropped} dropped) — "
              f"open in ui.perfetto.dev")


def _write_metrics(rep: dict, metrics_out, quiet: bool, tag: str):
    """The final report as JSON (keys that are not JSON-serializable fall
    back to ``str()``)."""
    if not metrics_out:
        return
    with open(metrics_out, "w") as f:
        json.dump(rep, f, indent=2, default=str)
    if not quiet:
        print(f"[{tag}] metrics written to {metrics_out}")


class _Telemetry:
    """Live telemetry for a serve run: the registry, the sampler and its
    sinks, built only when ``--metrics-port`` and/or ``--metrics-stream``
    asked for them; otherwise every attribute stays ``None`` and the run
    pays nothing.  ``registry`` is what gets threaded into
    ``Shell(metrics=...)`` / ``ClusterFrontend(metrics=...)``."""

    def __init__(self, metrics_port=None, metrics_stream=None,
                 quiet: bool = False, tag: str = "serve",
                 interval_s: float = 0.2):
        self.registry = None
        self.monitor = None
        self.server = None
        self.writer = None
        self._quiet, self._tag = quiet, tag
        if metrics_port is None and not metrics_stream:
            return
        from repro_torch.obs import (JsonlMetricsWriter, MetricsHTTPServer,
                                     MetricsRegistry, TelemetryMonitor)
        self.registry = MetricsRegistry()
        self.monitor = TelemetryMonitor(self.registry,
                                        interval_s=interval_s)
        if metrics_port is not None:
            self.server = MetricsHTTPServer(self.registry,
                                            port=metrics_port)
            if not quiet:
                print(f"[{tag}] serving metrics at "
                      f"{self.server.url}/metrics "
                      f"(JSON at {self.server.url}/telemetry.json)")
        if metrics_stream:
            self.writer = JsonlMetricsWriter(metrics_stream)
            self.monitor.add_sink(self.writer)
            if not quiet:
                print(f"[{tag}] streaming telemetry snapshots to "
                      f"{metrics_stream}")

    def start(self, **attach_kwargs) -> "_Telemetry":
        """Attach the sampler to the run's components and start it."""
        if self.monitor is not None:
            self.monitor.attach(**attach_kwargs)
            self.monitor.start()
        return self

    def close(self):
        """Take one final sample (so short runs still land a snapshot in
        every sink), then stop the sampler and close the sinks."""
        if self.monitor is not None:
            self.monitor.sample()
            self.monitor.stop()
            if not self._quiet:
                print(f"[{self._tag}] telemetry: "
                      f"{self.registry.n_series()} series, "
                      f"{self.monitor.n_fired} alert(s) fired")
        if self.server is not None:
            self.server.close()
        if self.writer is not None:
            self.writer.close()


def _devices(device):
    """The shells' devices: ``[cuda:0]`` by default (raises without
    CUDA), else ``[device]``."""
    return resolve_devices(None if device is None else [device])


def generate(params, prompts: torch.Tensor, cfg: ModelConfig, *,
             gen: int, frontend: torch.Tensor = None, tracer=None) -> dict:
    """Prefill ``prompts`` [B, T] (query chunks of ``min(64, T)``, as the
    reference's ``serve``, the encoder's too) with the ``frontend`` input,
    if any, then ``gen - 1`` greedy decode steps.  Returns ``tokens``
    (numpy int32 [B, gen]), the prefill's last-position ``logits`` [B, V],
    and the prefill and decode wall seconds (each read back to the host,
    as the reference's loop does).  A ``tracer`` gets a ``prefill`` span
    and a ``decode_step`` span a step."""
    device = prompts.device
    prefill = make_prefill_step(cfg, q_chunk=min(64, prompts.shape[1]))
    decode = make_decode_step(cfg)
    batch = {"tokens": prompts}
    if frontend is not None:
        batch["frontend"] = frontend
    _sync(device)
    t0 = time.perf_counter()
    cache, last = prefill(params, batch)
    tok = torch.argmax(last[:, :cfg.vocab_size], -1).to(torch.int32)[:, None]
    out = [tok.cpu()]
    prefill_s = time.perf_counter() - t0
    if tracer is not None:
        tracer.emit_span("prefill", ("lm", 0), t0, batch=prompts.shape[0],
                         prompt_len=prompts.shape[1])
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        tp0 = time.perf_counter()
        tok, cache = decode(params, cache, tok)
        out.append(tok.cpu())
        if tracer is not None:
            tracer.emit_span("decode_step", ("lm", 0), tp0,
                             batch=prompts.shape[0])
    decode_s = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1).numpy(), "logits": last,
            "prefill_s": prefill_s, "decode_s": decode_s}


def serve(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 32,
          gen: int = 16, seed: int = 0, device=None,
          prompts=None, frontend=None, quiet: bool = False,
          trace_out: str = None) -> np.ndarray:
    """Serve one batch: seeded weights (and prompts and frontend input,
    unless ``prompts`` [batch, prompt_len] or ``frontend`` of ``draw``'s
    shape are given), prefill, greedy decode.  Returns the tokens, numpy
    int32 [batch, gen]."""
    tracer = _make_tracer(trace_out)
    device = resolve_devices(None if device is None else [device])[0]
    params, prompts_drawn, frontend_drawn = draw(
        cfg, batch=batch, prompt_len=prompt_len, seed=seed, device=device)
    prompts = _given(prompts, prompts_drawn, "prompts", device)
    frontend = _given(frontend, frontend_drawn, "frontend", device)
    run = generate(params, prompts, cfg, gen=gen, frontend=frontend,
                   tracer=tracer)
    toks = run["tokens"]
    t_prefill, t_decode = run["prefill_s"], run["decode_s"]
    _write_trace(tracer, trace_out, quiet, "serve")
    if not quiet:
        print(f"[serve] prefill {prompt_len} tok x{batch}: {t_prefill:.2f}s; "
              f"decode {gen} tok: {t_decode:.2f}s "
              f"({batch * gen / max(t_decode, 1e-9):.1f} tok/s)")
        print(f"[serve] sample output ids: {toks[0][:12].tolist()}")
    return toks


def _given(value, drawn: torch.Tensor, what: str, device) -> torch.Tensor:
    """The caller's ``value`` on ``device`` (it must have the drawn
    input's shape), else the drawn one."""
    if value is None:
        return drawn
    if drawn is None:
        raise ValueError(f"{what} given to a model that takes none")
    value = torch.as_tensor(np.asarray(value), device=device)
    if value.shape != drawn.shape:
        raise ValueError(f"{what} {tuple(value.shape)} != "
                         f"{tuple(drawn.shape)}")
    return value


def serve_task_stream(*, n_tasks: int = 16, n_regions: int = 2,
                      size: int = 48, rate_s: float = 1.0, seed: int = 0,
                      prefetch: bool = True, policy: str = "fcfs",
                      open_loop: bool = False, arrival_rate: float = 4.0,
                      tenants: int = 1, burst: int = 1,
                      autoscale: bool = False, min_regions: int = 1,
                      max_regions: int = 3, metrics_out: str = None,
                      cache_capacity: int = None, quiet: bool = False,
                      engine: str = "pipelined",
                      trace_out: str = None,
                      metrics_port: int = None,
                      metrics_stream: str = None,
                      device=None) -> dict:
    """Serve a random blur-task stream through the preemptive scheduler on
    ``device`` (default ``cuda:0``) and return its report, including the
    asynchronous reconfiguration's statistics.

    Batch mode (default) replays pre-generated arrivals, the paper's
    harness.  ``open_loop=True`` submits the same tasks live: a client
    thread calls ``Scheduler.submit()`` against a ``run_forever()`` loop
    (``burst`` tasks back to back per Poisson gap at ``arrival_rate``
    bursts/s), then waits on every ``TaskHandle`` and drains.
    ``autoscale=True`` starts the shell at ``min_regions`` and lets the
    elastic ``RegionPool`` grow and shrink up to ``max_regions`` under
    load; ``metrics_out`` writes the final report as JSON."""
    from repro_torch.controller.kernels import get_kernel
    from repro_torch.core.pool import Autoscaler, AutoscalerConfig, RegionPool
    from repro_torch.core.scheduler import Scheduler, SchedulerConfig
    from repro_torch.core.shell import Shell
    from repro_torch.core.task import Task, generate_random_tasks
    from repro_torch.kernels.blur.tasks import make_image

    devices = _devices(device)
    rng = np.random.default_rng(seed)
    n_tenants = max(1, tenants)
    tenant_names = [f"tenant{i}" for i in range(n_tenants)]

    def arg_factory(r, k, iters=None):
        img = make_image(r, size)
        kd = get_kernel(k)
        if iters is None:
            iters = int(r.integers(1, 3))
        return kd.bundle(img, np.zeros_like(img), H=size, W=size,
                         iters=iters)

    kernels = ["MedianBlur", "GaussianBlur"]
    if open_loop:
        # every tenant gets the identical kernel mix and per-task cost, so
        # the fairness ratio reflects the scheduler's grants rather than a
        # randomly asymmetric workload
        tasks = [Task(kernel=kernels[(i // n_tenants) % len(kernels)],
                      args=arg_factory(rng, kernels[(i // n_tenants)
                                                    % len(kernels)], iters=1),
                      priority=int(rng.integers(5)),
                      tenant=tenant_names[i % n_tenants])
                 for i in range(n_tasks)]
    else:
        tasks = generate_random_tasks(
            rng, kernels, n_tasks, rate_s, arg_factory,
            tenants=tenant_names,
            deadline_slack=(1.0, 3.0) if policy == "edf" else None)
    tracer = _make_tracer(trace_out)
    tele = _Telemetry(metrics_port, metrics_stream, quiet=quiet,
                      tag="serve")
    shell_kw = dict(chunk_budget=2, prefetch=prefetch,
                    cache_capacity=cache_capacity, engine=engine,
                    tracer=tracer, metrics=tele.registry, devices=devices)
    pool = None
    if autoscale:
        shell = Shell(n_regions=min_regions, **shell_kw)
        pool = RegionPool(shell, autoscaler=Autoscaler(AutoscalerConfig(
            min_regions=min_regions, max_regions=max_regions,
            grow_queue_depth=1.5, cooldown_s=0.3, idle_grace_s=0.4)))
    else:
        shell = Shell(n_regions=n_regions, **shell_kw)
    sched = Scheduler(shell, SchedulerConfig(policy=policy), pool=pool)
    tele.start(scheduler=sched)

    if not open_loop:
        rep = sched.run(tasks, quiet=True)
    else:
        # warm both bitstreams so the fairness/turnaround numbers measure
        # scheduling, not whichever tenant pays the one-off build
        for kname in kernels:
            ex = next((t for t in tasks if t.kernel == kname), None)
            if ex is None:
                continue
            for geom in shell.geometries():
                shell.engine.prewarm(kname, ex.args, geom,
                                     program=shell.prefetcher.program)

        shell.region_slowdown_s = 0.02  # deterministic per-chunk work:
        for r in shell.regions:        # fairness and turnaround measure
            r.slowdown_s = 0.02        # scheduling, not the kernels'
            # noise; regions added later by the elastic pool inherit it

        server = threading.Thread(target=sched.run_forever,
                                  name="scheduler-loop", daemon=True)
        server.start()
        sched.wait_until_serving(timeout=10.0)  # t0 valid before deadlines
        handles = []
        burst_n = max(1, burst)
        for i, t in enumerate(tasks):
            if policy == "edf":
                t.deadline_s = sched.now() + float(rng.uniform(1.0, 3.0))
            handles.append(sched.submit(t))
            if (i + 1) % burst_n == 0:  # burst boundary: open-loop gap
                time.sleep(float(
                    rng.exponential(1.0 / max(arrival_rate, 1e-6))))
        for h in handles:
            h.wait(timeout=120.0)
        rep = sched.drain(timeout=60.0)
        server.join(timeout=10.0)
        # drain resolves every handle; anything still pending is a real
        # stranded future the scheduler-side count missed
        rep["stranded_handles"] += sum(1 for h in handles if not h.done())

    tele.close()
    shell.shutdown()
    _write_trace(tracer, trace_out, quiet, "serve")
    _write_metrics(rep, metrics_out, quiet, "serve")
    if not quiet:
        mode = "open-loop" if open_loop else "batch"
        print(f"[serve] policy={rep['policy']} ({mode}) "
              f"{rep['n_done']}/{n_tasks} tasks in "
              f"{rep['wall_s']:.2f}s ({rep['throughput_tps']:.1f} tasks/s), "
              f"{rep['preemptions']} preemptions")
        print(f"[serve] turnaround p50 {rep['turnaround_p50_s']:.2f}s / "
              f"p99 {rep['turnaround_p99_s']:.2f}s, "
              f"{rep['deadline_misses']}/{rep['deadline_tasks']} deadline "
              f"misses, fairness ratio {rep['fairness_ratio']:.2f} "
              f"({len(rep['per_tenant'])} tenants), "
              f"{rep['stranded_handles']} stranded handles")
        print(f"[serve] reconfig: {rep['reconfigs']} partial loads, "
              f"prefetch hit rate {rep['prefetch_hit_rate']:.0%}, "
              f"{rep['cold_compiles']} cold compiles "
              f"({rep['dispatch_stall_s']:.2f}s dispatch stall), "
              f"{rep['evictions']} evictions, "
              f"{rep['prefetch_stale_drops']} stale prefetches dropped")
        p = rep["pool"]
        if p.get("elastic"):
            print(f"[serve] pool: {p['n_regions']} regions "
                  f"[{p['min_regions']}..{p['max_regions']}], "
                  f"{p['grows']} grows / {p['shrinks']} shrinks, "
                  f"{p['region_seconds']:.2f} region-seconds "
                  f"({p['utilization']:.0%} utilized)")
    return rep


def serve_cluster(*, n_shells: int = 2, regions_per_shell: int = 1,
                  n_tasks: int = 12, size: int = 48, seed: int = 0,
                  router: str = "least-loaded", policy: str = "fcfs",
                  arrival_rate: float = 4.0, burst: int = 4,
                  rebalance: bool = True, force_migrations: int = 0,
                  fail_shell: int = None, fail_after: int = None,
                  prefetch: bool = True, metrics_out: str = None,
                  quiet: bool = False, engine: str = "pipelined",
                  trace_out: str = None,
                  metrics_port: int = None,
                  metrics_stream: str = None,
                  device=None) -> dict:
    """Serve a bursty open-loop blur stream through ``n_shells`` shells on
    ``device`` (default ``cuda:0``) behind one ``ClusterFrontend`` and
    return its aggregated report.

    ``force_migrations`` checkpoint-migrates that many *running* tasks off
    the busiest shell mid-trace (on top of the opportunistic rebalancer).
    ``fail_shell`` injects a whole-node failure on that shell once
    ``fail_after`` tasks have been submitted (default: half the trace); its
    outstanding tasks re-admit on the survivors from their last
    checkpoints."""
    from repro_torch.cluster import ClusterFrontend
    from repro_torch.controller.kernels import get_kernel
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.core.task import Task
    from repro_torch.kernels.blur.tasks import make_image

    devices = _devices(device)
    rng = np.random.default_rng(seed)
    kernels = ["MedianBlur", "GaussianBlur"]

    def make_task(i):
        k = kernels[i % len(kernels)]
        img = make_image(rng, size)
        kd = get_kernel(k)
        return Task(kernel=k,
                    args=kd.bundle(img, np.zeros_like(img), H=size, W=size,
                                   iters=2),
                    priority=int(rng.integers(5)))

    tasks = [make_task(i) for i in range(n_tasks)]
    tracer = _make_tracer(trace_out)
    tele = _Telemetry(metrics_port, metrics_stream, quiet=quiet,
                      tag="cluster")
    fe = ClusterFrontend(n_shells=n_shells,
                         regions_per_shell=regions_per_shell,
                         router=router, rebalance=rebalance,
                         config=SchedulerConfig(policy=policy),
                         chunk_budget=2, prefetch=prefetch, engine=engine,
                         tracer=tracer, metrics=tele.registry,
                         devices=devices)
    tele.start(cluster=fe)
    for node in fe.nodes:
        # deterministic per-chunk work (see serve_task_stream) and warm
        # bitstreams, so the trace measures the fabric, not the builds
        node.shell.region_slowdown_s = 0.02
        for r in node.shell.regions:
            r.slowdown_s = 0.02
        for kname in kernels:
            ex = next(t for t in tasks if t.kernel == kname)
            for geom in node.shell.geometries():
                node.shell.engine.prewarm(
                    kname, ex.args, geom,
                    program=node.shell.prefetcher.program)

    if fail_after is None:
        fail_after = n_tasks // 2
    burst_n = max(1, burst)
    forced_done = 0
    handles = []
    for i, t in enumerate(tasks):
        handles.append(fe.submit(t))
        if fail_shell is not None and (i + 1) == fail_after:
            if not quiet:
                print(f"[cluster] injecting failure on shell {fail_shell}")
            fe.nodes[fail_shell].inject_failure()
        if force_migrations and forced_done < force_migrations and i >= 1:
            if fe.migrate(prefer="running"):
                forced_done += 1
        if (i + 1) % burst_n == 0 and (i + 1) < n_tasks:
            time.sleep(float(rng.exponential(1.0 / max(arrival_rate, 1e-6))))
    # anything still short of the forced-migration quota: keep trying
    # while work is in flight (the stream may have outrun the bursts)
    while forced_done < force_migrations and any(not h.done()
                                                 for h in handles):
        if fe.migrate(prefer="any"):
            forced_done += 1
        else:
            time.sleep(0.01)
    for h in handles:
        h.wait(timeout=180.0)
    tele.close()
    rep = fe.shutdown()
    _write_trace(tracer, trace_out, quiet, "cluster")
    _write_metrics(rep, metrics_out, quiet, "cluster")
    if not quiet:
        print(f"[cluster] {rep['n_shells']} shells, router="
              f"{rep['router']}: {rep['n_done']}/{n_tasks} tasks in "
              f"{rep['wall_s']:.2f}s ({rep['throughput_tps']:.1f} tasks/s)")
        print(f"[cluster] turnaround p50 {rep['turnaround_p50_s']:.2f}s / "
              f"p99 {rep['turnaround_p99_s']:.2f}s; "
              f"{rep['migrations_completed']}/{rep['migrations_attempted']} "
              f"migrations, {rep['failovers']} failovers, "
              f"{rep['lost_tasks']} lost, "
              f"{rep['stranded_handles']} stranded handles")
        for nid, s in rep["per_shell"].items():
            print(f"[cluster]   shell {nid}: {s['n_done']} done, "
                  f"util {s['utilization']:.0%}, "
                  f"{s['migrated_out']} migrated out, "
                  f"healthy={s['healthy']}"
                  + (f" (crash: {s['crash']})" if s["crash"] else ""))
    return rep


def _lm_kernels(lm: str, d_model: int, vocab: int) -> tuple:
    """The region kernels the serving LM ``lm`` runs."""
    if lm == "attention":
        from repro_torch.serving.attention import (AttentionParams,
                                                   register_attention_kernels)
        return register_attention_kernels(AttentionParams(d_model=d_model,
                                                          vocab=vocab))
    return ("SeqPrefill", "SeqDecode")


def serve_decode(*, n_sequences: int = 6, prompt_len: int = 12,
                 max_new: int = 12, slots: int = 4, round_tokens: int = 4,
                 d_model: int = None, vocab: int = None,
                 lm: str = "surrogate", n_regions: int = 2,
                 disaggregate: bool = True, preempt_every: int = 0,
                 partial_s: float = 0.0, seed: int = 0, verify: bool = True,
                 metrics_out: str = None, quiet: bool = False,
                 engine: str = "pipelined", trace_out: str = None,
                 metrics_port: int = None,
                 metrics_stream: str = None,
                 device=None) -> dict:
    """Token serving on ``device`` (default ``cuda:0``): submit
    ``n_sequences`` generation requests through the continuous-batching
    ``ServingEngine`` over a preemptive scheduler, verify every streamed
    sequence against its oracle, and return the serving report.

    ``disaggregate=True`` pins decode rounds to the last region and
    prefills to the others; ``preempt_every=N`` checkpoint-preempts every
    Nth decode round mid-flight (the streams must still verify).  ``lm``
    selects the model: ``surrogate`` (the integer-hash LM at whisper-tiny's
    d_model 384 / vocab 51865) or ``attention`` (paged-KV attention over
    the flash and decode kernels; d_model 64 / vocab 101).  In megakernel
    mode on the card each prefill and decode round is one persistent
    launch: M2/M3 for the surrogate, M4/M5 for the attention LM; a kernel
    without a persistent entry raises ``NotImplementedError`` before
    anything is served."""
    from repro_torch.controller.kernels import get_kernel
    from repro_torch.core.preemption import make_megakernel
    from repro_torch.core.scheduler import Scheduler, SchedulerConfig
    from repro_torch.core.shell import Shell
    from repro_torch.serving.engine import ServingConfig, ServingEngine
    from repro_torch.serving.kernels import oracle_stream
    from repro_torch.serving.sequence import SamplingParams

    devices = _devices(device)
    if d_model is None:
        d_model = 64 if lm == "attention" else 384
    if vocab is None:
        vocab = 101 if lm == "attention" else 51865
    if engine == "megakernel":
        # the refusal of a kernel without a persistent entry, up front
        for name in _lm_kernels(lm, d_model, vocab):
            make_megakernel(get_kernel(name), devices[0])
    rng = np.random.default_rng(seed)
    # probing needs real mid-round boundaries: one token per chunk
    tracer = _make_tracer(trace_out)
    tele = _Telemetry(metrics_port, metrics_stream, quiet=quiet,
                      tag="decode")
    shell = Shell(n_regions=n_regions,
                  chunk_budget=1 if preempt_every else 2,
                  simulate_partial_s=partial_s, engine=engine,
                  tracer=tracer, metrics=tele.registry, devices=devices)
    if preempt_every and engine != "megakernel":
        # stretch chunks so the probe thread lands mid-round; megakernel
        # probes arm the one-shot flag boundary instead (no timing race,
        # and slowdown_s has no effect inside a single launch)
        for r in shell.regions:
            r.slowdown_s = 0.02
    sched = Scheduler(shell, SchedulerConfig())
    server = threading.Thread(target=sched.run_forever,
                              name="scheduler-loop", daemon=True)
    server.start()
    sched.wait_until_serving(timeout=10.0)

    rids = [r.rid for r in shell.regions]
    if disaggregate and len(rids) > 1:
        prefill_pin, decode_pin = rids[:-1], rids[-1:]
    else:
        prefill_pin = decode_pin = None
    cfg = ServingConfig(d_model=d_model, vocab_size=vocab, max_slots=slots,
                        round_tokens=round_tokens, lm=lm,
                        prefill_regions=prefill_pin,
                        decode_regions=decode_pin,
                        preempt_probe_every=preempt_every)
    serving = ServingEngine(sched, cfg).start()
    tele.start(scheduler=sched, serving=serving)

    if lm == "attention":
        from repro_torch.serving.attention import (AttentionParams,
                                                   attention_oracle_stream)
        ap = AttentionParams(d_model=d_model, vocab=vocab)
    specs, handles = [], []
    for i in range(n_sequences):
        plen = int(rng.integers(2, prompt_len + 1))
        prompt = [int(x) for x in rng.integers(0, vocab, size=plen)]
        mx = int(rng.integers(2, max_new + 1))
        if lm == "attention":
            # KV capacity bound: prompt + max_new - 1 positions <= max_ctx
            plen = min(plen, ap.max_ctx - 1)
            prompt = prompt[:plen]
            mx = min(mx, ap.max_ctx - plen + 1)
        specs.append((prompt, i, mx))
        handles.append(serving.submit(
            prompt, SamplingParams(max_new_tokens=mx, seed=i)))

    # every stream first, then the oracles: the replays launch the chunk
    # path's kernels, and none of them overlaps the serving
    streams = [h.result(timeout=300.0) for h in handles]
    mismatches = 0
    for h, got, (prompt, sd, mx) in zip(handles, streams, specs):
        if verify:
            if lm == "attention":
                # replayed with the serving LM's weights, on its device
                ref = attention_oracle_stream(
                    prompt, mx, ap, max_slots=slots,
                    round_tokens=round_tokens,
                    prefill_batch=cfg.prefill_batch,
                    weights=serving.lm.weights)
            else:
                ref = oracle_stream(prompt, sd, mx, d_model, vocab)
            if got != ref:
                mismatches += 1
                print(f"[decode] sequence #{h.sid} MISMATCH: "
                      f"{got[:6]}... != {ref[:6]}...")
    tele.close()
    rep = serving.drain(timeout=60.0)
    sched.drain(timeout=60.0)
    shell.shutdown()
    _write_trace(tracer, trace_out, quiet, "decode")
    _write_metrics(rep, metrics_out, quiet, "decode")
    if not quiet:
        mode = "disaggregated" if disaggregate else "shared"
        print(f"[decode] {rep['n_finished']}/{n_sequences} sequences "
              f"({rep['lm']}, {mode}, {slots} slots x {round_tokens} "
              f"tok rounds): {rep['tokens_out']} tokens at "
              f"{rep['tokens_per_s']:.1f} "
              f"tok/s, ttft p50 {rep['ttft_p50_s']*1000:.0f}ms / "
              f"p99 {rep['ttft_p99_s']*1000:.0f}ms")
        print(f"[decode] {rep['prefill_tasks']} prefills, "
              f"{rep['decode_rounds']} decode rounds "
              f"({rep['state_device_rounds']} device-resident), "
              f"{rep['decode_preemptions']} mid-decode preemptions, "
              f"{rep['decode_migrations']} migrations, "
              f"{rep['stranded_sequences']} stranded")
        if rep.get("kv"):
            kv = rep["kv"]
            print(f"[decode] kv pool: {kv['blocks_peak']}/"
                  f"{kv['blocks_total']} blocks peak "
                  f"({kv['block_size']} tok/block), "
                  f"{kv['evictions']} evictions, {kv['reuse']} reused, "
                  f"{kv['alloc_deferred']} admissions deferred")
    if verify and mismatches:
        raise SystemExit(
            f"[decode] {mismatches} sequence(s) diverged from the oracle")
    if rep["stranded_sequences"] or rep["n_finished"] != n_sequences:
        raise SystemExit(
            f"[decode] incomplete serve: {rep['n_finished']}/{n_sequences} "
            f"finished, {rep['stranded_sequences']} stranded")
    return rep


_SUBCOMMANDS = ("lm", "scheduler", "cluster", "decode")


def _translate_legacy(argv):
    """Map pre-subcommand invocations (``--mode X ...`` or bare flags)
    onto the ``X`` subcommand, so existing scripts keep working."""
    if argv and argv[0] in _SUBCOMMANDS:
        return argv
    if argv and argv[0] in ("-h", "--help"):
        return argv
    mode = None
    out = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--mode" and i + 1 < len(argv):
            mode = argv[i + 1]
            i += 2
            continue
        if a.startswith("--mode="):
            mode = a.split("=", 1)[1]
            i += 1
            continue
        out.append(a)
        i += 1
    mode = mode or "lm"
    print(f"[serve] note: flat '--mode {mode}' flags are deprecated; "
          f"use 'serve {mode} ...'")
    return [mode] + out


def build_parser() -> argparse.ArgumentParser:
    """The ``serve`` parser: the reference's subcommands and flags, and the
    port's ``--device`` on each."""
    # flags shared by every subcommand
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--seed", type=int, default=0,
                        help="RNG seed for task streams, arrival gaps and "
                             "payloads (reproducible smokes/benchmarks)")
    common.add_argument("--metrics-out", default=None,
                        help="write the final versioned report JSON here")
    common.add_argument("--trace-out", default=None,
                        help="record a flight-recorder timeline and write "
                             "it here as Chrome/Perfetto trace JSON "
                             "(open in ui.perfetto.dev)")
    common.add_argument("--quiet", action="store_true")
    common.add_argument("--device", default=None,
                        help="torch device (default cuda:0; 'cpu' runs the "
                             "plain PyTorch kernels)")
    # live telemetry, for the scheduling subcommands
    tele_common = argparse.ArgumentParser(add_help=False)
    tele_common.add_argument(
        "--metrics-port", type=int, default=None,
        help="serve live Prometheus text at "
             "http://127.0.0.1:PORT/metrics (0 = ephemeral port; JSON "
             "snapshots at /telemetry.json; tools/top.py renders either)")
    tele_common.add_argument(
        "--metrics-stream", default=None,
        help="append one JSON telemetry snapshot per sampler tick to "
             "this file (JSONL; tools/top.py --stream tails it)")
    engine_kw = dict(choices=("sync", "pipelined", "megakernel"),
                     default="pipelined")
    stream_common = argparse.ArgumentParser(add_help=False)
    stream_common.add_argument("--n-tasks", type=int, default=16)
    stream_common.add_argument("--regions", type=int, default=2)
    stream_common.add_argument("--policy", choices=("fcfs", "edf", "wfq"),
                               default="fcfs")
    stream_common.add_argument("--arrival-rate", type=float, default=4.0,
                               help="open-loop Poisson arrival rate (tasks/s)")
    stream_common.add_argument("--burst", type=int, default=1,
                               help="submit N tasks back-to-back per "
                                    "arrival gap (bursty trace)")
    stream_common.add_argument("--no-prefetch", action="store_true")
    stream_common.add_argument(
        "--engine", **engine_kw,
        help="region execution engine: per-chunk sync, chunk-pipelined "
             "dispatch, or one persistent launch a task (megakernel)")

    ap = argparse.ArgumentParser(prog="serve")
    sub = ap.add_subparsers(dest="cmd", required=True)

    lm = sub.add_parser("lm", parents=[common],
                        help="LM prefill + greedy decode timing")
    lm.add_argument("--arch", default="qwen3-8b")
    lm.add_argument("--reduced", action="store_true")
    lm.add_argument("--batch", type=int, default=4)
    lm.add_argument("--prompt-len", type=int, default=32)
    lm.add_argument("--gen", type=int, default=16)

    sc = sub.add_parser("scheduler",
                        parents=[common, stream_common, tele_common],
                        help="preemptive single-shell task-stream server")
    sc.add_argument("--open-loop", action="store_true",
                    help="submit tasks live via Scheduler.submit() instead "
                         "of replaying a pre-generated batch")
    sc.add_argument("--tenants", type=int, default=1,
                    help="assign tasks round-robin to N tenants")
    sc.add_argument("--autoscale", action="store_true",
                    help="elastic region pool: start at --min-regions and "
                         "autoscale up to --max-regions under load")
    sc.add_argument("--min-regions", type=int, default=1)
    sc.add_argument("--max-regions", type=int, default=3)
    sc.add_argument("--cache-capacity", type=int, default=None)

    cl = sub.add_parser("cluster",
                        parents=[common, stream_common, tele_common],
                        help="multi-shell fabric (router, migration, "
                             "failover)")
    cl.add_argument("--shells", type=int, default=2,
                    help="number of shell nodes")
    cl.add_argument("--router", choices=("least-loaded",
                                         "bitstream-affinity",
                                         "power-aware", "phase-affinity"),
                    default="least-loaded")
    cl.add_argument("--no-rebalance", action="store_true",
                    help="disable the automatic load rebalancer")
    cl.add_argument("--force-migrations", type=int, default=0,
                    help="checkpoint-migrate this many running tasks off "
                         "the busiest shell mid-trace")
    cl.add_argument("--fail-shell", type=int, default=None,
                    help="inject a whole-node failure on this shell "
                         "mid-trace (failover exercise)")
    cl.add_argument("--fail-after", type=int, default=None,
                    help="submit count after which --fail-shell fires "
                         "(default: half the trace)")

    dc = sub.add_parser("decode", parents=[common, tele_common],
                        help="continuous-batching token serving")
    dc.add_argument("--sequences", type=int, default=6)
    dc.add_argument("--prompt-len", type=int, default=12,
                    help="max prompt length (lengths drawn uniformly)")
    dc.add_argument("--max-new", type=int, default=12,
                    help="max generated tokens per sequence")
    dc.add_argument("--slots", type=int, default=4,
                    help="decode slots per round (continuous batch width)")
    dc.add_argument("--round-tokens", type=int, default=4,
                    help="tokens per decode round (admission granularity)")
    dc.add_argument("--lm", choices=("surrogate", "attention"),
                    default="surrogate",
                    help="model backend: integer-hash surrogate or paged-KV "
                         "attention decode")
    dc.add_argument("--d-model", type=int, default=None,
                    help="LM state width (default: 384 surrogate / "
                         "64 attention)")
    dc.add_argument("--vocab", type=int, default=None,
                    help="vocabulary size (default: 51865 surrogate / "
                         "101 attention)")
    dc.add_argument("--regions", type=int, default=2)
    dc.add_argument("--no-disaggregate", action="store_true",
                    help="share all regions between prefill and decode "
                         "instead of pinning decode to a dedicated region")
    dc.add_argument("--preempt-every", type=int, default=0,
                    help="checkpoint-preempt every Nth decode round "
                         "mid-flight (streams must stay bit-identical)")
    dc.add_argument("--partial-s", type=float, default=0.0,
                    help="simulated partial-reconfiguration latency")
    dc.add_argument("--no-verify", action="store_true",
                    help="skip the per-sequence oracle bit-identity check")
    dc.add_argument("--engine", **engine_kw,
                    help="region execution engine for serving rounds")
    return ap


def main(argv=None):
    import sys

    argv = _translate_legacy(sys.argv[1:] if argv is None else list(argv))
    args = build_parser().parse_args(argv)
    if args.cmd == "cluster":
        return serve_cluster(
            n_shells=args.shells,
            regions_per_shell=args.regions // args.shells or 1,
            n_tasks=args.n_tasks, seed=args.seed, router=args.router,
            policy=args.policy, arrival_rate=args.arrival_rate,
            burst=args.burst, rebalance=not args.no_rebalance,
            force_migrations=args.force_migrations,
            fail_shell=args.fail_shell, fail_after=args.fail_after,
            prefetch=not args.no_prefetch, metrics_out=args.metrics_out,
            quiet=args.quiet, engine=args.engine, trace_out=args.trace_out,
            metrics_port=args.metrics_port,
            metrics_stream=args.metrics_stream, device=args.device)
    if args.cmd == "scheduler":
        return serve_task_stream(
            n_tasks=args.n_tasks, n_regions=args.regions, seed=args.seed,
            prefetch=not args.no_prefetch, policy=args.policy,
            open_loop=args.open_loop, arrival_rate=args.arrival_rate,
            tenants=args.tenants, burst=args.burst,
            autoscale=args.autoscale, min_regions=args.min_regions,
            max_regions=args.max_regions, metrics_out=args.metrics_out,
            cache_capacity=args.cache_capacity, quiet=args.quiet,
            engine=args.engine, trace_out=args.trace_out,
            metrics_port=args.metrics_port,
            metrics_stream=args.metrics_stream, device=args.device)
    if args.cmd == "decode":
        return serve_decode(
            n_sequences=args.sequences, prompt_len=args.prompt_len,
            max_new=args.max_new, slots=args.slots,
            round_tokens=args.round_tokens, d_model=args.d_model,
            vocab=args.vocab, lm=args.lm, n_regions=args.regions,
            disaggregate=not args.no_disaggregate,
            preempt_every=args.preempt_every, partial_s=args.partial_s,
            seed=args.seed, verify=not args.no_verify,
            metrics_out=args.metrics_out, quiet=args.quiet,
            engine=args.engine, trace_out=args.trace_out,
            metrics_port=args.metrics_port,
            metrics_stream=args.metrics_stream, device=args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                 gen=args.gen, seed=args.seed, device=args.device,
                 quiet=args.quiet, trace_out=args.trace_out)


if __name__ == "__main__":
    main()
