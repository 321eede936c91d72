"""The port's whole blur path on the CPU: Client -> Scheduler -> Shell ->
Region -> chunk -> kernel.  Preemption points are placed deterministically
through the region's ``on_chunk`` hook (no sleeps, no timing), and every
preempted run must equal an unpreempted run of the port bitwise."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.reporting import SCHEMA  # noqa: E402
from repro.kernels.blur.ref import iterated_blur_ref  # noqa: E402
from repro_torch import Client  # noqa: E402
from repro_torch.controller.kernels import get_kernel  # noqa: E402
from repro_torch.core.interrupts import EventKind  # noqa: E402
from repro_torch.core.reporting import SCHEMA as PORT_SCHEMA  # noqa: E402
from repro_torch.core.scheduler import Scheduler, SchedulerConfig  # noqa: E402
from repro_torch.core.shell import Shell  # noqa: E402
from repro_torch.core.task import Task  # noqa: E402
from repro_torch.kernels.blur.tasks import make_image, result_image  # noqa: E402

SIZE = 30
TIMEOUT = 60


def _task(kernel, img, iters, priority=4):
    kd = get_kernel(kernel)
    return Task(kernel=kernel,
                args=kd.bundle(img.copy(), np.zeros_like(img), H=SIZE,
                               W=SIZE, iters=iters),
                priority=priority)


def _once(fn):
    """on_chunk hook that acts on the first retired chunk only."""
    fired = []

    def hook(region, task):
        if not fired:
            fired.append(region.rid)
            fn(region, task)
    return hook


def _run(img, iters, n_regions=1, hook=None, engine="pipelined"):
    client = Client(n_regions=n_regions, device="cpu", chunk_budget=1,
                    prefetch=False, engine=engine)
    try:
        if hook is not None:
            for r in client.shell.regions:
                r.on_chunk = hook
        h = client.submit(_task("MedianBlur", img, iters))
        h.result(timeout=TIMEOUT)
        return h.task, client.report()
    finally:
        client.shutdown()


@pytest.fixture(scope="module")
def img():
    return make_image(np.random.default_rng(11), SIZE)


@pytest.fixture(scope="module")
def unpreempted(img):
    t, rep = _run(img, 3)
    assert t.n_preemptions == 0 and rep["preemptions"] == 0
    want = np.asarray(iterated_blur_ref(img, 3, "median"))
    np.testing.assert_array_equal(result_image(t, 3), want)
    return t.result


@pytest.mark.parametrize("engine", ["pipelined", "sync"])
def test_same_region_resume_is_bit_identical(img, unpreempted, engine):
    t, rep = _run(img, 3, hook=_once(lambda r, t: r.request_preempt()),
                  engine=engine)
    assert t.n_preemptions == 1 and rep["preemptions"] == 1
    assert t.region_history == [0, 0]
    assert rep["host_spills_avoided"] == 1  # resumed from device memory
    for got, want in zip(t.result, unpreempted):
        np.testing.assert_array_equal(got, want)


def test_cross_region_resume_is_bit_identical(img, unpreempted):
    """Drain the region the task runs on and preempt it there: the
    scheduler resumes it on the other region from the materialized
    commit."""
    def move(region, task):
        region.begin_drain()
        region.request_preempt()

    t, rep = _run(img, 3, n_regions=2, hook=_once(move))
    assert t.n_preemptions == 1
    assert len(set(t.region_history)) == 2
    assert rep["host_spills_avoided"] == 0
    for got, want in zip(t.result, unpreempted):
        np.testing.assert_array_equal(got, want)


def test_region_level_cross_region_resume(img, unpreempted):
    """The same move driven on the regions directly: preempt on region 0
    at its first chunk boundary, resume on region 1."""
    shell = Shell(n_regions=2, devices=["cpu"], chunk_budget=1)
    try:
        r0, r1 = shell.regions
        r0.on_chunk = _once(lambda r, t: r.request_preempt())
        task = _task("MedianBlur", img, 3)
        for region, kind in ((r0, EventKind.TASK_PREEMPTED),
                             (r1, EventKind.TASK_DONE)):
            region.enqueue_reconfig(task)
            region.enqueue_launch(task)
            while True:
                ev = shell.interrupts.wait(TIMEOUT)
                assert ev is not None, "region never reported"
                if ev.kind is not EventKind.RECONFIG_DONE:
                    break
            assert ev.kind is kind and ev.region_id == region.rid
        assert task.region_history == [0, 1]
        for got, want in zip(task.result, unpreempted):
            np.testing.assert_array_equal(got, want)
    finally:
        shell.shutdown()


def test_priority_preemption_is_deterministic(img):
    """The port's twin of the reference's strictly-lower-priority test,
    without wall-clock timing: the equal- and higher-priority tasks arrive
    at the low task's first chunk boundary, and that worker waits until
    the scheduler has asked for the preemption."""
    client = Client(n_regions=1, device="cpu", chunk_budget=1,
                    prefetch=False)
    try:
        t_low = _task("MedianBlur", img, 3, priority=3)
        t_same = _task("MedianBlur", img, 1, priority=3)
        t_high = _task("MedianBlur", img, 1, priority=0)
        region = client.shell.regions[0]

        handles = []

        def arrive(r, task):
            handles.append(client.submit(t_same))
            handles.append(client.submit(t_high))
            assert r._preempt.wait(TIMEOUT), "scheduler never preempted"

        region.on_chunk = _once(arrive)
        client.submit(t_low).result(timeout=TIMEOUT)
        for h in handles:
            h.result(timeout=TIMEOUT)
        rep = client.drain(TIMEOUT)
    finally:
        client.shutdown()
    assert t_low.n_preemptions == 1
    assert t_same.n_preemptions == 0
    assert t_high.t_first_served < t_same.t_first_served
    assert rep["n_done"] == 3 and rep["preemptions"] == 1


def test_reconfig_cache_counts_and_report_schema(img):
    """Two kernels on one region: two cold bitstream generations, the
    second MedianBlur coalesced onto the warm region; every report key is
    one the reference's schema documents."""
    client = Client(n_regions=1, device="cpu", chunk_budget=4,
                    prefetch=False)
    try:
        tasks = [_task("MedianBlur", img, 1), _task("MedianBlur", img, 2),
                 _task("GaussianBlur", img, 1)]
        for t in tasks:
            client.submit(t)
        rep = client.drain(TIMEOUT)
    finally:
        client.shutdown()
    assert rep["n_done"] == 3
    assert rep["cold_compiles"] == 2
    assert rep["reconfigs"] == 2
    assert rep["prefetch_compiles"] == 0
    assert set(rep) <= set(SCHEMA["scheduler"])
    assert set(rep["reconfig"]) <= set(SCHEMA["shell_reconfig"])
    assert rep["trace"] == {"enabled": False}
    assert rep["telemetry"] == {"enabled": False}
    regions = rep["reconfig"]["regions"]
    assert regions[0]["kernel_mode"] == "torch"


def test_prefetch_warms_bitstreams(img):
    client = Client(n_regions=1, device="cpu", prefetch=True)
    try:
        for t in (_task("MedianBlur", img, 1), _task("GaussianBlur", img, 1)):
            client.submit(t)
        rep = client.drain(TIMEOUT)
    finally:
        client.shutdown()
    assert rep["n_done"] == 2
    assert rep["cold_compiles"] + rep["prefetch_compiles"] == 2
    assert rep["reconfig"]["prefetcher"]["enabled"] is True


def test_port_schema_is_the_references():
    assert PORT_SCHEMA == SCHEMA


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Shell(n_regions=1)


@pytest.mark.parametrize("kwargs,match", [
    ({"n_shells": 2}, "multi-shell"),
    ({"engine": "megakernel"}, "megakernel"),
    ({"tracer": object()}, "not ported"),
    ({"scheduler_config": SchedulerConfig(checkpoint_path="x")},
     "checkpoints"),
])
def test_later_slices_raise(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        Client(n_regions=1, device="cpu", **kwargs)


def test_elastic_pool_is_not_ported_yet():
    shell = Shell(n_regions=1, devices=["cpu"])
    try:
        with pytest.raises(NotImplementedError, match="pool"):
            Scheduler(shell, pool=object())
    finally:
        shell.shutdown()


def test_stream_is_not_ported_yet():
    with Client(n_regions=1, device="cpu") as client:
        with pytest.raises(NotImplementedError, match="token serving"):
            client.stream([1, 2, 3])
