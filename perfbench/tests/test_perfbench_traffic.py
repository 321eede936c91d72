"""The traffic generator: deterministic per seed, and the same work in
another order for another seed."""
from __future__ import annotations

import itertools
import json
from collections import Counter

import numpy as np
import pytest

from perfbench.harness import spec, traffic

MIXES = sorted(p.stem for p in (spec.BENCH_DIR / "traffic").glob("*.json"))


def _take(streams, n=64):
    return [list(itertools.islice(s.deck, n)) for s in streams]


def _build(mix, seed):
    with open(spec.BENCH_DIR / "traffic" / f"{mix}.json") as f:
        data = json.load(f)
    return traffic.build(data, seed)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    seed = 2 ** 31 + 7
    assert _take(_build(name, seed)) == _take(_build(name, seed))
    assert _take(_build(name, seed)) != _take(_build(name, seed + 1))


def _work(req):
    return (req.kernel, req.iters, req.priority, req.px)


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_same_work(name):
    a, b = (_build(name, s) for s in (3, 2 ** 32 + 5))
    for sa, sb in zip(a, b):
        block = (len(sa.spec["kernels"]) * len(sa.spec["priorities"])
                 * len(sa.spec["frame_px"]))
        wa = Counter(_work(r) for r in itertools.islice(sa.deck, 4 * block))
        wb = Counter(_work(r) for r in itertools.islice(sb.deck, 4 * block))
        assert wa == wb


def test_frames_are_seeded_with_a_zero_ring():
    a = traffic.frames(5, 2, 200)
    b = traffic.frames(5, 2, 200)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], a[1])
    f = a[0]
    assert f.shape == (258, 258) and f.dtype == np.float32
    assert not f[0].any() and not f[-1].any() and not f[:, 0].any()
    assert not f[:, -1].any()
    # the image fills its px x px corner of the interior, zero beyond
    assert (f[1:201, 1:201] > 0).mean() > 0.99
    assert not f[201:].any() and not f[:, 201:].any()


@pytest.mark.parametrize("px,buf", [(60, 128), (128, 128), (200, 256),
                                    (400, 512), (600, 640)])
def test_buffer_rounds_up_to_the_programs_tile(px, buf):
    assert traffic.buffer_px(px) == buf


def test_frame_pools_cover_every_size_sent():
    streams = _build("blur-bg4-batch", 9)
    pools = traffic.frame_pools(9, streams)
    assert sorted(pools) == [200, 400, 600]
    assert all(len(p) == 8 for p in pools.values())
    assert pools[600][0].shape == (642, 642)
