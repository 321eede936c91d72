"""The one traffic generator: turns a mix's data file and a seed into the
requests of a run.

A mix (``perfbench/traffic/<name>.json``) is a list of ``streams``.  Each
stream has a ``kind`` (``blur``: tasks of the paper's kernel set through
``Client.launch``), its ``clients`` (closed-loop callers that each send the
next request when the last one is answered) and the sizes of its requests:
``kernels`` (name, iterations), ``priorities``, ``frame_px`` (the image
sizes) and ``frames`` (the pool of frames of each size).

Every seed gets the same work in another order: each stream draws from a
deck of blocks, each block every combination of the stream's sizes once,
shuffled.  So the mix is fixed, and the seed changes only the order and the
pixels.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List

import numpy as np

BLUR_KERNELS = {"MedianBlur": "median", "GaussianBlur": "gaussian"}
PAD_TO = 128        # a frame's buffer: the image rounded up to this, a ring


@dataclass(frozen=True)
class BlurRequest:
    kernel: str       # registered kernel name
    iters: int
    priority: int
    px: int           # the image's size (its buffer: ``buffer_px(px)``)
    frame: int        # index into the run's pool of frames of that size
    keep: bool        # drawn for the correctness check


@dataclass
class Stream:
    spec: dict
    kind: str
    deck: Iterator = field(repr=False, default=None)

    @property
    def clients(self) -> int:
        return int(self.spec.get("clients", 1))


def _rng(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, *path])


def _blocks(rng: np.random.Generator, items: list) -> Iterator:
    """Endless blocks of ``items``, each block shuffled."""
    while True:
        for i in rng.permutation(len(items)):
            yield items[int(i)]


def _blur_deck(rng, spec: dict) -> Iterator[BlurRequest]:
    combos = [(k, int(n), int(p), int(px)) for k, n in spec["kernels"]
              for p in spec["priorities"] for px in spec["frame_px"]]
    keep_rate = float(spec.get("check_share", 1.0))
    n_frames = int(spec["frames"])
    for kernel, iters, prio, px in _blocks(rng, combos):
        yield BlurRequest(kernel, iters, prio, px,
                          int(rng.integers(n_frames)),
                          bool(rng.random() < keep_rate))


def build(mix: dict, seed: int) -> List[Stream]:
    """The streams of ``mix`` for ``seed``."""
    streams = []
    for i, spec in enumerate(mix["streams"]):
        if spec["kind"] != "blur":
            raise ValueError(f"unknown stream kind {spec['kind']!r}")
        streams.append(Stream(spec, spec["kind"],
                              _blur_deck(_rng(seed, i), spec)))
    return streams


def buffer_px(px: int) -> int:
    """The side of the buffer that holds a ``px`` image: ``px`` rounded up
    to ``PAD_TO`` (the program's ``make_image`` convention), without the
    ring."""
    return -(-px // PAD_TO) * PAD_TO


def frames(seed: int, n: int, px: int) -> List[np.ndarray]:
    """``n`` padded float32 frames ``[b + 2, b + 2]``, ``b = buffer_px(px)``,
    from ``seed``: a ``px x px`` image of uniform [0, 1) pixels in the top
    left corner of the interior, zero elsewhere and on the ring."""
    rng = _rng(seed, 1 << 20, px)
    b = buffer_px(px)
    out = []
    for _ in range(n):
        f = np.zeros((b + 2, b + 2), np.float32)
        f[1:px + 1, 1:px + 1] = rng.random((px, px), dtype=np.float32)
        out.append(f)
    return out


def frame_pools(seed: int, streams: List[Stream]) -> Dict[int, list]:
    """The run's frames by image size: ``frames`` of each size any stream
    sends (the largest pool a size is given)."""
    want: Dict[int, int] = {}
    for s in streams:
        for px in s.spec["frame_px"]:
            want[int(px)] = max(want.get(int(px), 0), int(s.spec["frames"]))
    return {px: frames(seed, n, px) for px, n in sorted(want.items())}
