"""Disk checkpointing: double-buffered atomic commits + async writer.

The port of ``repro/ckpt/store.py``.  The paper's ``valid`` flag becomes
the POSIX idiom: write to a temp file, fsync, then atomically rename — a
crash mid-save leaves the previous checkpoint intact.  ``AsyncCheckpointer``
runs commits on a writer thread so the caller never blocks.

Integrity: the sidecar records the leaf count and a CRC32 per leaf, and
``load_pytree`` verifies both before handing arrays back.  Cross-shell task
migration (``repro_torch.cluster``) resumes a preempted kernel from exactly
these files — a silently corrupt checkpoint would resurface as a wrong
result on a *different* shell, far from the fault, so corruption must fail
the load loudly (``CheckpointCorruptError``) instead.
``DoubleBufferedCheckpointer`` treats a corrupt buffer like a torn sidecar:
the other buffer stays valid.

The byte format is the reference's: ``leaf_<i>`` arrays in an npz, a JSON
sidecar with ``treedef``, ``n_leaves``, ``checksums`` (CRC32, 8 hex
digits), ``meta`` and ``t``.  Leaf ``i`` is the same array in both
packages because ``_flatten`` orders and selects leaves as ``jax.tree``
does, not as ``torch.utils._pytree`` does: dict keys sorted, ``None`` an
empty subtree (not a leaf).  Nodes registered with ``torch.utils._pytree``
(``core.context.ContextRecord``) flatten through their registration, and
the sidecar's ``treedef`` is written in JAX's notation.  So a file written
by either package loads in the other.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
import zipfile
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree


class CheckpointCorruptError(ValueError):
    """The on-disk checkpoint does not match its sidecar (torn write,
    bit rot, or a truncated copy) and must not be resumed from."""


class _TreeDef:
    """The structure of a flattened tree: ``kind`` is ``"leaf"``,
    ``"none"``, ``"tuple"``, ``"list"``, ``"dict"`` (keys sorted) or
    ``"node"`` (a type registered with ``torch.utils._pytree``)."""

    def __init__(self, kind: str, children=(), keys=None, node=None,
                 context=None):
        self.kind = kind
        self.children: List["_TreeDef"] = list(children)
        self.keys = keys
        self.node = node            # (type, its pytree NodeDef) for "node"
        self.context = context

    def unflatten(self, leaves) -> Any:
        return self._build(iter(leaves))

    def _build(self, it) -> Any:
        if self.kind == "leaf":
            return next(it)
        if self.kind == "none":
            return None
        kids = [c._build(it) for c in self.children]
        if self.kind == "tuple":
            return tuple(kids)
        if self.kind == "list":
            return kids
        if self.kind == "dict":
            return dict(zip(self.keys, kids))
        return self.node[1].unflatten_fn(kids, self.context)

    def __str__(self) -> str:
        return f"PyTreeDef({self._str()})"

    def _str(self) -> str:
        kids = [c._str() for c in self.children]
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        if self.kind == "tuple":
            return f"({kids[0]},)" if len(kids) == 1 else \
                f"({', '.join(kids)})"
        if self.kind == "list":
            return f"[{', '.join(kids)}]"
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {s}"
                                   for k, s in zip(self.keys, kids)) + "}"
        return (f"CustomNode({self.node[0].__name__}[{self.context}], "
                f"[{', '.join(kids)}])")


def _flatten(tree: Any) -> Tuple[list, _TreeDef]:
    """Leaves in ``jax.tree.flatten`` order, and the tree's structure."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def _walk(x: Any, leaves: list) -> _TreeDef:
    if x is None:
        return _TreeDef("none")
    if type(x) in (tuple, list):
        return _TreeDef(type(x).__name__, [_walk(c, leaves) for c in x])
    if type(x) is dict:
        keys = sorted(x)
        return _TreeDef("dict", [_walk(x[k], leaves) for k in keys],
                        keys=keys)
    if isinstance(x, (tuple, list, dict)):
        # a namedtuple, OrderedDict or defaultdict: JAX and torch order or
        # key these differently; refuse rather than write another leaf set
        raise TypeError(f"{type(x).__name__} is not a checkpoint tree "
                        f"node; use a tuple, list or dict")
    node = pytree.SUPPORTED_NODES.get(type(x))
    if node is not None:
        kids, context = node.flatten_fn(x)
        return _TreeDef("node", [_walk(c, leaves) for c in kids],
                        node=(type(x), node), context=context)
    leaves.append(x)
    return _TreeDef("leaf")


def _host(x) -> np.ndarray:
    """A leaf as a host numpy array (``jax.device_get``'s counterpart): a
    tensor on any device, the CPU included, is copied, after its pending
    work, so the caller may overwrite it at once."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def _checksum(arr: np.ndarray) -> str:
    return f"{zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xffffffff:08x}"


def save_pytree(path: str, tree: Any, meta: Optional[dict] = None):
    """Atomic pytree save: <path>.npz (+ sidecar .json), committed by rename.

    The pair commits in two renames (arrays, then sidecar); a crash between
    them leaves a mismatched pair that ``load_pytree`` rejects by checksum,
    which the double-buffered restore treats as an invalid buffer."""
    leaves, treedef = _flatten(tree)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # the atomic 'valid flag flip'
    sidecar = {"treedef": str(treedef), "n_leaves": len(leaves),
               "checksums": [_checksum(arrays[f"leaf_{i}"])
                             for i in range(len(leaves))],
               "meta": meta or {}, "t": time.time()}
    tmp2 = path + ".json.tmp"
    with open(tmp2, "w") as f:
        json.dump(sidecar, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp2, path + ".json")


def load_pytree(path: str, like: Any, verify: bool = True) -> Any:
    """Load into the structure of ``like``; the leaves come back as numpy.

    ``verify=True`` (default) checks the arrays against the sidecar: the
    leaf count must match and every leaf's CRC32 must equal the recorded
    one; any mismatch — or an unreadable archive — raises
    ``CheckpointCorruptError``.  A checkpoint without a sidecar (pre-
    integrity files) loads with structural validation only."""
    try:
        with np.load(path) as z:
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    except (zipfile.BadZipFile, OSError, KeyError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} is unreadable: {e}") from e
    ref_leaves, treedef = _flatten(like)
    if len(leaves) != len(ref_leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, "
                         f"expected {len(ref_leaves)}")
    sidecar_path = path + ".json"
    if verify and os.path.exists(sidecar_path):
        try:
            with open(sidecar_path) as f:
                sc = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            raise CheckpointCorruptError(
                f"checkpoint sidecar {sidecar_path} is unreadable: {e}"
            ) from e
        if sc.get("n_leaves") != len(leaves):
            raise CheckpointCorruptError(
                f"checkpoint {path} has {len(leaves)} leaves but its "
                f"sidecar recorded {sc.get('n_leaves')}")
        sums = sc.get("checksums")
        if sums is not None:
            if len(sums) != len(leaves):
                raise CheckpointCorruptError(
                    f"checkpoint {path} sidecar lists {len(sums)} "
                    f"checksums for {len(leaves)} leaves")
            for i, (leaf, want) in enumerate(zip(leaves, sums)):
                got = _checksum(leaf)
                if got != want:
                    raise CheckpointCorruptError(
                        f"checkpoint {path} leaf_{i} checksum mismatch "
                        f"(got {got}, sidecar says {want})")
    return treedef.unflatten(leaves)


class DoubleBufferedCheckpointer:
    """Alternates between <base>.A and <base>.B; restore picks the newest
    valid commit (the paper's two BRAM buffers + valid flag, on disk)."""

    def __init__(self, base: str):
        self.base = base
        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
        self._turn = 0

    def _slot(self, i: int) -> str:
        return f"{self.base}.{'AB'[i]}"

    def save(self, tree: Any, meta: Optional[dict] = None) -> str:
        path = self._slot(self._turn)
        save_pytree(path, tree, meta)
        self._turn = (self._turn + 1) % 2
        return path

    def restore(self, like: Any) -> Tuple[Optional[Any], Optional[dict]]:
        slots = []
        for i in (0, 1):
            p = self._slot(i)
            if not (os.path.exists(p) and os.path.exists(p + ".json")):
                continue
            try:
                with open(p + ".json") as f:
                    sc = json.load(f)
            except (json.JSONDecodeError, OSError):
                continue  # torn sidecar: the other buffer stays valid
            slots.append((sc["t"], p, sc.get("meta")))
        # newest commit first; a corrupt newest buffer (torn arrays/sidecar
        # pair) falls back to the older one — the paper's valid-flag
        # protocol with the checksum as the validity witness
        for _, p, meta in sorted(slots, reverse=True):
            try:
                return load_pytree(p, like), meta
            except CheckpointCorruptError:
                continue
        return None, None


class AsyncCheckpointer:
    """Writer-thread wrapper: ``submit`` returns immediately; ``drain`` joins."""

    def __init__(self, base: str):
        self.db = DoubleBufferedCheckpointer(base)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self.saves = 0

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            tree, meta = item
            self.db.save(tree, meta)
            self.saves += 1

    def submit(self, tree: Any, meta: Optional[dict] = None):
        # copy to the host first, so the caller may overwrite its device
        # tensors as soon as this returns
        leaves, treedef = _flatten(tree)
        self._q.put((treedef.unflatten([_host(x) for x in leaves]), meta))

    def drain(self):
        self._q.put(None)
        self._thread.join(timeout=60)


def save_scheduler_checkpoint(path: str, scheduler):
    """Snapshot scheduler state: queued tasks + their saved contexts."""
    state = {
        "queued": [
            {"tid": t.tid, "kernel": t.kernel, "priority": t.priority,
             "tenant": t.tenant, "arrival_time": t.arrival_time,
             "n_preemptions": t.n_preemptions,
             "has_context": t.saved_context is not None}
            for t in scheduler.policy.pending_tasks()
        ],
        "policy": scheduler.policy.name,
        "finished": len(scheduler.finished),
        "t": time.time(),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)
