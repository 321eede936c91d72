"""The port's checkpoint store (``repro_torch.ckpt.store``) against the
reference's ``repro.ckpt.store``: the twins of ``tests/test_ckpt_store.py``
and of ``tests/test_fault_tolerance.py::
test_disk_double_buffer_survives_torn_commit``, and the files' interchange.

A file written by either package must load in the other, bitwise: leaf
``i`` is the same array in both (dict keys sorted and ``None`` an empty
subtree, as ``jax.tree`` does, though ``torch.utils._pytree`` keeps dict
order and takes ``None`` for a leaf), the sidecar's ``treedef`` and CRC32
checksums are the reference's strings, and a ``ContextRecord`` comes back
as the loading package's own record.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

try:  # property tests degrade to deterministic variants without the dep
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - exercised on minimal containers
    HAVE_HYPOTHESIS = False

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import store as R_store  # noqa: E402
from repro.core import context as R_context  # noqa: E402
from repro.core import scheduler as R_scheduler  # noqa: E402
from repro.core import shell as R_shell  # noqa: E402
from repro.core import task as R_task  # noqa: E402
from repro_torch.ckpt import store as P_store  # noqa: E402
from repro_torch.ckpt.store import (AsyncCheckpointer,  # noqa: E402
                                    CheckpointCorruptError,
                                    DoubleBufferedCheckpointer, load_pytree,
                                    save_pytree)
from repro_torch.core import context as P_context  # noqa: E402
from repro_torch.core import scheduler as P_scheduler  # noqa: E402
from repro_torch.core import shell as P_shell  # noqa: E402
from repro_torch.core import task as P_task  # noqa: E402

STORES = {"ref": R_store, "port": P_store}
PAIRS = [(w, r) for w in STORES for r in STORES]


def _tree(rng, n_leaves=3):
    return {"a": [rng.standard_normal((4, 5)).astype(np.float32)
                  for _ in range(n_leaves)],
            "b": rng.integers(0, 100, size=(7,), dtype=np.int32)}


def _leaves(tree):
    """The leaves of a tree of either package, in the order both packages'
    files use: the port's walk keeps a reference record whole, JAX's then
    takes it apart."""
    return [y for x in P_store._flatten(tree)[0]
            for y in jax.tree.flatten(x)[0]]


def _assert_trees_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _flip_middle_byte(path):
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(blob)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_roundtrip_bit_identical(tmp_path, rng, writer, reader):
    tree = _tree(rng)
    path = str(tmp_path / "ckpt.npz")
    STORES[writer].save_pytree(path, tree, meta={"step": 3})
    loaded = STORES[reader].load_pytree(path, tree)
    _assert_trees_equal(loaded, tree)
    with open(path + ".json") as f:
        sc = json.load(f)
    assert sc["n_leaves"] == 4 and len(sc["checksums"]) == 4
    assert sc["meta"] == {"step": 3}


def test_corrupt_array_file_raises(tmp_path, rng):
    tree = _tree(rng)
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, tree)
    _flip_middle_byte(path)
    with pytest.raises(CheckpointCorruptError):
        load_pytree(path, tree)


def test_truncated_file_raises(tmp_path, rng):
    tree = _tree(rng)
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, tree)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 3])
    with pytest.raises(CheckpointCorruptError):
        load_pytree(path, tree)


def test_sidecar_leaf_count_mismatch_raises(tmp_path, rng):
    tree = _tree(rng)
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, tree)
    with open(path + ".json") as f:
        sc = json.load(f)
    sc["n_leaves"] = 99
    with open(path + ".json", "w") as f:
        json.dump(sc, f)
    with pytest.raises(CheckpointCorruptError, match="sidecar recorded 99"):
        load_pytree(path, tree)


def test_checksum_mismatch_raises_and_unverified_load_passes(tmp_path, rng):
    tree = _tree(rng)
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, tree)
    with open(path + ".json") as f:
        sc = json.load(f)
    sc["checksums"][1] = "deadbeef"
    with open(path + ".json", "w") as f:
        json.dump(sc, f)
    with pytest.raises(CheckpointCorruptError, match="leaf_1 checksum"):
        load_pytree(path, tree)
    # verify=False and sidecar-less (legacy) loads still work structurally
    loaded = load_pytree(path, tree, verify=False)
    _assert_trees_equal(loaded, tree)
    os.remove(path + ".json")
    _assert_trees_equal(load_pytree(path, tree), tree)


def test_like_structure_mismatch_still_valueerror(tmp_path, rng):
    tree = _tree(rng)
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, tree)
    with pytest.raises(ValueError, match="expected 2"):
        load_pytree(path, {"a": [tree["a"][0]], "b": tree["b"]})


def test_double_buffer_falls_back_to_older_valid_commit(tmp_path, rng):
    db = DoubleBufferedCheckpointer(str(tmp_path / "db"))
    t1 = _tree(rng)
    t2 = _tree(rng)
    p1 = db.save(t1, meta={"step": 1})
    p2 = db.save(t2, meta={"step": 2})
    assert p1 != p2
    got, meta = db.restore(t1)
    _assert_trees_equal(got, t2)
    assert meta == {"step": 2}
    # corrupt the newest buffer: restore must fall back to the older one
    _flip_middle_byte(p2)
    got, meta = db.restore(t1)
    _assert_trees_equal(got, t1)
    assert meta == {"step": 1}
    # both corrupt -> no valid commit, not an exception
    _flip_middle_byte(p1)
    assert db.restore(t1) == (None, None)


def _property_case(tmp_path, rng, n, tag):
    tree = {"x": [rng.standard_normal((n, 3)).astype(np.float32)
                  for _ in range(n)],
            "i": rng.integers(-5, 5, size=(n,), dtype=np.int32)}
    path = str(tmp_path / f"p{tag}.npz")
    save_pytree(path, tree)
    _assert_trees_equal(load_pytree(path, tree), tree)
    # and the reference reads the port's file
    _assert_trees_equal(R_store.load_pytree(path, tree), tree)


if HAVE_HYPOTHESIS:

    @settings(max_examples=25, deadline=None,
              suppress_health_check=[HealthCheck.function_scoped_fixture])
    @given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 6))
    def test_roundtrip_property(tmp_path, seed, n):
        _property_case(tmp_path, np.random.default_rng(seed), n, seed)

else:  # deterministic fallback

    def test_roundtrip_property(tmp_path, rng):
        for n in (1, 4):
            _property_case(tmp_path, rng, n, n)


def test_disk_double_buffer_survives_torn_commit(tmp_path):
    """Twin of the reference's fault-tolerance case, with tensor leaves:
    tearing the newest commit's sidecar leaves the older commit valid."""
    db = DoubleBufferedCheckpointer(str(tmp_path / "ck"))
    tree = {"w": torch.arange(8.0), "step": torch.tensor(1, dtype=torch.int32)}
    db.save(tree, meta={"step": 1})
    tree2 = {"w": torch.arange(8.0) * 2,
             "step": torch.tensor(2, dtype=torch.int32)}
    p = db.save(tree2, meta={"step": 2})
    # tear the NEWEST commit's sidecar (crash mid-save of a third commit
    # over the same slot)
    with open(p + ".json", "w") as f:
        f.write("{truncated")
    got, meta = db.restore(tree)
    assert got is not None and meta["step"] == 1  # older commit still valid
    np.testing.assert_allclose(np.asarray(got["w"]), np.arange(8.0))


# -- interchange with the reference -------------------------------------------

def _ctx_pair(seed):
    """The same context record in both packages (a mid-task commit)."""
    rng = np.random.default_rng(seed)
    fields = {f: rng.integers(0, 9, size=(P_context.N_CTX,), dtype=np.int32)
              for f in ("var", "init_var", "incr_var", "saved")}
    fields.update(valid=1, done=0, budget=3, intr=1)
    port = P_context.ContextRecord.from_fields(fields)
    ref = R_context.ContextRecord(
        **{f: jnp.asarray(v, jnp.int32) for f, v in fields.items()})
    return port, ref


def _case(name, seed=0):
    """(port tree, reference tree) holding the same values."""
    rng = np.random.default_rng(seed)
    if name == "unsorted_keys":
        a = rng.standard_normal((3, 2)).astype(np.float32)
        b = rng.integers(0, 50, size=(5,), dtype=np.int32)
        c = rng.standard_normal((2,)).astype(np.float32)
        port = {"zeta": torch.from_numpy(a.copy()), "alpha": (b, [c]),
                "mid": {"y": np.float32(2.5), "x": np.arange(3)}}
        ref = {"zeta": jnp.asarray(a), "alpha": (b, [c]),
               "mid": {"y": np.float32(2.5), "x": np.arange(3)}}
        return port, ref
    pctx, rctx = _ctx_pair(seed)
    if name == "none_payload":
        return ({"payload": None, "context": pctx},
                {"payload": None, "context": rctx})
    assert name == "context_commit"
    img = rng.standard_normal((130, 130)).astype(np.float32)
    return ({"context": pctx, "payload": (img, np.zeros_like(img))},
            {"context": rctx, "payload": (img, np.zeros_like(img))})


CASES = ("unsorted_keys", "none_payload", "context_commit")


@pytest.mark.parametrize("name", CASES)
def test_sidecar_equals_the_references(tmp_path, name):
    """The same tree written by each package: equal leaf arrays, leaf
    count, CRC32 strings and ``treedef`` text."""
    port, ref = _case(name)
    save_pytree(str(tmp_path / "p.npz"), port)
    R_store.save_pytree(str(tmp_path / "r.npz"), ref)
    sides = []
    for tag in ("p", "r"):
        with open(tmp_path / f"{tag}.npz.json") as f:
            sc = json.load(f)
        with np.load(tmp_path / f"{tag}.npz") as z:
            arrays = [z[f"leaf_{i}"] for i in range(len(z.files))]
        sides.append((sc, arrays))
    (psc, parr), (rsc, rarr) = sides
    for key in ("treedef", "n_leaves", "checksums", "meta"):
        assert psc[key] == rsc[key], key
    assert set(psc) == set(rsc)
    for a, b in zip(parr, rarr):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_files_interchange_bitwise(tmp_path, name, direction):
    port, ref = _case(name)
    path = str(tmp_path / "x.npz")
    if direction == "ref_to_port":
        R_store.save_pytree(path, ref)
        got, mod = load_pytree(path, port), P_context
    else:
        save_pytree(path, port)
        got, mod = R_store.load_pytree(path, ref), R_context
    _assert_trees_equal(got, ref)
    if name != "unsorted_keys":
        assert isinstance(got["context"], mod.ContextRecord)
    if name == "none_payload":
        assert got["payload"] is None


def test_loaded_context_scalars_are_ints(tmp_path):
    """A record that went through the store unflattens to the host record
    a resume expects: int32 arrays and Python-int scalars, equal field for
    field."""
    pctx, _ = _ctx_pair(3)
    path = str(tmp_path / "c.npz")
    save_pytree(path, {"context": pctx, "payload": None})
    got = load_pytree(path, {"context": pctx, "payload": None})
    ctx = got["context"]
    assert got["payload"] is None
    for f in ("valid", "done", "budget", "intr"):
        v = getattr(ctx, f)
        assert type(v) is int and v == getattr(pctx, f), f
    for f in ("var", "init_var", "incr_var", "saved"):
        v = getattr(ctx, f)
        assert v.dtype == np.int32 and v.shape == (P_context.N_CTX,)
        np.testing.assert_array_equal(v, getattr(pctx, f))
    np.testing.assert_array_equal(ctx.to_words(), pctx.to_words())


@pytest.mark.parametrize("node", ["namedtuple", "ordered", "default"])
def test_containers_with_another_leaf_order_are_refused(tmp_path, node):
    import collections

    x = np.arange(3)
    tree = {"namedtuple": collections.namedtuple("P", "b a")(x, x),
            "ordered": collections.OrderedDict(b=x, a=x),
            "default": collections.defaultdict(list, b=x, a=x)}[node]
    with pytest.raises(TypeError, match="not a checkpoint tree node"):
        save_pytree(str(tmp_path / "n.npz"), {"w": tree})
    assert not os.path.exists(tmp_path / "n.npz")


def test_tensor_leaves_saved_as_host_arrays(tmp_path):
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    path = str(tmp_path / "t.npz")
    save_pytree(path, {"x": x, "n": None})
    got = load_pytree(path, {"x": x, "n": None})
    assert isinstance(got["x"], np.ndarray) and got["n"] is None
    np.testing.assert_array_equal(got["x"], x.numpy())


def test_async_checkpointer_copies_before_it_queues(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path / "a" / "ck"))
    w = torch.zeros(6)
    try:
        ck.submit({"w": w, "step": 1}, meta={"step": 1})
        w.add_(5.0)  # the caller reuses its tensor at once
    finally:
        ck.drain()
    assert ck.saves == 1 and not ck._thread.is_alive()
    got, meta = ck.db.restore({"w": w, "step": 1})
    assert meta == {"step": 1}
    np.testing.assert_array_equal(got["w"], np.zeros(6, np.float32))


def _queued_scheduler(side_task, side_sched, shell):
    """A scheduler holding three queued tasks, one with a saved context
    (no loop runs: the tasks stay in the policy's queues)."""
    sched = side_sched.Scheduler(shell, side_sched.SchedulerConfig(
        policy="fcfs"))
    for i, prio in enumerate((3, 1, 4)):
        t = side_task.Task(kernel="MedianBlur", args=None, priority=prio,
                           arrival_time=0.5 * i, tenant=f"t{i % 2}", tid=i)
        if i == 2:
            t.saved_context = object()
            t.n_preemptions = 2
        sched.policy.enqueue(t)
    return sched


def test_scheduler_checkpoint_json_equals_the_references(tmp_path):
    docs = []
    for store, task, shell_mod, sched_mod, kw in (
            (P_store, P_task, P_shell, P_scheduler, {"devices": ["cpu"]}),
            (R_store, R_task, R_shell, R_scheduler, {})):
        shell = shell_mod.Shell(n_regions=1, prefetch=False, **kw)
        try:
            sched = _queued_scheduler(task, sched_mod, shell)
            path = str(tmp_path / f"{store.__name__}.json")
            store.save_scheduler_checkpoint(path, sched)
        finally:
            shell.shutdown()
        with open(path) as f:
            doc = json.load(f)
        assert not os.path.exists(path + ".tmp")
        docs.append(doc)
    port, ref = docs
    assert set(port) == set(ref) == {"queued", "policy", "finished", "t"}
    port.pop("t"), ref.pop("t")
    assert port == ref
    assert [q["has_context"] for q in port["queued"]].count(True) == 1
