"""Token serving in the port against the reference, on the CPU.

- the surrogate LM's kernels and streams, bitwise;
- ``AttnPrefill``/``AttnDecode`` driven chunk by chunk in both packages:
  every ``ContextRecord`` field equal after every chunk, tokens equal, K/V
  within 2e-5 (the kernels' tolerance: the projections and attention sum
  in another order than XLA's);
- the port's ``attention_oracle_stream`` against the reference's;
- the port's engine against the port's oracle under preemptions placed
  with the region's ``on_chunk`` hook (never with sleeps), resumed on the
  same region and on another one;
- ``KVBlockPool`` accounting, ``Client.stream``, and a decode round
  preempted in the reference and finished in the port;
- the twins of ``test_serving.py::
  test_cross_shell_migration_mid_decode_bit_identical`` and
  ``test_attention_serving.py::
  test_decode_round_survives_cross_shell_migration``: a RUNNING decode
  round (surrogate, then attention at the test geometry) checkpoint-
  migrated between the two CPU shells of a ``ClusterFrontend`` at a chunk
  boundary placed with ``on_chunk``, its payload (the attention round's
  K/V pages and weights) through the checksummed spill.
"""
import functools
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.controller.kernels import get_kernel as ref_get_kernel  # noqa: E402
from repro.core import context as RC  # noqa: E402
from repro.core.context import KVBlockPool as RefPool  # noqa: E402
from repro.serving import attention as RA  # noqa: E402
from repro.serving.kernels import oracle_stream as ref_oracle_stream  # noqa: E402
from repro_torch import Client  # noqa: E402
from repro_torch.controller.kernels import get_kernel  # noqa: E402
from repro_torch.core.context import (ContextRecord, KVBlockPool,  # noqa: E402
                                      from_reference)
from repro_torch.core.preemption import run_to_completion  # noqa: E402
from repro_torch.serving import attention as A  # noqa: E402
from repro_torch.serving.kernels import (COL_ACTIVE, COL_LAST_TOK,  # noqa: E402
                                         COL_N_EMIT, oracle_stream)
from repro_torch.serving.sequence import SequenceStatus  # noqa: E402

FIELDS = ("var", "init_var", "incr_var", "saved", "valid", "done", "budget",
          "intr")
KV_TOL = 2e-5
TIMEOUT = 120
P = A.AttentionParams()
D_MODEL, VOCAB = 32, 257  # the reference's surrogate test geometry

_jit = functools.lru_cache(maxsize=None)(jax.jit)


def _ref_chunks(name, bundle, budget, ctx=None, state=None, n=None):
    """The reference's kernel chunk by chunk: [(fields, state)] per chunk,
    until done (or ``n`` chunks)."""
    bufs, ints, floats = bundle.padded()
    fn = _jit(ref_get_kernel(name).fn)
    ctx = RC.ContextRecord.fresh() if ctx is None else ctx
    state = tuple(jnp.asarray(b) for b in bufs) if state is None else state
    out = []
    while int(ctx.done) == 0 and (n is None or len(out) < n):
        ctx, state = fn(ctx.with_budget(budget), state, ints, floats)
        out.append(({f: np.asarray(getattr(ctx, f)) for f in FIELDS}, state))
        assert len(out) < 500
    return out, ctx, state


def _assert_ctx(port_ctx, ref_fields, where):
    got = port_ctx.fields()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], ref_fields[f],
                                      err_msg=f"{f} differs {where}")


def _port_state(bundle):
    bufs, ints, floats = bundle.padded()
    return tuple(torch.tensor(np.asarray(b)) for b in bufs), ints, floats


# -- surrogate LM ---------------------------------------------------------------

def _surrogate_bundles(rng, S=3, R=4):
    state = rng.integers(-2**31, 2**31, size=(S, D_MODEL),
                         dtype=np.int64).astype(np.int32)
    slots = np.zeros((S, 8), np.int32)
    slots[:, COL_ACTIVE] = 1
    slots[:, COL_N_EMIT] = [R, 2, R][:S]
    slots[:, COL_LAST_TOK] = rng.integers(0, VOCAB, size=S)
    slots[S - 1, COL_ACTIVE] = 0  # one dead slot: masking must hold
    out = np.zeros((S, R), np.int32)
    args = (out, state, slots)
    kw = dict(S=S, D=D_MODEL, R=R, vocab=VOCAB)
    return (ref_get_kernel("SeqDecode").bundle(*args, **kw),
            get_kernel("SeqDecode").bundle(*args, **kw))


@pytest.mark.parametrize("budget", [1, 2, 3, 5])
def test_surrogate_decode_matches_reference_every_chunk(budget):
    """SeqDecode in both packages: every context field after every chunk,
    and the tokens, state and slot table bitwise (int32 wrap included)."""
    ref_b, port_b = _surrogate_bundles(np.random.default_rng(budget))
    trace, _, ref_state = _ref_chunks("SeqDecode", ref_b, budget)
    state, ints, floats = _port_state(port_b)
    fn, ctx = get_kernel("SeqDecode").fn, ContextRecord.fresh()
    for n, (fields, _) in enumerate(trace):
        ctx, state = fn(ctx.with_budget(budget), state, ints, floats)
        _assert_ctx(ctx, fields, f"after chunk {n}")
    for slot in range(3):
        np.testing.assert_array_equal(state[slot].numpy(),
                                      np.asarray(ref_state[slot]))
    assert np.any(state[0].numpy()[:2] != 0)


@pytest.mark.parametrize("prompt_len,budget", [(1, 1), (5, 2), (13, 8)])
def test_surrogate_prefill_matches_reference_every_chunk(prompt_len, budget):
    from repro.serving.kernels import init_state

    rng = np.random.default_rng(prompt_len)
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :prompt_len] = rng.integers(0, VOCAB, size=prompt_len)
    args = (np.zeros((1, 8), np.int32), init_state(3, D_MODEL)[None, :],
            prompt)
    kw = dict(P=16, D=D_MODEL, vocab=VOCAB, prompt_len=prompt_len)
    trace, _, ref_state = _ref_chunks(
        "SeqPrefill", ref_get_kernel("SeqPrefill").bundle(*args, **kw),
        budget)
    state, ints, floats = _port_state(
        get_kernel("SeqPrefill").bundle(*args, **kw))
    fn, ctx = get_kernel("SeqPrefill").fn, ContextRecord.fresh()
    for n, (fields, _) in enumerate(trace):
        ctx, state = fn(ctx.with_budget(budget), state, ints, floats)
        _assert_ctx(ctx, fields, f"after chunk {n}")
    for slot in range(3):
        np.testing.assert_array_equal(state[slot].numpy(),
                                      np.asarray(ref_state[slot]))
    assert int(state[0][0, 0]) == ref_oracle_stream(
        prompt[0, :prompt_len], 3, 1, D_MODEL, VOCAB)[0]


def _surrogate_cfg(**kw):
    return dict(d_model=D_MODEL, vocab_size=VOCAB, **kw)


def test_surrogate_streams_equal_oracle():
    """prefill -> slot insert -> decode rounds -> eviction through the
    port's engine: every stream equals the port's (and the reference's)
    NumPy oracle, bitwise, across admission waves."""
    with Client(n_regions=2, device="cpu", chunk_budget=2, prefetch=False,
                serving=_surrogate_cfg(max_slots=2,
                                       round_tokens=3)) as client:
        rng = np.random.default_rng(2)
        specs, handles = [], []
        for i in range(4):
            prompt = [int(x) for x in rng.integers(0, VOCAB, size=2 + i)]
            specs.append((prompt, i, 2 + 2 * i))
            handles.append(client.stream(prompt, max_new_tokens=2 + 2 * i,
                                         seed=i))
        for h, (prompt, sd, mx) in zip(handles, specs):
            got = h.result(timeout=TIMEOUT)
            assert got == oracle_stream(prompt, sd, mx, D_MODEL, VOCAB)
            assert got == ref_oracle_stream(prompt, sd, mx, D_MODEL, VOCAB)
        rep = client.serving_report()
    assert rep["n_finished"] == 4 and rep["stranded_sequences"] == 0
    assert rep["slot_inserts"] == 4 and rep["max_slots_used"] == 2
    assert rep["trace"] == {"enabled": False}


# -- attention kernels, chunk by chunk --------------------------------------------

def _prefill_args(prompts, PB=2):
    prompt = np.zeros((PB, P.max_ctx), np.int32)
    meta = np.zeros((PB, A.META_W), np.int32)
    for r, pr in enumerate(prompts):
        prompt[r, :len(pr)] = pr
        meta[r, 0] = len(pr)
    kv = np.zeros((PB, P.max_ctx, P.kv_heads, P.head_dim), np.float32)
    return ((np.zeros((PB, A.PREFILL_OUT_W), np.int32), kv, kv.copy(),
             prompt, meta, A.build_weights(P).copy()),
            dict(PB=PB, P=P.max_ctx, vocab=P.vocab))


def _decode_args(seed=1, S=3, R=6, live=2):
    """The reference test's synthetic decode round: ``live`` active rows
    over shuffled pages, the rest dead (null-page masking)."""
    rng = np.random.default_rng(seed)
    NB = S * P.blocks_per_seq + 1
    shape = (NB, P.block_size, P.kv_heads, P.head_dim)
    k_pool = rng.standard_normal(shape).astype(np.float32)
    v_pool = rng.standard_normal(shape).astype(np.float32)
    k_pool[0] = v_pool[0] = 0.0
    table = np.zeros((S, P.table_width), np.int32)
    for s in range(live):
        pos = int(rng.integers(4, 20))
        table[s, COL_ACTIVE] = 1
        table[s, COL_N_EMIT] = R
        table[s, COL_LAST_TOK] = int(rng.integers(0, P.vocab))
        table[s, A.COL_SEQ_LEN] = pos
        n_blk = -(-(pos + R) // P.block_size)
        table[s, A.TABLE_META:A.TABLE_META + n_blk] = (
            1 + s * P.blocks_per_seq + np.arange(n_blk))
    return ((np.zeros((S, R), np.int32), k_pool, v_pool, table,
             A.build_weights(P)), dict(S=S, R=R, vocab=P.vocab))


def _compare_attn_state(port, ref):
    """Tokens and tables bitwise, K/V within the kernels' tolerance."""
    for slot, (a, b) in enumerate(zip(port[:4], ref[:4])):
        a, b = a.numpy(), np.asarray(b)
        if a.dtype == np.int32:
            np.testing.assert_array_equal(a, b, err_msg=f"slot {slot}")
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=KV_TOL,
                                       err_msg=f"slot {slot}")


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("budget", [1, 2, 3, 4])
def test_attention_kernels_match_reference_every_chunk(kind, budget):
    if kind == "prefill":
        args, kw = _prefill_args([[9, 2, 7], list(range(1, 31))])
    else:
        args, kw = _decode_args()
    name = dict(zip(("prefill", "decode"),
                    A.register_attention_kernels(P)))[kind]
    trace, _, ref_state = _ref_chunks(
        name, ref_get_kernel(name).bundle(*args, **kw), budget)
    state, ints, floats = _port_state(get_kernel(name).bundle(*args, **kw))
    fn, ctx = get_kernel(name).fn, ContextRecord.fresh()
    for n, (fields, ref_chunk_state) in enumerate(trace):
        ctx, state = fn(ctx.with_budget(budget), state, ints, floats)
        _assert_ctx(ctx, fields, f"after chunk {n}")
        _compare_attn_state(state, ref_chunk_state)
    assert ctx.done == 1
    _compare_attn_state(state, ref_state)


def test_weights_bytes_equal_reference_when_drawn_in_chunks(monkeypatch):
    p = A.AttentionParams(d_model=24, vocab=53, seed=11)
    want = RA.build_weights(RA.AttentionParams(d_model=24, vocab=53, seed=11))
    monkeypatch.setattr(A, "_WEIGHT_ROWS_PER_STEP", 7)  # 25 chunks
    got = A.build_weights.__wrapped__(p)
    assert got.tobytes() == want.tobytes()
    t = A.load_weights(got, "cpu")
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), want)


# -- the oracle ----------------------------------------------------------------

ORACLE_CASES = [([9, 2, 7], 7), ([3, 1, 4], 3), ([5] * 30, 8),
                ([int(x) for x in np.random.default_rng(3).integers(
                    0, P.vocab, size=3)], 8)]


@pytest.mark.parametrize("prompt,n", ORACLE_CASES)
def test_attention_oracle_matches_reference(prompt, n):
    """Token streams equal, on the prompts of the reference's
    tests/test_attention_serving.py."""
    assert A.attention_oracle_stream(prompt, n, P) == \
        RA.attention_oracle_stream(prompt, n, RA.AttentionParams())


def test_attention_oracle_invariant_to_schedule_shape():
    base = A.attention_oracle_stream([9, 2, 7], 7, P)
    assert len(set(base)) > 1
    for kw in (dict(round_tokens=2), dict(chunk_budget=1),
               dict(max_slots=2), dict(prefill_batch=2),
               dict(kv_blocks=P.blocks_per_seq + 1)):
        assert base == A.attention_oracle_stream([9, 2, 7], 7, P, **kw), kw
    assert A.attention_oracle_stream([9, 2, 7], 4, P) == base[:4]


# -- the engine under preemption -------------------------------------------------

def _attn_cfg(**kw):
    return dict(lm="attention", d_model=P.d_model, vocab_size=P.vocab, **kw)


def _preempt_decode_at(boundary, cross):
    """on_chunk hook: checkpoint-preempt the first decode round after its
    ``boundary``-th chunk; ``cross`` also drains the region, so the round
    resumes on the other one (through ``materialize``)."""
    seen = {}

    def hook(region, task):
        if task.phase != "decode" or seen.get("fired"):
            return
        seen[task.tid] = seen.get(task.tid, 0) + 1
        if seen[task.tid] == boundary:
            seen["fired"] = True
            if cross:
                region.begin_drain()
            region.request_preempt()
    return hook


@pytest.mark.parametrize("cross", [False, True], ids=["same", "cross"])
@pytest.mark.parametrize("boundary", [1, 2, 3])
def test_attention_engine_preempted_at_every_boundary(boundary, cross):
    R = 4
    with Client(n_regions=2, device="cpu", chunk_budget=1, prefetch=False,
                serving=_attn_cfg(max_slots=3, round_tokens=R)) as client:
        hook = _preempt_decode_at(boundary, cross)  # one hook: fires once
        for r in client.shell.regions:
            r.on_chunk = hook
        rng = np.random.default_rng(3)
        prompts = [[int(x) for x in rng.integers(0, P.vocab, size=n)]
                   for n in (3, 7, 12)]
        handles = [client.stream(pr, max_new_tokens=8, seed=i)
                   for i, pr in enumerate(prompts)]
        got = [h.result(timeout=TIMEOUT) for h in handles]
        rep = client.serving_report()
        sched = client.report()
    for pr, toks in zip(prompts, got):
        assert toks == A.attention_oracle_stream(pr, 8, P, max_slots=3,
                                                 round_tokens=R)
    if boundary < R - 1:  # later, completion may legitimately win the race
        assert rep["decode_preemptions"] >= 1
        if cross:
            assert sched["host_spills_avoided"] == 0
    assert rep["stranded_sequences"] == 0 and rep["kv"]["blocks_in_use"] == 0


def test_attention_packed_prefill_and_starved_pool():
    """prefill_batch=2 packs sequences into one task, and a pool with pages
    for one full sequence defers admission (alloc_deferred) and recycles
    pages (reuse) without perturbing any stream."""
    kv_blocks = P.blocks_per_seq + 1
    with Client(n_regions=2, device="cpu", chunk_budget=2, prefetch=False,
                serving=_attn_cfg(max_slots=2, round_tokens=3,
                                  prefill_batch=2,
                                  kv_blocks=kv_blocks)) as client:
        rng = np.random.default_rng(5)
        prompts = [[int(x) for x in rng.integers(0, P.vocab, size=30)]
                   for _ in range(3)]
        handles = [client.stream(pr, max_new_tokens=8, seed=i)
                   for i, pr in enumerate(prompts)]
        got = [h.result(timeout=TIMEOUT) for h in handles]
        rep = client.serving_report()
    for pr, toks in zip(prompts, got):
        assert toks == A.attention_oracle_stream(
            pr, 8, P, max_slots=2, round_tokens=3, prefill_batch=2,
            kv_blocks=kv_blocks)
    kv = rep["kv"]
    assert rep["prefill_tasks"] < 3
    assert kv["blocks_in_use"] == 0 and kv["alloc_deferred"] >= 1
    assert kv["reuse"] >= 1 and kv["evictions"] >= 3


def test_kv_block_pool_accounting_equals_reference():
    ops = [("ensure", 1, 20), ("ensure", 2, 9), ("ensure", 3, 40),
           ("release", 1), ("ensure", 3, 40), ("ensure", 2, 17),
           ("release", 2), ("release", 3), ("ensure", 4, 8)]
    port, ref = KVBlockPool(9, 8), RefPool(9, 8)
    for op in ops:
        a = getattr(port, op[0])(*op[1:])
        b = getattr(ref, op[0])(*op[1:])
        assert a == b, op
        assert port.stats() == ref.stats(), op
    assert port.stats()["alloc_deferred"] == 1
    assert port.stats()["reuse"] >= 1
    with pytest.raises(ValueError):
        KVBlockPool(1, 8)


def test_attention_rejects_oversized_prompt():
    with Client(n_regions=1, device="cpu", prefetch=False,
                serving=_attn_cfg()) as client:
        bad = client.stream(list(range(1, P.max_ctx + 2)), max_new_tokens=4)
        ok = client.stream([3, 1, 4], max_new_tokens=3)
        assert ok.result(timeout=TIMEOUT) == A.attention_oracle_stream(
            [3, 1, 4], 3, P)
        with pytest.raises(Exception):
            bad.result(timeout=TIMEOUT)
        assert bad.status is SequenceStatus.FAILED


def test_client_submit_and_stream_uniformly():
    """One Client, both verbs: a blur task and a streamed sequence ride
    the same scheduler loop; the iterator yields the oracle's tokens."""
    from repro_torch.kernels.blur.tasks import make_image

    with Client(n_regions=2, device="cpu", chunk_budget=2, prefetch=False,
                serving=_surrogate_cfg(round_tokens=2)) as client:
        img = make_image(np.random.default_rng(4), 24)
        out = client.launch("MedianBlur", (img, np.zeros_like(img)),
                            priority=2, H=24, W=24, iters=1).result(
                                timeout=TIMEOUT)
        assert out[1].shape == img.shape
        assert list(client.stream([5, 4, 3], max_new_tokens=6, seed=9)) == \
            oracle_stream([5, 4, 3], 9, 6, D_MODEL, VOCAB)
        srep = client.serving_report()
    assert srep["n_finished"] == 1 and srep["lm"] == "surrogate"


def test_device_result_tasks_return_tensors():
    """``device_result`` kernels hand back every buffer as a tensor (on the
    CPU here); other kernels still return host numpy."""
    args, kw = _prefill_args([[9, 2, 7]], PB=1)
    name = A.register_attention_kernels(P)[0]
    with Client(n_regions=1, device="cpu", prefetch=False) as client:
        from repro_torch.core.task import Task

        bufs = client.submit(Task(kernel=name, args=get_kernel(name).bundle(
            *args, **kw))).result(timeout=TIMEOUT)
    assert len(bufs) == 6 and all(isinstance(b, torch.Tensor) for b in bufs)
    assert int(bufs[0][0, 0]) == A.attention_oracle_stream([9, 2, 7], 1, P)[0]


# -- across the packages ----------------------------------------------------------

@pytest.mark.parametrize("cut", [1, 4])
def test_reference_preempted_decode_round_finishes_in_port(cut):
    """Preempt a decode round in the reference after ``cut`` chunks, commit
    through its bank, carry the commit over and finish in the port: tokens
    and table equal an uninterrupted reference run, pools within 2e-5."""
    budget = 1
    args, kw = _decode_args(seed=2)
    name = A.register_attention_kernels(P)[1]
    ref_b = ref_get_kernel(name).bundle(*args, **kw)
    full, _, ref_final = _ref_chunks(name, ref_b, budget)
    assert cut < len(full)
    _, rctx, rstate = _ref_chunks(name, ref_b, budget, n=cut)
    bank = RC.ContextBank()
    bank.commit(rctx, payload=rstate, tid=5)
    committed = from_reference(bank.restore().materialize())
    assert committed.payload[3].dtype == np.int32
    assert committed.payload[1].dtype == np.float32

    _, ints, floats = get_kernel(name).bundle(*args, **kw).padded()
    state = tuple(torch.tensor(b) for b in committed.payload)
    ctx, state, _ = run_to_completion(get_kernel(name).fn, committed.context,
                                      state, ints, floats, budget)
    assert ctx.done == 1
    _assert_ctx(ctx, full[-1][0], "at completion")
    _compare_attn_state(state, ref_final)


# -- cross-shell migration of a decode round ------------------------------------

def _migrated_round(name, args, kw, boundary, budget=1):
    """One decode round through a two-shell ``ClusterFrontend`` on the CPU:
    at the round's ``boundary``-th chunk the region's ``on_chunk`` hook
    holds the worker until the driving thread's ``migrate`` has asked for
    the preemption; the round resumes on the other shell from the spill.
    Returns the result buffers and the frontend's report."""
    import threading
    import time

    from repro_torch.cluster import ClusterFrontend
    from repro_torch.core.task import Task

    fe = ClusterFrontend(n_shells=2, regions_per_shell=1,
                         chunk_budget=budget, rebalance=False,
                         prefetch=False, devices=["cpu"])
    t = Task(kernel=name, args=get_kernel(name).bundle(*args, **kw))
    reached, seen = threading.Event(), [0]

    def hold(region, task):
        if task is not t or reached.is_set():
            return
        seen[0] += 1
        if seen[0] == boundary:
            reached.set()
            deadline = time.perf_counter() + TIMEOUT
            while (not region._preempt.is_set()
                   and time.perf_counter() < deadline):
                time.sleep(0.001)

    for node in fe.nodes:
        for r in node.shell.regions:
            r.on_chunk = hold
    try:
        h = fe.submit(t)
        assert reached.wait(TIMEOUT), "the round never reached its hold"
        assert fe.migrate(tid=t.tid), "forced migration never completed"
        out = h.result(timeout=TIMEOUT)
        assert h.n_migrations == 1 and h.node_history == [0, 1]
        spills = [f for f in os.listdir(fe.spill_dir)
                  if f.startswith(f"task{t.tid}.") and f.endswith(".npz")]
        assert len(spills) == 1
    finally:
        rep = fe.shutdown()
    assert rep["stranded_handles"] == 0 and rep["lost_tasks"] == 0
    assert rep["migrations_completed"] == 1
    return out


@pytest.mark.parametrize("boundary", [1, 3])
def test_cross_shell_migration_mid_decode_bit_identical(boundary):
    """A surrogate decode round migrated between shells mid-round streams
    exactly the reference's tokens, state and slot table."""
    ref_b, port_b = _surrogate_bundles(np.random.default_rng(1), R=6)
    _, _, ref_state = _ref_chunks("SeqDecode", ref_b, 1)
    args = tuple(np.asarray(b) for b in port_b.bufs)
    kw = dict(S=3, D=D_MODEL, R=6, vocab=VOCAB)
    out = _migrated_round("SeqDecode", args, kw, boundary)
    for slot in range(3):
        np.testing.assert_array_equal(np.asarray(out[slot]),
                                      np.asarray(ref_state[slot]))


@pytest.mark.parametrize("boundary", [2, 4])
def test_decode_round_survives_cross_shell_migration(boundary):
    """Spill the mid-round KV pages to the host (CRC-checked), carry them
    to the other shell, finish there: bitwise the uninterrupted port run,
    and the reference's tokens and tables (pools within 2e-5)."""
    args, kw = _decode_args(seed=2)
    name = A.register_attention_kernels(P)[1]
    _, _, ref_final = _ref_chunks(
        name, ref_get_kernel(name).bundle(*args, **kw), 1)
    state, ints, floats = _port_state(get_kernel(name).bundle(*args, **kw))
    _, want, _ = run_to_completion(get_kernel(name).fn, ContextRecord.fresh(),
                                   state, ints, floats, 1)
    out = _migrated_round(name, args, kw, boundary)
    for a, b in zip(out[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    _compare_attn_state(out, ref_final)
