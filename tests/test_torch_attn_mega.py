"""M4/M5, the port's persistent attention-LM entries, against the
reference's megakernel on the CPU.

- ``kernels.attn_lm.ops`` on CPU tensors (the plain version: the host loop
  over the port's chunk body) against the reference's ``make_megakernel``
  over ``AttnPrefill``/``AttnDecode``, called directly, launch after launch
  to completion, with the flag at every boundary, at budgets 1, 2 and 4;
- both kernels, at the default geometry and at a params-tagged one, carry
  their persistent entry: on a CUDA device ``make_megakernel`` binds it,
  and the entry hands the context words, buffers, geometry and budget to
  ``kernels.attn_lm.ops``.

Tolerances: context fields, chunk counts, tokens and tables bitwise; K/V
within 2e-5 (the chunk bodies' projections and attention sum in other
orders in the two packages, as ``test_torch_serving.py`` holds them).
The reference megakernel is compiled once per kernel (the budget is a
traced argument) and kept at module level.
"""
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.controller.kernels import get_kernel as ref_get_kernel  # noqa: E402
from repro.core import preemption as R_pre  # noqa: E402
from repro.core.context import ContextRecord as R_Ctx  # noqa: E402
from repro.serving import attention as RA  # noqa: E402
from repro_torch.controller.kernels import get_kernel  # noqa: E402
from repro_torch.core import preemption as P_pre  # noqa: E402
from repro_torch.core.context import ContextRecord as P_Ctx  # noqa: E402
from repro_torch.kernels.attn_lm import kernel as AK  # noqa: E402
from repro_torch.kernels.attn_lm import ops as AO  # noqa: E402
from repro_torch.serving import attention as A  # noqa: E402
from repro_torch.serving.kernels import (  # noqa: E402
    COL_ACTIVE, COL_LAST_TOK, COL_N_EMIT)

P = A.AttentionParams()
KV_TOL = 2e-5
FIELDS = ("var", "init_var", "incr_var", "saved", "valid", "done", "budget",
          "intr")
TAGGED = A.AttentionParams(d_model=32, vocab=67, n_heads=4, kv_heads=1,
                           head_dim=8, block_size=4, max_ctx=16, seed=3)


def _prefill_inputs(p, prompts=((9, 2, 7), tuple(range(1, 31)))):
    """A 2-row prefill: a 3-token prompt and a 30-token one, so one
    segment emits for each row and the others emit nothing."""
    PB = len(prompts)
    prompt = np.zeros((PB, p.max_ctx), np.int32)
    meta = np.zeros((PB, A.META_W), np.int32)
    for r, pr in enumerate(prompts):
        prompt[r, :len(pr)] = pr
        meta[r, 0] = len(pr)
    kv = np.zeros((PB, p.max_ctx, p.kv_heads, p.head_dim), np.float32)
    return ((np.full((PB, A.PREFILL_OUT_W), -1, np.int32), kv, kv.copy(),
             prompt, meta, A.build_weights(p).copy()),
            dict(PB=PB, P=p.max_ctx, vocab=p.vocab))


def _decode_inputs(p, S=4, R=5, seed=2):
    """A 4-slot round of 5 steps: a live row, a row of 3 tokens, an
    inactive row and a row of 0 tokens, over shuffled pages."""
    rng = np.random.default_rng(seed)
    NB = S * p.blocks_per_seq + 1
    shape = (NB, p.block_size, p.kv_heads, p.head_dim)
    k_pool = rng.standard_normal(shape).astype(np.float32)
    v_pool = rng.standard_normal(shape).astype(np.float32)
    k_pool[0] = v_pool[0] = 0.0
    table = np.zeros((S, p.table_width), np.int32)
    pages = rng.permutation(np.arange(1, NB))
    for s, (active, n_emit) in enumerate(((1, R), (1, 3), (0, R), (1, 0))):
        pos = int(rng.integers(1, p.max_ctx - R))
        table[s, COL_ACTIVE] = active
        table[s, COL_N_EMIT] = n_emit
        table[s, COL_LAST_TOK] = int(rng.integers(0, p.vocab))
        table[s, A.COL_SEQ_LEN] = pos
        n_blk = -(-(pos + R) // p.block_size)
        table[s, A.TABLE_META:A.TABLE_META + n_blk] = pages[
            s * p.blocks_per_seq:s * p.blocks_per_seq + n_blk]
    return ((np.full((S, R), -1, np.int32), k_pool, v_pool, table,
             A.build_weights(p).copy()), dict(S=S, R=R, vocab=p.vocab))


@functools.lru_cache(maxsize=None)
def _ref_mega(kernel):
    return jax.jit(R_pre.make_megakernel(ref_get_kernel(kernel).fn))


def _port_launch(kernel, words, bufs, budget, flag):
    op = AO.attn_prefill_mega if kernel == "AttnPrefill" else \
        AO.attn_decode_mega
    return op(kernel, words, bufs, P.geometry(), budget, flag).result()


def _compare(mine, ref, where):
    for slot, (a, b) in enumerate(zip(mine, ref)):
        a, b = a.numpy(), np.asarray(b)
        if a.dtype == np.int32:
            np.testing.assert_array_equal(a, b, err_msg=f"{where}, slot "
                                                        f"{slot}")
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=KV_TOL,
                                       err_msg=f"{where}, slot {slot}")


@pytest.mark.parametrize("kernel", ["AttnPrefill", "AttnDecode"])
@pytest.mark.parametrize("budget", [1, 2, 4])
def test_attn_mega_plain_version_equals_reference_megakernel(kernel, budget):
    """``kernels.attn_lm.ops`` on CPU tensors (M4/M5's plain version)
    against the reference's ``make_megakernel`` over ``attn_prefill`` /
    ``attn_decode``, called directly, launch after launch to completion,
    with the flag at every boundary (0: one launch runs the task): every
    context field, the chunk count, the tokens and tables bitwise and the
    K/V within 2e-5 after each launch."""
    A.register_attention_kernels(P)
    RA.register_attention_kernels(RA.AttentionParams())
    if kernel == "AttnPrefill":
        bufs, scalars = _prefill_inputs(P)
        steps, n_state = P.max_ctx // P.block_size, 3
    else:
        bufs, scalars = _decode_inputs(P)
        steps, n_state = scalars["R"], 4
    r_kd = ref_get_kernel(kernel)
    r_mega = _ref_mega(kernel)
    r_flag, p_flag = R_pre.PreemptFlag(), P_pre.PreemptFlag()
    n_chunks = -(-steps // budget)
    for flag in range(0, n_chunks + 2):
        r_bufs, r_ints, r_floats = r_kd.bundle(
            *(b.copy() for b in bufs), **scalars).padded()
        r_state = tuple(jnp.asarray(b) for b in r_bufs)
        r_ctx = R_Ctx.fresh()
        mine = tuple(torch.tensor(b) for b in bufs)
        words = P_Ctx.fresh().to_words()
        for launch in range(100):
            r_flag.write(flag)
            p_flag.write(flag)
            r_ctx, r_state, r_done, r_n = r_mega(
                r_ctx, r_state, r_ints, r_floats, jnp.int32(budget),
                r_flag.device)
            words, n = _port_launch(kernel, words, mine, budget, p_flag)
            where = f"flag {flag}, launch {launch}"
            assert n == int(r_n), where
            assert p_flag.progress() == n, where
            got = P_Ctx.from_words(words)
            for f in FIELDS:
                np.testing.assert_array_equal(
                    getattr(got, f), np.asarray(getattr(r_ctx, f)),
                    err_msg=f"{f}, {where}")
            _compare(mine[:n_state], r_state[:n_state], where)
            if int(r_done):
                break
        assert got.done == 1
        if flag == 0 or flag > n_chunks:
            assert launch == 0  # one launch runs the whole task
    if kernel == "AttnPrefill":  # both rows emitted their first token
        assert (mine[0][:, 0] >= 0).all()
    else:  # the live rows emitted, the others kept their -1s
        out = mine[0].numpy()
        assert (out[0] >= 0).all() and (out[1, :3] >= 0).all()
        assert (out[1, 3:] == -1).all() and (out[2:] == -1).all()


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("p", [P, TAGGED], ids=["default", "tagged"])
def test_attn_kernels_bind_their_persistent_entry(kind, p):
    """``AttnPrefill``/``AttnDecode`` (and a params-tagged geometry's) carry
    their persistent entries (M4/M5, built from ``csrc/attn_lm.cu`` with
    the ``"mega"`` program): on a CUDA device ``make_megakernel`` binds
    them without raising, and the bound launch hands the context words,
    buffers, geometry and budget to ``kernels.attn_lm.ops``, which (given
    CPU tensors here) runs the plain version: its context, chunks and
    buffers equal the host loop's."""
    names = A.register_attention_kernels(p)
    name = names[0] if kind == "prefill" else names[1]
    kd = get_kernel(name)
    assert kd.mega is not None and kd.mega_library == "attn_lm"
    if kind == "prefill":
        bufs, scalars = _prefill_inputs(p, prompts=((5, 1), (3, 3, 3, 3, 3)))
    else:
        bufs, scalars = _decode_inputs(p, R=3)
    _, ints, floats = kd.bundle(*bufs, **scalars).padded()
    flag = P_pre.PreemptFlag()
    flag.write(2)
    mine = tuple(torch.tensor(b) for b in bufs)
    ctx, got, n = P_pre.make_megakernel(kd, torch.device("cuda", 0))(
        P_Ctx.fresh(), mine, ints, floats, 1, flag).result()
    plain = tuple(torch.tensor(b) for b in bufs)
    want_ctx, _, want_n = P_pre.make_megakernel(kd)(
        P_Ctx.fresh(), plain, ints, floats, 1, flag).result()
    assert got is mine and n == want_n == 2 and ctx.done == 0
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ctx, f), getattr(want_ctx, f))
    for a, b in zip(mine, plain):
        assert torch.equal(a, b)


def test_attn_wrappers_refuse_cpu_tensors_and_bad_geometry():
    """The CUDA wrappers take CUDA tensors only, and refuse a head dim past
    128 or not a multiple of 4 before anything is built."""
    bufs, _ = _prefill_inputs(P)
    mine = tuple(torch.tensor(b) for b in bufs)
    flag = P_pre.PreemptFlag()
    flag.device_ptr = 1  # as if mapped: the tensors are what is refused
    words = P_Ctx.fresh().to_words()
    with pytest.raises(ValueError, match="CUDA tensor"):
        AK.attn_prefill_mega(words, *mine, P.geometry(), 1, flag)
    for hd in (130, 18):
        g = P.geometry()._replace(head_dim=hd)
        with pytest.raises(ValueError, match="head dim"):
            AK.attn_prefill_mega(words, *mine, g, 1, flag)


def test_attn_kernel_reads_the_serving_table_layout():
    """M5 indexes the decode table and the context words with constants of
    its own (``csrc/attn_lm.cu``): they are serving's ``COL_*``,
    ``TABLE_META`` and ``SLOT_POS``, and ``AttentionParams.geometry()``
    is what the wrappers take."""
    import re
    from pathlib import Path

    from repro_torch.serving.kernels import SLOT_POS

    src = (Path(AK.__file__).resolve().parents[2] / "csrc"
           / "attn_lm.cu").read_text()
    got = {k: int(v) for k, v in re.findall(r"\b(k\w+) = (\d+)", src)}
    assert {k: got[k] for k in ("kColActive", "kColNEmit", "kColLastTok",
                                "kColSeqLen", "kTableMeta", "kSlotPos")} == {
        "kColActive": COL_ACTIVE, "kColNEmit": COL_N_EMIT,
        "kColLastTok": COL_LAST_TOK, "kColSeqLen": A.COL_SEQ_LEN,
        "kTableMeta": A.TABLE_META, "kSlotPos": SLOT_POS}
    assert TAGGED.geometry() == AK.Geometry(32, 67, 4, 1, 8, 4, 16)
    assert TAGGED.table_width == A.TABLE_META + TAGGED.max_ctx // 4


@pytest.mark.parametrize("p", [P, TAGGED, A.AttentionParams(
    d_model=4096, vocab=151936, n_heads=32, kv_heads=8, head_dim=128,
    block_size=16, max_ctx=128)], ids=["default", "tagged", "serving"])
def test_attn_prefill_workspace_holds_a_chunk(p):
    """M4 projects a whole chunk's rows at once, so the wrapper asks
    ``attn_lm_workspace`` for ``min(budget, segments) x PB x block_size``
    rows (``prefill_rows``): at budgets 1-8 they grow a segment at a time
    up to every segment of the context, then stop."""
    g, PB = p.geometry(), 4
    segs = g.max_ctx // g.block_size
    rows = [AK.prefill_rows(PB, g, budget) for budget in range(1, 9)]
    assert rows == [min(b, segs) * PB * g.block_size for b in range(1, 9)]
    assert rows == sorted(rows) and len(set(rows)) == min(8, segs)
    assert AK.prefill_rows(PB, g, 10 ** 6) == segs * PB * g.block_size
