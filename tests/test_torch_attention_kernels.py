"""The port's attention kernels (flash prefill B2, paged decode B3) against
the reference on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions; they are
held against the reference's Pallas kernels in interpret mode, through the
reference's own wrappers, on the same numpy inputs.  The hand-written CUDA
kernels run only on the card: their tests are in ``test_torch_cuda.py``.
Tolerances are the reference's (``tests/test_attention_kernels.py``):
2e-5 in f32, 2e-2 in bf16 (one bf16 rounding of the output).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention.ops import decode_attention as ref_decode  # noqa: E402
from repro.kernels.decode_attention.ops import (  # noqa: E402
    paged_decode_attention as ref_paged)
from repro.kernels.flash_attention.ops import flash_attention as ref_flash  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402

F32_TOL, BF16_TOL = 2e-5, 2e-2
MAX_FLOOR, DENOM_FLOOR = -0.5e30, 1e-30


def _normal(rng, shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a, dtype=jnp.dtype(dtype)),
            torch.tensor(a).to(getattr(torch, dtype)))


# -- flash attention (B2) -----------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("C,off", [(8, 0), (8, 8), (8, 24), (16, 16)])
def test_plain_flash_matches_reference_over_q_offset(dtype, tol, C, off):
    """The chunked-prefill sweep of the reference's
    ``test_flash_q_offset_matches_full_causal``: a C-query slab at absolute
    offset ``off`` against the whole S-key cache, GQA 4:2."""
    B, H, KV, S, hd = 2, 4, 2, 32, 16
    rng = np.random.default_rng(C * 100 + off)
    q = _normal(rng, (B, H, S, hd))[:, :, off:off + C]
    k, v = _normal(rng, (B, KV, S, hd)), _normal(rng, (B, KV, S, hd))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = ref_flash(jq, jk, jv, causal=True, bq=C, bk=32,
                     q_offset=jnp.asarray([off]))
    got = fops.flash_attention(tq, tk, tv, causal=True, q_offset=off)
    assert got.dtype == tq.dtype and got.shape == (B, H, C, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("window", [None, 1, 5])
@pytest.mark.parametrize("H,KV", [(4, 1), (6, 3), (2, 2)])
def test_plain_flash_matches_reference_gqa_window(window, H, KV):
    B, T, hd = 2, 16, 16
    rng = np.random.default_rng(H * 10 + KV + (window or 0))
    q = _normal(rng, (B, H, T, hd))
    k, v = _normal(rng, (B, KV, T, hd)), _normal(rng, (B, KV, T, hd))
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, window=window)
    got = fops.flash_attention(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_TOL)


def test_plain_flash_fully_masked_row_is_zero():
    """A query row with no visible key (window 0) outputs 0, as the Pallas
    kernel's clamped max and floored denominator make it."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(_normal(rng, (1, 2, 4, 8))) for _ in range(3))
    out = fops.flash_attention(q, k, v, causal=True, window=0)
    assert bool((out == 0).all())
    want = ref_flash(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                     jnp.asarray(v.numpy()), causal=True, window=0)
    np.testing.assert_array_equal(np.asarray(want), out.numpy())


# -- B2's order, rehearsed in plain torch -------------------------------------
# ``csrc/flash_attention.cu`` computes in another order than the plain
# version: a block takes 16 query rows of one (batch, KV head), ``plan``'s
# heads of the group times consecutive positions (position-major); the
# keys any of its rows can see are taken in passes of 128 keys (passes
# wholly outside that range are skipped, keys outside it masked).  Both
# products run on the tensor cores as three TF32 products, a b = a_lo b_hi
# + a_hi b_lo + a_hi b_hi (a_hi the TF32 part of a, a_lo the rest); one
# online softmax rescale runs per pass (max started at -1e30 and clamped
# at -0.5e30, denominator floored at 1e-30).  This model repeats the
# passes and the three-way split (not the tensor cores' order of
# addition), so a run without a card checks that the split and the order
# stay within 2e-5 of the reference's Pallas kernel.

from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402

NEG_INF = -1e30


def _tf32(x):
    """What the tensor cores read of an f32 register: sign, exponent and
    the top 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """a @ b as the kernel's three TF32 products: hi is the TF32 part of a
    value, lo the rest (exact in f32), read by the tensor cores as TF32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _kernel_order_flash(q, k, v, *, causal, window, q_offset, scale):
    """q [B,H,T,hd], k/v [B,KV,S,hd] f32 -> [B,H,T,hd] in the kernel's
    order, every block of a position tile at once."""
    B, H, T, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    hb, npos = FK.plan(B, H, KV, T, S, hd)
    nh = H // KV // hb
    kt = FK.KEYS_PER_PASS
    out = torch.zeros_like(q)
    for t0 in range(0, T, npos):
        t1 = min(T, t0 + npos)
        # rows of a block, position-major: [B, KV, nh, (t, head), hd]
        qb = (q[:, :, t0:t1] * scale).reshape(B, KV, nh, hb, t1 - t0, hd)
        qb = qb.transpose(3, 4).reshape(B, KV, nh, (t1 - t0) * hb, hd)
        qpos = (q_offset + torch.arange(t0, t1)).repeat_interleave(hb)
        kend = min(S, q_offset + t1) if causal else S
        kbeg = max(0, q_offset + t0 - window + 1) if window is not None else 0
        m = torch.full(qb.shape[:-1], NEG_INF)
        lsum = torch.zeros(qb.shape[:-1])
        acc = torch.zeros(qb.shape)
        for base in range(kbeg // kt * kt, kend if kend > kbeg else 0, kt):
            keys = torch.arange(base, base + kt)
            seen = (keys >= kbeg) & (keys < kend)
            idx = keys.clamp(max=S - 1)
            kx = torch.where(seen[:, None], k[:, :, idx], 0.0)[:, :, None]
            vx = torch.where(seen[:, None], v[:, :, idx], 0.0)[:, :, None]
            s = _mm3(qb, kx.transpose(-1, -2))
            ok = seen[None, :].expand(len(qpos), kt)
            if causal:
                ok = ok & (keys[None, :] <= qpos[:, None])
            if window is not None:
                ok = ok & (qpos[:, None] - keys[None, :] < window)
            s = torch.where(ok, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1)).clamp_min(MAX_FLOOR)
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            lsum = lsum * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + _mm3(p, vx)
            m = m_new
        o = acc / lsum.clamp_min(DENOM_FLOOR)[..., None]
        o = o.reshape(B, KV, nh, t1 - t0, hb, hd).transpose(3, 4)
        out[:, :, t0:t1] = o.reshape(B, H, t1 - t0, hd)
    return out


@pytest.mark.parametrize("B,H,KV,T,S,hd,off,window", [
    (4, 32, 8, 16, 128, 128, 0, None),      # the serving prefill shape
    (4, 32, 8, 16, 128, 128, 64, None),
    (4, 32, 8, 16, 128, 128, 112, None),
    (2, 8, 8, 16, 128, 128, 48, None),      # group 1: 16 positions a block
    (2, 32, 4, 16, 128, 128, 112, None),    # group 8: 2 positions a block
    (1, 16, 1, 8, 64, 64, 56, None),        # group 16 (the most a block holds)
    (2, 6, 2, 16, 48, 32, 32, None),        # group 3: one head a block
    (2, 4, 2, 64, 64, 32, None, None),      # the reference's hd sweep
    (1, 4, 1, 64, 64, 64, None, None),
    (1, 4, 4, 64, 64, 120, None, None),     # hd 120: no lane padding
    (1, 8, 8, 64, 64, 128, None, None),
    (1, 4, 2, 64, 64, 64, None, 16),        # a sliding window
    (1, 2, 2, 40, 40, 64, None, None),      # ragged positions and keys
    (2, 4, 2, 16, 70, 16, 30, 9),           # window and ragged S at an offset
    (1, 4, 2, 16, 256, 64, 240, None),      # two passes of 128 keys
    (1, 4, 2, 16, 384, 64, 368, 200),       # a window that skips pass 0
])
def test_kernel_order_flash_matches_reference(B, H, KV, T, S, hd, off,
                                              window):
    rng = np.random.default_rng(B * 1000 + H * 10 + T + hd + (off or 0))
    q = _normal(rng, (B, H, T, hd))
    k, v = _normal(rng, (B, KV, S, hd)), _normal(rng, (B, KV, S, hd))
    q_offset = S - T if off is None else off
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, window=window,
                     q_offset=jnp.asarray([q_offset]))
    got = _kernel_order_flash(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=True, window=window,
                              q_offset=q_offset, scale=1.0 / hd ** 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_TOL)


@pytest.mark.parametrize("B,H,KV,T,S,hd,off,window", [
    (1, 4, 2, 16, 256, 64, 0, None),        # every pass, keys past the rows
    (2, 8, 2, 16, 384, 32, 300, 150),       # a window that skips pass 0
])
def test_kernel_order_flash_non_causal_matches_reference(B, H, KV, T, S, hd,
                                                         off, window):
    """Without the causal mask a block takes every pass from its window's
    first key to S."""
    rng = np.random.default_rng(S + hd + off)
    q = _normal(rng, (B, H, T, hd))
    k, v = _normal(rng, (B, KV, S, hd)), _normal(rng, (B, KV, S, hd))
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=False, window=window,
                     q_offset=jnp.asarray([off]))
    got = _kernel_order_flash(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=False, window=window,
                              q_offset=off, scale=1.0 / hd ** 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_TOL)


def test_kernel_order_flash_fully_masked_rows_are_zero():
    """Window 0: no row sees a key, no pass is taken, and every output is
    exactly 0, as the reference's."""
    rng = np.random.default_rng(2)
    q = _normal(rng, (2, 8, 16, 32))
    k, v = _normal(rng, (2, 2, 48, 32)), _normal(rng, (2, 2, 48, 32))
    got = _kernel_order_flash(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=True, window=0,
                              q_offset=32, scale=32 ** -0.5)
    assert bool((got == 0).all())
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, window=0, q_offset=jnp.asarray([32]))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("shape,want", [
    ((4, 32, 8, 16, 128, 128), FK.Plan(4, 4)),    # the serving shape
    ((4, 32, 32, 16, 128, 128), FK.Plan(1, 16)),  # group 1
    ((4, 32, 4, 16, 128, 128), FK.Plan(8, 2)),    # group 8
    ((1, 32, 1, 16, 128, 128), FK.Plan(16, 1)),   # group 32: two blocks a position
    ((2, 6, 2, 16, 48, 120), FK.Plan(1, 16)),     # group 3
])
def test_flash_plan(shape, want):
    B, H, KV, T, S, hd = shape
    got = FK.plan(*shape)
    assert got == want
    assert got.heads_per_block * got.positions == FK.ROWS
    assert (H // KV) % got.heads_per_block == 0


# -- decode attention (B3) ----------------------------------------------------

def _paged_fixture(B=3, KV=2, hd=16, BS=8, T_blk=4, seed=0):
    """The reference test's pool: every row gets T_blk distinct shuffled
    non-null pages."""
    rng = np.random.default_rng(seed)
    NB = 1 + B * T_blk
    k_pool = _normal(rng, (NB, BS, KV, hd))
    v_pool = _normal(rng, (NB, BS, KV, hd))
    tables = rng.permutation(np.arange(1, NB))[:B * T_blk].reshape(
        B, T_blk).astype(np.int32)
    return k_pool, v_pool, tables, rng


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("pos", [(1, 9, 25), (32, 32, 32), (0, 5, 31)])
def test_plain_paged_decode_matches_reference(pos, window):
    k_pool, v_pool, tables, rng = _paged_fixture(seed=sum(pos))
    q = _normal(rng, (3, 4, 1, 16))
    want = ref_paged(jnp.asarray(q), jnp.asarray(k_pool),
                     jnp.asarray(v_pool), jnp.asarray(tables),
                     jnp.asarray(pos, jnp.int32), window=window)
    got = dops.paged_decode_attention(
        torch.tensor(q), torch.tensor(k_pool), torch.tensor(v_pool),
        torch.tensor(tables), torch.tensor(pos, dtype=torch.int32),
        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_TOL)


@pytest.mark.parametrize("pos", [(0, 3, 16), (17, 40, 100), 23])
def test_plain_ring_decode_matches_reference(pos):
    """Contiguous ring caches, per-row positions including 0 and rings
    that wrapped (pos > S), and a scalar pos broadcast to every row."""
    rng = np.random.default_rng(7)
    B, H, KV, S, hd = 3, 4, 2, 16, 8
    q = _normal(rng, (B, H, 1, hd))
    k, v = _normal(rng, (B, KV, S, hd)), _normal(rng, (B, KV, S, hd))
    jpos = jnp.asarray(pos, jnp.int32)
    tpos = (torch.tensor(pos, dtype=torch.int32)
            if isinstance(pos, tuple) else pos)
    want = ref_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jpos)
    got = dops.decode_attention(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), tpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_TOL)


def test_plain_paged_bitwise_equals_gather_plus_contiguous():
    k_pool, v_pool, tables, rng = _paged_fixture(seed=3)
    q = torch.tensor(_normal(rng, (3, 4, 1, 16)))
    kp, vp, tb = (torch.tensor(a) for a in (k_pool, v_pool, tables))
    dense_k = kp[tb.long()].reshape(3, 32, 2, 16).permute(0, 2, 1, 3)
    dense_v = vp[tb.long()].reshape(3, 32, 2, 16).permute(0, 2, 1, 3)
    assert torch.equal(dref.gather_kv_pages(kp, tb), dense_k)
    for pos in ([7, 19, 32], [0, 1, 2]):
        p = torch.tensor(pos, dtype=torch.int32)
        assert torch.equal(dops.paged_decode_attention(q, kp, vp, tb, p),
                           dops.decode_attention(q, dense_k, dense_v, p))


def test_plain_decode_pos_zero_row_is_exactly_zero():
    """Dead serving slots decode with pos = 0: no valid key, output 0 (the
    reference's direct-softmax oracle would give the mean of v)."""
    k_pool, v_pool, tables, rng = _paged_fixture(seed=4)
    q = torch.tensor(_normal(rng, (3, 4, 1, 16)))
    out = dops.paged_decode_attention(
        q, torch.tensor(k_pool), torch.tensor(v_pool), torch.tensor(tables),
        torch.tensor([0, 0, 5], dtype=torch.int32))
    assert bool((out[:2] == 0).all()) and bool((out[2] != 0).any())


# -- B3's order, rehearsed in plain torch -------------------------------------
# ``csrc/decode_attention.cu`` sums in another order than the plain version:
# the valid keys, in ascending position, are cut into one contiguous slice
# per warp; each warp runs an online softmax over steps of KC keys (max
# started at the reference's -0.5e30 clamp, one rescale per step); the
# warps' states are combined in warp order, and the denominator is floored
# at 1e-30.  This
# model repeats that order (without the fused multiply-adds), so a run
# without a card checks that the order alone stays within 2e-5 of the
# reference.

from repro_torch.kernels.decode_attention import kernel as DK  # noqa: E402


def _combine(states):
    m = torch.stack([s[0] for s in states]).amax(dim=0).clamp_min(MAX_FLOOR)
    lsum = torch.zeros_like(m)
    osum = torch.zeros_like(states[0][2])
    for sm, sl, so in states:
        f = torch.exp(sm - m)
        lsum = f * sl + lsum
        osum = f[:, None] * so + osum
    return m, lsum, osum


def _kernel_order_decode(q, rows, pos, S, window, scale, plan):
    """q [B,H,1,hd]; ``rows(b, kvh, slots) -> (k [n,hd], v [n,hd])`` with
    ``rows.kv`` KV heads; pos a list; ``plan`` a ``kernel.Plan`` ->
    [B,H,1,hd] in the kernel's order."""
    B, H, _, hd = q.shape
    out = torch.zeros_like(q)
    kc = 4 if plan.heads_per_block >= 8 else 8
    ranks = plan.warps
    for b in range(B):
        last = int(pos[b]) - 1
        n = 0 if last < 0 else min(last + 1, S)
        if window is not None:
            n = min(n, window)
        slots = (last - n + 1 + torch.arange(n)) % S
        for h0 in range(0, H, plan.heads_per_block):
            kvh = h0 // (H // rows.kv)
            qs = q[b, h0:h0 + plan.heads_per_block, 0] * scale
            k, v = rows(b, kvh, slots)
            states = []
            for wr in range(ranks):
                m = torch.full((qs.shape[0],), MAX_FLOOR)
                lsum = torch.zeros(qs.shape[0])
                acc = torch.zeros(qs.shape[0], hd)
                for t0 in range(n * wr // ranks, n * (wr + 1) // ranks, kc):
                    t1 = min(t0 + kc, n * (wr + 1) // ranks)
                    s = qs @ k[t0:t1].T
                    mx = torch.maximum(m, s.amax(dim=1))
                    p = torch.exp(s - mx[:, None])
                    alpha = torch.exp(m - mx)
                    psum = torch.zeros_like(m)
                    acc = acc * alpha[:, None]
                    for c in range(t1 - t0):
                        psum = psum + p[:, c]
                        acc = p[:, c:c + 1] * v[t0 + c] + acc
                    lsum, m = lsum * alpha + psum, mx
                states.append((m, lsum, acc))
            _, lsum, acc = _combine(states)
            out[b, h0:h0 + plan.heads_per_block, 0] = (
                acc / lsum.clamp_min(DENOM_FLOOR)[:, None])
    return out


class _DenseRows:
    def __init__(self, k, v):
        self.k, self.v, self.kv = k, v, k.shape[1]

    def __call__(self, b, kvh, slots):
        return self.k[b, kvh, slots], self.v[b, kvh, slots]


class _PagedRows:
    def __init__(self, k_pool, v_pool, tables):
        self.k, self.v, self.tables = k_pool, v_pool, tables.long()
        self.kv, self.bs = k_pool.shape[2], k_pool.shape[1]

    def __call__(self, b, kvh, slots):
        page, off = self.tables[b, slots // self.bs], slots % self.bs
        return self.k[page, off, kvh], self.v[page, off, kvh]


SERVING = dict(B=8, H=32, KV=8, hd=128, BS=16, T_blk=8)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("H,KV", [(32, 8), (32, 32), (32, 4)])
@pytest.mark.parametrize("hd", [64, 128])
def test_kernel_order_decode_matches_reference(window, H, KV, hd):
    """The serving shape (and groups 1 and 8, and hd 64), dead rows
    (pos = 0), a window; paged bitwise equal to gather-plus-contiguous; a
    ring that wrapped."""
    B, BS, T_blk = (SERVING[k] for k in ("B", "BS", "T_blk"))
    S = BS * T_blk
    rng = np.random.default_rng(H + KV + hd + (window or 0))
    NB = 1 + B * T_blk
    k_pool = _normal(rng, (NB, BS, KV, hd))
    v_pool = _normal(rng, (NB, BS, KV, hd))
    tables = rng.permutation(np.arange(1, NB)).reshape(B, T_blk).astype(
        np.int32)
    q = _normal(rng, (B, H, 1, hd))
    pos = [0, 1, 17, 40, 64, 100, 127, 128]
    plan = DK.plan(B, H, KV, S, hd, paged=True)
    scale = 1.0 / hd ** 0.5
    tq, tk, tv, tt = (torch.tensor(a) for a in (q, k_pool, v_pool, tables))
    paged = _kernel_order_decode(tq, _PagedRows(tk, tv, tt), pos, S, window,
                                 scale, plan)
    want = ref_paged(jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
                     jnp.asarray(tables), jnp.asarray(pos, jnp.int32),
                     window=window)
    np.testing.assert_allclose(paged.numpy(), np.asarray(want), rtol=0,
                               atol=F32_TOL)
    assert bool((paged[0] == 0).all())
    dense_k, dense_v = (dref.gather_kv_pages(t, tt) for t in (tk, tv))
    dense = _kernel_order_decode(tq, _DenseRows(dense_k, dense_v), pos, S,
                                 window, scale, plan)
    assert torch.equal(paged, dense)
    ring = [0, 5, 128, 129, 200, 255, 256, 1000]
    got = _kernel_order_decode(tq, _DenseRows(dense_k, dense_v), ring, S,
                               window, scale, plan)
    want = ref_decode(jnp.asarray(q), jnp.asarray(dense_k.numpy()),
                      jnp.asarray(dense_v.numpy()),
                      jnp.asarray(ring, jnp.int32), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_TOL)


@pytest.mark.parametrize("shape,want", [
    ((8, 32, 8, 128, 128), DK.Plan(4, 8)),    # the serving shape
    ((8, 32, 32, 128, 128), DK.Plan(1, 8)),   # group 1
    ((8, 32, 4, 128, 64), DK.Plan(8, 8)),     # group 8, hd 64
    ((8, 32, 8, 1024, 128), DK.Plan(4, 8)),   # long context
    ((2, 4, 2, 12, 16), DK.Plan(2, 2)),       # few keys: few warps
])
def test_decode_plan(shape, want):
    assert DK.plan(*shape, paged=True) == want
    assert DK.smem_bytes(want.heads_per_block, want.warps, shape[4],
                         shape[3]) <= DK.SMEM_BYTES


def test_decode_plan_fits_large_head_dims():
    """The wrapper accepts S + hd up to 12 K: the plan gives fewer heads a
    block until the queries fit the shared memory."""
    p = DK.plan(1, 64, 1, 4096, 12 * 1024 - 4096)
    assert p.heads_per_block == 4
    assert DK.smem_bytes(p.heads_per_block, p.warps, 12 * 1024 - 4096,
                         0) <= DK.SMEM_BYTES
