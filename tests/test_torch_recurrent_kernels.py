"""The port's recurrence kernels (RG-LRU scan B4, RWKV-6 B5) against the
reference on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions; they are
held against the reference's Pallas kernels in interpret mode (through the
reference's own wrappers) and against its ``ref.py`` oracles, on the same
numpy inputs, at the sweep shapes of ``tests/test_kernels.py`` plus a
nonzero initial state and a one-step (decode) length.  The hand-written
CUDA kernels run only on the card: their tests are in
``test_torch_cuda.py``.  Tolerances are the reference's: 1e-5 for the
scan, 1e-4 for RWKV-6.
"""
import threading
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rglru_scan.ops import rglru_scan as ref_rglru  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro.kernels.rwkv6.ops import rwkv6 as ref_rwkv6  # noqa: E402
from repro.kernels.rwkv6.ref import rwkv6_ref  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as GK  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as gops  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as WK  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wops  # noqa: E402

SCAN_TOL, RWKV_TOL = 1e-5, 1e-4
SCAN_SHAPES = [(2, 64, 200), (1, 128, 128), (3, 33, 100), (4, 1, 4096)]
RWKV_SHAPES = [(2, 48, 3, 16), (1, 64, 2, 32), (2, 17, 4, 8), (4, 1, 32, 64)]


def _scan_inputs(seed, B, T, L):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, T, L))))).astype(np.float32)
    b = rng.standard_normal((B, T, L), dtype=np.float32)
    h0 = rng.standard_normal((B, L), dtype=np.float32)
    return a, b, h0


def _rwkv_inputs(seed, B, T, H, hd):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd), dtype=np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, T, H, hd), dtype=np.float32)
                   * 0.5 - 1).astype(np.float32)
    u = (rng.standard_normal((H, hd), dtype=np.float32) * 0.1)
    s0 = rng.standard_normal((B, H, hd, hd), dtype=np.float32) * 0.5
    return r, k, v, logw, u, s0


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)


# -- RG-LRU scan (B4) ---------------------------------------------------------

@pytest.mark.parametrize("B,T,L", SCAN_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_rglru_scan_matches_reference(B, T, L, with_h0):
    a, b, h0 = _scan_inputs(B * T + L, B, T, L)
    h0 = h0 if with_h0 else np.zeros_like(h0)
    hs, h_last = gops.rglru_scan(torch.tensor(a), torch.tensor(b),
                                 torch.tensor(h0) if with_h0 else None)
    assert hs.dtype == torch.float32 and hs.shape == (B, T, L)
    ja, jb, jh = jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)
    for want_hs, want_last in (ref_rglru(ja, jb, jh),
                               rglru_scan_ref(ja, jb, jh)):
        _close(hs, want_hs, SCAN_TOL)
        _close(h_last, want_last, SCAN_TOL)


# -- RWKV-6 (B5) --------------------------------------------------------------

@pytest.mark.parametrize("B,T,H,hd", RWKV_SHAPES)
@pytest.mark.parametrize("with_s0", [False, True])
def test_plain_rwkv6_matches_reference(B, T, H, hd, with_s0):
    r, k, v, logw, u, s0 = _rwkv_inputs(B * T + H * hd, B, T, H, hd)
    o, s_last = wops.rwkv6(*(torch.tensor(x) for x in (r, k, v, logw, u)),
                           torch.tensor(s0) if with_s0 else None)
    assert o.dtype == torch.float32 and o.shape == (B, T, H, hd)
    args = [jnp.asarray(x) for x in (r, k, v, logw, u)]
    js0 = jnp.asarray(s0) if with_s0 else None
    for want_o, want_s in (ref_rwkv6(*args, js0), rwkv6_ref(*args, js0)):
        _close(o, want_o, RWKV_TOL)
        _close(s_last, want_s, RWKV_TOL)


def test_plain_rwkv6_reads_strided_inputs():
    """Inputs that are views with a non-contiguous layout give the same
    result as their contiguous copies."""
    B, T, H, hd = 2, 9, 3, 16
    r, k, v, logw, u, s0 = (torch.tensor(x) for x in
                            _rwkv_inputs(3, B, T, H, hd))
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2)
               for x in (r, k, v, logw)]
    o1, s1 = wops.rwkv6(*strided, u, s0)
    o2, s2 = wops.rwkv6(r, k, v, logw, u, s0)
    assert torch.equal(o1, o2) and torch.equal(s1, s2)


# -- dispatch -----------------------------------------------------------------

def test_cpu_tensors_never_touch_the_cuda_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"the CPU path loaded the CUDA library {name}")

    for mod in (native, GK, WK):
        monkeypatch.setattr(mod, "load_library", refuse)
    before = (GK.LAUNCHES.total(), WK.LAUNCHES.total())
    a, b, h0 = (torch.tensor(x) for x in _scan_inputs(1, 2, 5, 40))
    gops.rglru_scan(a, b, h0)
    wops.rwkv6(*(torch.tensor(x) for x in _rwkv_inputs(2, 1, 4, 2, 8)))
    assert (GK.LAUNCHES.total(), WK.LAUNCHES.total()) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers validate before they build or launch anything."""
    a, b, h0 = (torch.tensor(x) for x in _scan_inputs(1, 2, 5, 40))
    with pytest.raises(ValueError, match="CUDA tensor"):
        GK.launch(a, b, h0)
    r, k, v, logw, u, s0 = (torch.tensor(x) for x in
                            _rwkv_inputs(2, 1, 4, 2, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        WK.launch(r, k, v, logw, u, s0)


def test_plain_versions_is_scoped_to_its_block_and_thread():
    on_card = types.SimpleNamespace(is_cuda=True)
    assert native.use_kernel(on_card)
    assert not native.use_kernel(types.SimpleNamespace(is_cuda=False))
    seen = []
    with gops.plain_versions():
        assert not native.use_kernel(on_card)
        t = threading.Thread(target=lambda: seen.append(
            native.use_kernel(on_card)))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [True]
    assert native.use_kernel(on_card)
    assert wops.plain_versions is gops.plain_versions


# -- the kernels' association orders, rehearsed in plain torch ----------------
# The CUDA kernels sum in another order than the step loops of the plain
# versions.  These models repeat each kernel's order step for step (without
# its fused multiply-adds), so a run without a card checks that the order
# alone stays inside the tolerances against the plain version and the
# reference.

def _segmented_scan(a, b, h0, P, S):
    """B4 (csrc/rglru_scan.cu): tiles of P segments of S steps; each
    segment's pair (A = prod a, H = scan from 0), folded in order from the
    carried h into each segment's incoming h, then the segment replayed."""
    B, T, L = a.shape
    h = torch.zeros((B, L)) if h0 is None else h0.clone()
    hs = torch.empty((B, T, L))
    for t0 in range(0, T, P * S):
        segs = [(ts, min(S, T - ts)) for ts in range(t0, t0 + P * S, S)
                if ts < T]
        pairs = []
        for ts, n in segs:
            A, H = torch.ones((B, L)), torch.zeros((B, L))
            for t in range(ts, ts + n):
                A, H = A * a[:, t], a[:, t] * H + b[:, t]
            pairs.append((A, H))
        h_in = h
        for (ts, n), (A, H) in zip(segs, pairs):
            x = h_in
            for t in range(ts, ts + n):
                x = a[:, t] * x + b[:, t]
                hs[:, t] = x
            h_in = A * h_in + H
        h = x  # the last segment's replayed h carries on
    return hs, h


def _rwkv6_row_groups(r, k, v, logw, u, s0, R=8):
    """B5 (csrc/rwkv6.cu): rows padded to the cap (16, 32 or 64) and split
    in halves over 2 warps; lane g of a warp holds rows g, g + R, ... of
    its warp's half and sums, in order, r_i S_ij and
    r_i u_i k_i over them, then adds v_j times the second sum; a warp's R
    lanes are added by the transposing butterfly, xor 4, then 2, then 1,
    as ((g0 + g4) + (g2 + g6)) + ((g1 + g5) + (g3 + g7)); the warps' sums
    are added last, in order."""
    B, T, H, hd = r.shape
    cap = next(c for c in (16, 32, 64) if hd <= c)
    warps = 2
    pad = (0, cap - hd)
    r, k, logw = (torch.nn.functional.pad(x, pad) for x in (r, k, logw))
    u = torch.nn.functional.pad(u, pad)
    s = torch.zeros((B, H, cap, hd))
    if s0 is not None:
        s[:, :, :hd] = s0
    o = torch.empty((B, T, H, hd))
    for t in range(T):
        kt, vt = k[:, t], v[:, t]
        # row w cap / warps + g + R m -> [warp w, m, g]
        split = (B, H, warps, cap // warps // R, R)
        rs = (r[:, t][..., None] * s).view(*split, hd)
        ruk = (r[:, t] * u * kt).view(*split)
        p = torch.zeros((B, H, warps, R, hd))
        q = torch.zeros((B, H, warps, R))
        for m in range(rs.shape[3]):
            p = p + rs[:, :, :, m]
            q = q + ruk[:, :, :, m]
        p = p + vt[:, :, None, None, :] * q[..., None]
        while p.shape[3] > 1:  # lanes (g, g^4), then (g, g^2), (g, g^1)
            half = p.shape[3] // 2
            p = p[:, :, :, :half] + p[:, :, :, half:]
        total = p[:, :, 0, 0]
        for w in range(1, warps):
            total = total + p[:, :, w, 0]
        o[:, t] = total
        s = torch.exp(logw[:, t])[..., None] * s + kt[..., None] * vt[:, :, None, :]
    return o, s[:, :, :hd]


@pytest.mark.parametrize("T,want", [(1, (1, 1)), (2, (1, 2)), (16, (1, 16)),
                                    (17, (2, 9)), (33, (3, 11)),
                                    (128, (8, 16)), (129, (8, 16)),
                                    (2048, (8, 16))])
def test_rglru_scan_plan(T, want):
    """One segment of one step at decode; otherwise as few segments of at
    most 16 steps as cover T, at most 8, the steps spread evenly."""
    P, S = GK.plan(T)
    assert (P, S) == want
    assert 1 <= P <= GK.MAX_SEGMENTS and 1 <= S <= GK.SEGMENT_STEPS
    assert P * S >= min(T, GK.MAX_SEGMENTS * GK.SEGMENT_STEPS)
    assert (P - 1) * S < T  # no segment of the first tile is empty


def test_rglru_scan_vector_width():
    """float4 channels only where L and every pointer and stride allow."""
    a, b, h0 = (torch.tensor(x) for x in _scan_inputs(1, 2, 5, 64))
    assert GK.vector_width(a, b, h0) == 4
    assert GK.vector_width(a, b) == 4
    assert GK.vector_width(a[..., :60], b[..., :60]) == 4  # strides 320, 64
    assert GK.vector_width(a[..., 1:61], b[..., 1:61]) == 1  # misaligned
    assert GK.vector_width(a, b, torch.zeros(2, 65)[:, 1:]) == 1
    a3, b3 = (torch.tensor(x) for x in _scan_inputs(1, 2, 5, 100)[:2])
    assert GK.vector_width(a3, b3) == 4
    a5, b5 = (torch.tensor(x) for x in _scan_inputs(1, 2, 5, 102)[:2])
    assert GK.vector_width(a5, b5) == 1


@pytest.mark.parametrize("B,T,L,a_kind", [
    (4, 128, 4096, "sigmoid"), (2, 2, 100, "sigmoid"), (2, 17, 100, "sigmoid"),
    (1, 129, 64, "sigmoid"), (1, 2048, 32, "sigmoid"), (2, 129, 100, "0/1")])
@pytest.mark.parametrize("with_h0", [False, True])
def test_segmented_scan_order_matches_plain_and_reference(B, T, L, a_kind,
                                                          with_h0):
    """B4's association order at the serving prefill shape and the edges
    of its segments and time tiles, with a = 0 and a = 1 exactly among the
    gates in the "0/1" case: within 1e-5 of the step loop and the
    reference."""
    a, b, h0 = _scan_inputs(B * T + L, B, T, L)
    if a_kind == "0/1":
        pick = np.random.default_rng(T).random((B, T, L))
        a = np.where(pick < 0.25, 0.0, np.where(pick < 0.5, 1.0, a))
        a = a.astype(np.float32)
    h0 = h0 if with_h0 else None
    ta, tb = torch.tensor(a), torch.tensor(b)
    th0 = None if h0 is None else torch.tensor(h0)
    hs, h_last = _segmented_scan(ta, tb, th0, *GK.plan(T))
    want_hs, want_last = gops.rglru_scan(ta, tb, th0)
    torch.testing.assert_close(hs, want_hs, rtol=0, atol=SCAN_TOL)
    torch.testing.assert_close(h_last, want_last, rtol=0, atol=SCAN_TOL)
    torch.testing.assert_close(h_last, hs[:, -1], rtol=0, atol=0)
    jh0 = jnp.zeros((B, L), jnp.float32) if h0 is None else jnp.asarray(h0)
    ref_hs, ref_last = rglru_scan_ref(jnp.asarray(a), jnp.asarray(b), jh0)
    _close(hs, ref_hs, SCAN_TOL)
    _close(h_last, ref_last, SCAN_TOL)


@pytest.mark.parametrize("B,T,H,hd,decay", [
    (4, 128, 32, 64, "random"), (2, 17, 2, 8, "random"),
    (1, 33, 3, 40, "random"), (2, 33, 2, 64, "w=0"), (2, 33, 2, 64, "w=1")])
@pytest.mark.parametrize("with_s0", [False, True])
def test_rwkv6_row_group_order_matches_plain_and_reference(B, T, H, hd, decay,
                                                           with_s0):
    """B5's readout order (row groups, then the butterfly) at the serving
    prefill shape, small and ragged head dims, and the extreme decays
    logw = -80 (w about 0) and logw = 0 (w = 1): within 1e-4 of the step
    loop and the reference."""
    r, k, v, logw, u, s0 = _rwkv_inputs(B * T + H * hd, B, T, H, hd)
    if decay != "random":
        logw = np.full_like(logw, -80.0 if decay == "w=0" else 0.0)
    s0 = s0 if with_s0 else None
    args = [torch.tensor(x) for x in (r, k, v, logw, u)]
    ts0 = None if s0 is None else torch.tensor(s0)
    o, s_last = _rwkv6_row_groups(*args, ts0)
    want_o, want_s = wops.rwkv6(*args, ts0)
    torch.testing.assert_close(o, want_o, rtol=0, atol=RWKV_TOL)
    torch.testing.assert_close(s_last, want_s, rtol=0, atol=RWKV_TOL)
    ref_o, ref_s = rwkv6_ref(*(jnp.asarray(x) for x in (r, k, v, logw, u)),
                             None if s0 is None else jnp.asarray(s0))
    _close(o, ref_o, RWKV_TOL)
    _close(s_last, ref_s, RWKV_TOL)
