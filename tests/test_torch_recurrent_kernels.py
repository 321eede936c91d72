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
