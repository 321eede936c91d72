"""The port's uniform ABI and kernel registry against the reference: the
ABI signature is half of the bitstream cache key, so it must be the same
tuple for the same numpy inputs."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import numpy as np  # noqa: E402

from repro.controller import abi as ref_abi  # noqa: E402
from repro.controller.kernels import get_kernel as ref_get_kernel  # noqa: E402
from repro.core.reconfig import ReconfigEngine as RefEngine  # noqa: E402
from repro_torch.controller import abi  # noqa: E402
from repro_torch.controller.hittile import HitTile  # noqa: E402
from repro_torch.controller.kernels import get_kernel, kernel_names  # noqa: E402
from repro_torch.core.reconfig import ReconfigEngine  # noqa: E402
from repro_torch.kernels.blur.tasks import make_image  # noqa: E402


@pytest.mark.parametrize("size", [30, 200])
@pytest.mark.parametrize("n_bufs", [0, 2, 6, 7])
def test_signature_equals_reference(size, n_bufs):
    img = make_image(np.random.default_rng(size), size)
    bufs = tuple(img.copy() if i % 2 == 0 else np.zeros((3, 5), np.int32)
                 for i in range(n_bufs))
    ints, floats = (size, size, 2), (0.5,)
    port = abi.ArgBundle(bufs=bufs, ints=ints, floats=floats)
    ref = ref_abi.ArgBundle(bufs=bufs, ints=ints, floats=floats)
    assert port.signature() == ref.signature()
    assert port.signature() is port.signature()  # memoized
    pbufs, pints, pfloats = port.padded()
    rbufs, rints, rfloats = ref.padded()
    assert len(pbufs) == abi.N_BUF_SLOTS == ref_abi.N_BUF_SLOTS
    np.testing.assert_array_equal(pints, np.asarray(rints))
    np.testing.assert_array_equal(pfloats, np.asarray(rfloats))
    assert pints.dtype == np.int32 and pfloats.dtype == np.float32
    assert isinstance(pints, np.ndarray)  # host control values
    assert port.padded() is port.padded()


@pytest.mark.parametrize("name", ["MedianBlur", "GaussianBlur"])
def test_blur_kernels_registered_like_reference(name):
    kd, rkd = get_kernel(name), ref_get_kernel(name)
    assert (kd.int_args, kd.ktile_args, kd.default_budget, kd.footprint) == \
        (rkd.int_args, rkd.ktile_args, rkd.default_budget, rkd.footprint)
    assert kd.library == "blur"
    img = make_image(np.random.default_rng(0), 30)
    b = kd.bundle(img, img, H=30, W=30, iters=2)
    rb = rkd.bundle(img, img, H=30, W=30, iters=2)
    assert b.ints == rb.ints and b.signature() == rb.signature()
    engine, ref_engine = ReconfigEngine(), RefEngine()
    assert engine.cache_key(name, b.signature(), (1,)) == \
        ref_engine.cache_key(name, rb.signature(), (1,))


def test_only_blur_is_registered_in_this_slice():
    """The registry holds the reference's built-in kernel set: blur plus
    the serving kernels (surrogate and attention LM) since the serving
    slice; unknown names still raise."""
    from repro.controller.kernels import kernel_names as ref_kernel_names

    assert kernel_names() == ref_kernel_names() == [
        "AttnDecode", "AttnPrefill", "GaussianBlur", "MedianBlur",
        "SeqDecode", "SeqPrefill"]
    with pytest.raises(KeyError):
        get_kernel("NoSuchKernel")


@pytest.mark.parametrize("name", ["SeqPrefill", "SeqDecode", "AttnPrefill",
                                  "AttnDecode"])
def test_serving_kernels_registered_like_reference(name):
    kd, rkd = get_kernel(name), ref_get_kernel(name)
    assert (kd.int_args, kd.ktile_args, kd.default_budget, kd.footprint,
            kd.device_result) == (rkd.int_args, rkd.ktile_args,
                                  rkd.default_budget, rkd.footprint,
                                  rkd.device_result)
    assert kd.device_result
    assert kd.library == {"AttnPrefill": "flash_attention",
                          "AttnDecode": "decode_attention"}.get(name)


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_signature_of_tensors_equals_reference(dtype):
    """Device-resident buffers (K/V pools, weights) ride serving bundles as
    tensors: their signature is the reference's tuple for the same shapes,
    read from metadata alone."""
    import jax.numpy as jnp

    shapes = [(5, 8, 2, 16), (3, 12), (7,)]
    tensors = tuple(torch.zeros(s, dtype=getattr(torch, dtype))
                    for s in shapes)
    arrays = tuple(jnp.zeros(s, dtype=dtype) for s in shapes)
    port = abi.ArgBundle(bufs=tensors, ints=(1,))
    ref = ref_abi.ArgBundle(bufs=arrays, ints=(1,))
    assert port.signature() == ref.signature()
    mixed = abi.ArgBundle(bufs=(np.zeros((3, 12), np.int32), tensors[0]))
    assert mixed.signature()[:2] == (((3, 12), "int32"),
                                     ((5, 8, 2, 16), dtype))


def test_signature_never_copies_a_tensor(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("signature() copied a tensor")

    for name in ("__array__", "numpy", "cpu", "clone", "to"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    t = torch.zeros(4, 4)
    assert abi.ArgBundle(bufs=(t,)).signature()[0] == ((4, 4), "float32")


def test_hittile_round_trip():
    h = HitTile.of(np.arange(6, dtype=np.float32).reshape(2, 3), name="x")
    assert h.shape == (2, 3) and h.dtype == np.float32
    t = h.device(torch.device("cpu"))
    assert isinstance(t, torch.Tensor) and h.dtype == torch.float32
    np.testing.assert_array_equal(h.host(), np.arange(6).reshape(2, 3))
