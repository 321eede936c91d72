"""The port's optimizer, gradient compression and data pipeline against the
reference's on the CPU.

Twins of ``tests/test_substrate.py``'s optimizer, compression and pipeline
tests, plus direct parity on the same numpy inputs: ``schedule`` within
1e-7, ``adamw_update`` over a random tree within 1e-6 (f32 and bf16 optimizer
state), int8 codes bitwise with scales within 1 ulp, error feedback within
1e-6, and ``SyntheticTokens`` batches bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

try:  # the property test degrades to a fixed grid without the dep
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - exercised on minimal containers
    HAVE_HYPOTHESIS = False

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as RP  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro.optim import compression as RC  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.data import pipeline as P  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.optim.adamw import global_norm, schedule  # noqa: E402
from repro_torch.optim.compression import (Int8Compressor,  # noqa: E402
                                           _dequantize, _quantize,
                                           compress_tree, decompress_tree)

SCHEDULE_TOL, ADAMW_TOL, FEEDBACK_TOL = 1e-7, 1e-6, 1e-6


def _ref_opt(opt: AdamWConfig) -> RA.AdamWConfig:
    import dataclasses
    return RA.AdamWConfig(**dataclasses.asdict(opt))


def _np(tree):
    return jax.tree.map(lambda t: np.asarray(t, np.float32), tree)


def _port_np(tree):
    return jax.tree.map(lambda t: t.float().numpy(), tree)


# -- twins of tests/test_substrate.py --------------------------------------

def test_adamw_minimizes_quadratic():
    opt = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                      total_steps=200)
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    master, m, v = adamw_init(params, opt)
    step = torch.zeros((), dtype=torch.int32)
    for _ in range(150):
        g = {"w": 2 * master["w"]}  # d/dw (w^2)
        params, master, m, v = adamw_update(g, params, master, m, v, step,
                                            opt)
        step = step + 1
    assert float(master["w"].abs().max()) < 0.2


def test_adamw_bf16_state_close_to_fp32():
    o32 = AdamWConfig(lr=0.05, weight_decay=0.0, total_steps=100)
    o16 = AdamWConfig(lr=0.05, weight_decay=0.0, total_steps=100,
                      state_dtype="bfloat16")
    res = {}
    for name, opt in [("f32", o32), ("bf16", o16)]:
        params = {"w": torch.linspace(-1, 1, 32)}
        master, m, v = adamw_init(params, opt)
        assert m["w"].dtype == opt.state_torch_dtype
        step = torch.zeros((), dtype=torch.int32)
        for _ in range(50):
            g = {"w": 2 * master["w"] + 0.1}
            params, master, m, v = adamw_update(g, params, master, m, v,
                                                step, opt)
            step = step + 1
        res[name] = master["w"].numpy()
    np.testing.assert_allclose(res["bf16"], res["f32"], atol=0.05)


def test_schedule_warmup_and_decay():
    opt = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    assert float(schedule(torch.tensor(0), opt)) == 0.0
    assert abs(float(schedule(torch.tensor(10), opt)) - 1.0) < 1e-6
    assert float(schedule(torch.tensor(100), opt)) == pytest.approx(
        0.1, rel=1e-3)
    assert float(schedule(torch.tensor(5), opt)) == pytest.approx(
        0.5, rel=1e-3)


def _check_error_bound(xs):
    """Blockwise int8 roundtrip error <= max|block| / 127 / 2 per element
    (half an LSB of the block scale)."""
    x = torch.tensor(np.array(xs, np.float32))
    q, scale = _quantize(x)
    deq = _dequantize(q, scale, tuple(x.shape))
    err = np.abs(deq.numpy() - x.numpy())
    flat = x.numpy()
    pad = (-flat.size) % 256
    blocks = np.pad(flat, (0, pad)).reshape(-1, 256)
    bound = np.abs(blocks).max(1) / 127.0 * 0.5 + 1e-6
    err_blocks = np.pad(err, (0, pad)).reshape(-1, 256)
    assert (err_blocks <= bound[:, None] + 1e-7).all()


if HAVE_HYPOTHESIS:
    @settings(max_examples=20, deadline=None,
              suppress_health_check=list(HealthCheck))
    @given(st.lists(st.floats(-1e3, 1e3, allow_nan=False, width=32),
                    min_size=1, max_size=600))
    def test_int8_quantization_error_bound(xs):
        _check_error_bound(xs)
else:  # pragma: no cover
    @pytest.mark.parametrize("seed", range(20))
    def test_int8_quantization_error_bound(seed):
        rng = np.random.default_rng(seed)
        _check_error_bound(rng.uniform(-1e3, 1e3, rng.integers(1, 600)))


def test_error_feedback_is_unbiased_over_time():
    rng = np.random.default_rng(0)
    g_true = {"w": torch.tensor(rng.normal(size=300).astype(np.float32))}
    res = Int8Compressor.init_residual(g_true)
    total = torch.zeros_like(g_true["w"])
    for _ in range(20):
        deq, res = Int8Compressor.apply_with_feedback(g_true, res)
        total = total + deq["w"]
    np.testing.assert_allclose((total / 20).numpy(), g_true["w"].numpy(),
                               atol=2e-2)


def test_data_pipeline_deterministic_and_resumable():
    cfg = P.DataConfig(seed=7, vocab_size=64, seq_len=32, global_batch=4)
    d1, d2 = P.SyntheticTokens(cfg), P.SyntheticTokens(cfg)
    for s in (0, 1, 17, 1000):
        np.testing.assert_array_equal(d1.batch(s)["tokens"],
                                      d2.batch(s)["tokens"])
    got = [b["tokens"] for _, b in d2.batches(5, 3)]
    want = [d1.batch(5 + i)["tokens"] for i in range(3)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    b = d1.batch(0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == -1).all()


# -- direct parity with the reference ---------------------------------------

@pytest.mark.parametrize("opt", [
    AdamWConfig(),
    AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
    AdamWConfig(lr=2e-3, warmup_steps=0, total_steps=7, min_lr_frac=0.0),
])
def test_schedule_matches_reference(opt):
    steps = np.array([0, 1, 3, 5, 9, 10, 11, 50, 99, 100, 101, 5000, 20000],
                     np.int32)
    want = np.array([float(RA.schedule(jnp.int32(s), _ref_opt(opt)))
                     for s in steps], np.float32)
    got = np.array([float(schedule(torch.tensor(s), opt)) for s in steps],
                   np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=SCHEDULE_TOL)


def _random_tree(rng):
    return {"a": rng.normal(size=(7, 5)).astype(np.float32),
            "b": [rng.normal(size=(300,)).astype(np.float32),
                  rng.normal(size=(2, 3, 4)).astype(np.float32)],
            "c": {"d": rng.normal(size=(1,)).astype(np.float32)}}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype):
    """Four updates from the same params and gradients (the first at lr 0,
    the warmup's), clipped (grad_clip 1.0 against norms of ~20): master,
    params, m and v within 1e-6 (m/v as stored)."""
    rng = np.random.default_rng(11)
    opt = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                      state_dtype=state_dtype)
    ropt = _ref_opt(opt)
    p0 = _random_tree(rng)
    rp = jax.tree.map(jnp.asarray, p0)
    rmaster, rm, rv = RA.adamw_init(rp, ropt)
    pp = params_from_reference(p0, "cpu")
    pmaster, pm, pv = adamw_init(pp, opt)
    for step in range(4):
        g = jax.tree.map(lambda x: x * 3.0, _random_tree(rng))
        rp, rmaster, rm, rv = RA.adamw_update(
            jax.tree.map(jnp.asarray, g), rp, rmaster, rm, rv,
            jnp.int32(step), ropt)
        out = adamw_update(params_from_reference(g, "cpu"), pp, pmaster, pm,
                           pv, torch.tensor(step, dtype=torch.int32), opt)
        assert all(a is b for a, b in zip(jax.tree.leaves(out),
                                          jax.tree.leaves((pp, pmaster, pm,
                                                           pv))))
        for want, got in ((rp, pp), (rmaster, pmaster), (rm, pm), (rv, pv)):
            for a, b in zip(jax.tree.leaves(_np(want)),
                            jax.tree.leaves(_port_np(got))):
                np.testing.assert_allclose(b, a, rtol=0, atol=ADAMW_TOL)
    assert pm["a"].dtype == opt.state_torch_dtype
    gn = global_norm(params_from_reference(p0, "cpu"))
    np.testing.assert_allclose(float(gn), float(RA.global_norm(
        jax.tree.map(jnp.asarray, p0))), rtol=1e-6)


def test_adamw_init_copies_master_even_for_f32():
    params = {"w": torch.ones(3)}
    master, m, v = adamw_init(params, AdamWConfig())
    assert master["w"].data_ptr() != params["w"].data_ptr()
    master["w"].add_(1.0)
    assert float(params["w"][0]) == 1.0
    assert m["w"].dtype == v["w"].dtype == torch.float32


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 4096])
def test_int8_codes_match_reference_bitwise(n):
    """Codes bitwise (``torch.round`` and ``jnp.round`` both round half to
    even; exact halves included), scales within 1 ulp, the roundtrip
    within 1 ulp of its values."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * 10 ** rng.uniform(-3, 3)).astype(np.float32)
    x[: n // 4] = np.round(x[: n // 4] * 2) / 2  # exact halves in the mix
    rq, rs = RC._quantize(jnp.asarray(x))
    q, s = _quantize(torch.tensor(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.dtype == torch.int8
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(rs), maxulp=1)
    np.testing.assert_array_max_ulp(
        _dequantize(q, s, (n,)).numpy(),
        np.asarray(RC._dequantize(rq, rs, (n,))), maxulp=1)


def test_compress_tree_and_feedback_match_reference():
    rng = np.random.default_rng(3)
    tree = _random_tree(rng)
    rc = RC.compress_tree(jax.tree.map(jnp.asarray, tree))
    pc = compress_tree(params_from_reference(tree, "cpu"))
    r_leaves = jax.tree.leaves(rc)
    p_leaves = [x for x in jax.tree.leaves(
        pc, is_leaf=lambda x: isinstance(x, torch.Tensor))
        if isinstance(x, torch.Tensor)]
    r_arrays = [x for x in r_leaves if hasattr(x, "shape")
                and not isinstance(x, int)]
    for a, b in zip(r_arrays, p_leaves):
        np.testing.assert_array_max_ulp(b.float().numpy(),
                                        np.asarray(a, np.float32), maxulp=1)
    for a, b in zip(jax.tree.leaves(_np(RC.decompress_tree(rc))),
                    jax.tree.leaves(_port_np(decompress_tree(pc)))):
        np.testing.assert_array_max_ulp(b, a, maxulp=1)
    # error feedback, three rounds
    rres = RC.Int8Compressor.init_residual(jax.tree.map(jnp.asarray, tree))
    pres = Int8Compressor.init_residual(params_from_reference(tree, "cpu"))
    comp = Int8Compressor()
    assert comp.pair() == (compress_tree, decompress_tree)
    for _ in range(3):
        g = _random_tree(rng)
        rdeq, rres = RC.Int8Compressor.apply_with_feedback(
            jax.tree.map(jnp.asarray, g), rres)
        pdeq, pres = Int8Compressor.apply_with_feedback(
            params_from_reference(g, "cpu"), pres)
        for a, b in zip(jax.tree.leaves(_np((rdeq, rres))),
                        jax.tree.leaves(_port_np((pdeq, pres)))):
            np.testing.assert_allclose(b, a, rtol=0, atol=FEEDBACK_TOL)


def test_synthetic_tokens_match_reference_bitwise():
    for kw in ({}, {"seed": 7, "vocab_size": 64, "seq_len": 32,
                    "global_batch": 4},
               {"seed": 5, "vocab_size": 512, "seq_len": 40,
                "global_batch": 3, "motif_len": 7, "n_motifs": 9}):
        ref = RP.SyntheticTokens(RP.DataConfig(**kw))
        port = P.SyntheticTokens(P.DataConfig(**kw))
        for s in range(10):
            rb, pb = ref.batch(s), port.batch(s)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(pb[k], rb[k])
                assert pb[k].dtype == rb[k].dtype


def test_for_model_matches_reference():
    from repro.configs import SHAPES as RSHAPES
    from repro.configs import get_config as rget

    for arch, shape, kw in (("qwen3-8b", "train_4k", {}),
                            ("rwkv6-1.6b", "train_4k",
                             {"reduced_batch": 2, "reduced_seq": 48,
                              "seed": 9})):
        rd = RP.for_model(rget(arch), RSHAPES[shape], **kw)
        pd = P.for_model(get_config(arch), SHAPES[shape], **kw)
        assert rd.cfg == RP.DataConfig(**vars(pd.cfg))
        if kw:
            np.testing.assert_array_equal(pd.batch(2)["tokens"],
                                          rd.batch(2)["tokens"])
