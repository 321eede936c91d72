"""The port's training half against the reference on the CPU: the loss
function, the recurrences' differentiable training route, activation
checkpointing, the inits, twins of ``tests/test_arch_smoke.py``'s forward
and train-step tests, and ``launch/train.py``'s restart and CLI.  The loss
parity over every arch is ``test_torch_train_loss.py``; the train step
and the checkpoint interchange ``test_torch_train_step.py``.

Both packages run the same numpy inputs (the reference's weights carried
across with ``params_from_reference``).  Tolerances: ``cross_entropy``
1e-6; the RG-LRU chunked scan 1e-5 (values; gradients 1e-4); the chunked
RWKV-6 time-mix 1e-4, the reference's rwkv6 tolerance: at chunk 64 its
log-space decay ratios lose ~4e-5 against the step-by-step scan in the
reference's own chunked form too; the port against itself (remat modes,
restart) exactly.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.models import rglru as RRG  # noqa: E402
from repro.models import rwkv as RRW  # noqa: E402
from repro.models import transformer as RTF  # noqa: E402
from repro.optim import AdamWConfig as RAdamWConfig  # noqa: E402
from repro_torch.ckpt.store import _flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as GOPS  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as WOPS  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models import rglru as RG  # noqa: E402
from repro_torch.models import rwkv as RW  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402

CE_TOL, SCAN_TOL, GRAD_TOL = 1e-6, 1e-5, 1e-4
RWKV_TOL = 1e-4
B, T_SEQ, Q_CHUNK = 2, 32, 8
# every arch the port trains, reduced; recurrentgemma also at 5 layers,
# where its stack ends in an ('rglru', 'rglru') tail
ARCHS = ["qwen3-8b", "granite-20b", "phi4-mini-3.8b", "h2o-danube-3-4b",
         "recurrentgemma-9b", "recurrentgemma-tail", "rwkv6-1.6b",
         "mixtral-8x22b", "dbrx-132b"]


def _configs(name):
    arch = "recurrentgemma-9b" if name == "recurrentgemma-tail" else name
    ref, port = ref_config(arch).reduced(), get_config(arch).reduced()
    if name.endswith("-tail"):
        ref = dataclasses.replace(ref, n_layers=5)
        port = dataclasses.replace(port, n_layers=5)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def _batch(vocab, seed=0, b=B, t=T_SEQ):
    """Tokens and labels (10 % masked), as numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, t)).astype(np.int32)
    labels = np.where(rng.random((b, t)) < 0.9, tokens, -1).astype(np.int32)
    return {"tokens": tokens, "labels": labels}


def _leaves(tree):
    """Leaves in ``jax.tree`` order (dict keys sorted), as numpy."""
    return [np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                       else x, np.float32) for x in _flatten(tree)[0]]


@functools.lru_cache(maxsize=None)
def _model(name):
    rcfg, cfg = _configs(name)
    jparams = RTF.init_params(jax.random.key(0), rcfg, dtype=jnp.float32)
    return rcfg, cfg, jparams


def _port_grads(cfg, params, batch, remat="full"):
    flat, spec = torch.utils._pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    loss_fn = LM.make_loss_fn(cfg, remat=remat, q_chunk=Q_CHUNK)
    total, metrics = loss_fn(torch.utils._pytree.tree_unflatten(leaves, spec),
                             batch)
    grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                materialize_grads=True)
    return total, metrics, torch.utils._pytree.tree_unflatten(list(grads),
                                                               spec)


# -- the loss ------------------------------------------------------------------

def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 640)).astype(np.float32)
    labels = rng.integers(0, 512, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    want, n_want = RLM.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got, n = LM.cross_entropy(torch.tensor(logits), torch.tensor(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=CE_TOL)
    assert float(n) == float(n_want) == 18.0
    # every label masked: n = max(valid, 1), the loss 0
    got, n = LM.cross_entropy(torch.tensor(logits),
                              torch.full((3, 7), -1, dtype=torch.int32))
    assert float(got) == 0.0 and float(n) == 1.0
    # the gradient, and none through the held-out row max
    x = torch.tensor(logits, requires_grad=True)
    g, = torch.autograd.grad(LM.cross_entropy(x, torch.tensor(labels))[0], x)
    gw = jax.grad(lambda z: RLM.cross_entropy(z, jnp.asarray(labels))[0])(
        jnp.asarray(logits))
    np.testing.assert_allclose(g.numpy(), np.asarray(gw), rtol=0, atol=CE_TOL)


# -- the recurrences' training route ----------------------------------------

@pytest.mark.parametrize("T,chunk,with_s0", [(37, 16, True), (64, 64, False),
                                             (5, 64, True)])
def test_rwkv_time_mix_chunked_matches_reference(T, chunk, with_s0):
    """Against the reference's chunked form and its step-by-step scan:
    outputs, final state and the gradients within 1e-4 (measured: 9e-6 at
    chunk 16, 4.3e-5 at chunk 64, where the reference's chunked form is
    4.3e-5 from its own scan)."""
    rng = np.random.default_rng(T)
    Bq, H, hd = 2, 3, 8
    r, k, v = (rng.normal(size=(Bq, T, H, hd)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.normal(size=(Bq, T, H, hd)) * 0.5 - 0.6).astype(
        np.float32)
    u = (rng.normal(size=(H, hd)) * 0.1).astype(np.float32)
    s0 = (rng.normal(size=(Bq, H, hd, hd)).astype(np.float32)
          if with_s0 else None)
    wo = rng.normal(size=(Bq, T, H, hd)).astype(np.float32)
    ws = rng.normal(size=(Bq, H, hd, hd)).astype(np.float32)

    def ref_obj(fn, *xs):
        o, s = fn(*xs)
        return jnp.sum(o * wo) + jnp.sum(s * ws), (o, s)

    args = [jnp.asarray(a) for a in (r, k, v, logw, u)]
    s0j = None if s0 is None else jnp.asarray(s0)
    (_, (ro, rs)), rg = jax.value_and_grad(
        lambda *xs: ref_obj(lambda *a: RRW.rwkv_time_mix_chunked(
            *a, s0=s0j, chunk=chunk), *xs), argnums=(0, 1, 2, 3, 4),
        has_aux=True)(*args)
    so, ss = RRW.rwkv_time_mix_scan(*args, s0=s0j)

    targs = [torch.tensor(a, requires_grad=True) for a in (r, k, v, logw, u)]
    o, s = RW.rwkv_time_mix_chunked(*targs, s0=None if s0 is None
                                    else torch.tensor(s0), chunk=chunk)
    grads = torch.autograd.grad(
        (o * torch.tensor(wo)).sum() + (s * torch.tensor(ws)).sum(), targs)
    for got, want in ((o, ro), (s, rs), (o, so), (s, ss)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=RWKV_TOL)
    for got, want in zip(grads, rg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=RWKV_TOL)


@pytest.mark.parametrize("T,chunk", [(1, 256), (13, 256), (40, 16)])
def test_rglru_chunked_scan_matches_reference(T, chunk):
    """``rglru_apply(chunked=True)`` against the reference's chunked
    associative scan: y, h_last and the gradients within 1e-5."""
    rng = np.random.default_rng(T)
    D = 16
    jp = RRG.init_rglru_params(jax.random.key(T), D, 4, jnp.float32)
    x = rng.normal(size=(2, T, D)).astype(np.float32)
    h0 = rng.normal(size=(2, D)).astype(np.float32)
    wy = rng.normal(size=(2, T, D)).astype(np.float32)

    def ref_obj(params, xx):
        y, h, _ = RRG.rglru_apply(xx, params, h0=jnp.asarray(h0), chunk=chunk)
        return jnp.sum(y * wy) + jnp.sum(h), (y, h)

    (_, (ry, rh)), (rgp, rgx) = jax.jit(jax.value_and_grad(
        ref_obj, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    p = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    p = {k_: t.requires_grad_() for k_, t in p.items()}
    xt = torch.tensor(x, requires_grad=True)
    y, h, _ = RG.rglru_apply(xt, p, h0=torch.tensor(h0), chunk=chunk,
                             chunked=True)
    keys = sorted(p)
    grads = torch.autograd.grad((y * torch.tensor(wy)).sum() + h.sum(),
                                [p[k_] for k_ in keys] + [xt])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry), rtol=0,
                               atol=SCAN_TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(rh), rtol=0,
                               atol=SCAN_TOL)
    for k_, g in zip(keys + ["x"], grads):
        want = rgx if k_ == "x" else rgp[k_]
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0,
                                   atol=GRAD_TOL, err_msg=k_)


def test_training_route_never_calls_the_kernel_wrappers(monkeypatch):
    """On the CPU the wrappers would run their plain versions, so the route
    is checked by making them raise: the loss (chunked) never reaches
    them, serving (``forward`` without ``chunked``) does."""
    calls = []

    def refuse(*a, **k):
        calls.append(1)
        raise AssertionError("the training route reached a B4/B5 wrapper")

    monkeypatch.setattr(WOPS, "rwkv6", refuse)
    monkeypatch.setattr(GOPS, "rglru_scan", refuse)
    for name in ("rwkv6-1.6b", "recurrentgemma-9b"):
        _, cfg, jparams = _model(name)
        params = params_from_reference(jax.tree.map(np.asarray, jparams),
                                       "cpu")
        batch = _batch(cfg.vocab_size)
        total, _, grads = _port_grads(cfg, params, batch)
        assert np.isfinite(float(total.detach()))
        with pytest.raises(AssertionError, match="B4/B5"):
            TF.forward(params, torch.tensor(batch["tokens"]), cfg)
    assert len(calls) == 2


# -- activation checkpointing --------------------------------------------------

@pytest.mark.parametrize("name,n_layers", [("qwen3-8b", 6), ("rwkv6-1.6b", 4),
                                           ("mixtral-8x22b", 2)])
def test_remat_modes_equal_none(name, n_layers):
    """"full", "2level" (6 and 4 blocks: groups of 2 and 3... of 2) and
    "dots" give the loss and gradients of "none", exactly on the CPU."""
    cfg = dataclasses.replace(get_config(name).reduced(), n_layers=n_layers)
    params = TF.init_params(cfg, generator=torch.Generator().manual_seed(2),
                            device="cpu")
    batch = _batch(cfg.vocab_size, seed=2)
    base_total, _, base = _port_grads(cfg, params, batch, remat="none")
    for remat in ("full", "2level", "dots"):
        total, _, grads = _port_grads(cfg, params, batch, remat=remat)
        assert torch.equal(total, base_total), remat
        for a, b in zip(_leaves(grads), _leaves(base)):
            np.testing.assert_array_equal(a, b, err_msg=remat)
    with pytest.raises(ValueError):
        TF.forward(params, torch.tensor(batch["tokens"]), cfg, remat="some")


def test_group_factor_matches_reference():
    for n in range(1, 50):
        assert TF._group_factor(n) == RTF._group_factor(n)


def test_init_train_state_and_abstract_shapes_match_reference():
    for name in ARCHS:
        rcfg, cfg = _configs(name)
        ropt = RAdamWConfig(state_dtype="bfloat16")
        opt = AdamWConfig(state_dtype="bfloat16")
        want = RLM.abstract_train_state(rcfg, ropt)
        got = LM.abstract_train_state(cfg, opt)
        assert all(t.device.type == "meta" for t in _flatten(got)[0])
        wl, gl = jax.tree.leaves(want), _flatten(got)[0]
        assert [tuple(w.shape) for w in wl] == [tuple(g.shape) for g in gl]
        assert [str(w.dtype) for w in wl] == [
            str(g.dtype).removeprefix("torch.") for g in gl]
        st = LM.init_train_state(cfg, opt,
                                 generator=torch.Generator().manual_seed(0),
                                 device="cpu", param_dtype=torch.float32)
        assert sorted(st) == ["m", "master", "params", "step", "v"]
        assert st["step"].dtype == torch.int32 and st["step"].dim() == 0


def test_public_inits_and_cache_lengths_match_reference():
    rcfg, cfg, _ = _model("mixtral-8x22b")
    g = torch.Generator().manual_seed(0)
    for ref_tree, tree in (
            (RTF.init_ffn(jax.random.key(0), rcfg, jnp.float32),
             TF.init_ffn(cfg, generator=g, device="cpu")),
            (RTF.init_attn(jax.random.key(0), rcfg, jnp.float32, cross=True),
             TF.init_attn(cfg, generator=g, device="cpu", cross=True)),
            (RTF.init_block(jax.random.key(0), rcfg, "attn_swa", jnp.float32),
             TF.init_block(cfg, "attn_swa", generator=g, device="cpu"))):
        assert jax.tree.map(np.shape, ref_tree) == jax.tree.map(
            lambda t: tuple(t.shape), tree)
    q = ref_config("qwen3-8b").reduced()
    qp = get_config("qwen3-8b").reduced()
    assert "q_norm" in TF.init_attn(qp, generator=g, device="cpu")
    assert jax.tree.map(np.shape, RTF.init_attn(
        jax.random.key(0), q, jnp.float32)) == jax.tree.map(
        lambda t: tuple(t.shape), TF.init_attn(qp, generator=g, device="cpu"))
    for name in ("mixtral-8x22b", "recurrentgemma-9b", "qwen3-8b"):
        rc, pc = ref_config(name).reduced(), get_config(name).reduced()
        for kind in ("attn", "attn_swa", "attn_local", "rglru", "rwkv"):
            assert TF.cfg_cache_len(pc, kind) == RTF.cfg_cache_len(rc, kind)
            for seq in (1, 8, 16, 100):
                assert TF.make_cache_len(pc, kind, seq) == \
                    RTF.make_cache_len(rc, kind, seq)


# -- twins of tests/test_arch_smoke.py -------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_forward_shapes_and_finite(name):
    _, cfg = _configs(name)
    params = TF.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = torch.tensor(_batch(cfg.vocab_size)["tokens"])
    logits, cache, aux = TF.forward(params, tokens, cfg, want_cache=True,
                                    q_chunk=Q_CHUNK)
    assert logits.shape == (B, T_SEQ, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()) and cache["pos"] == T_SEQ
    assert aux.dtype == torch.float32 and aux.dim() == 0


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_decreases_loss(name):
    _, cfg = _configs(name)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20)
    b = _batch(cfg.vocab_size)
    state = LM.init_train_state(cfg, opt,
                                generator=torch.Generator().manual_seed(0),
                                device="cpu", param_dtype=torch.float32)
    step = LM.make_train_step(cfg, opt, remat="full", q_chunk=Q_CHUNK)
    state, m0 = step(state, b)
    for _ in range(5):
        state, m = step(state, b)
    l0, l1 = float(m0["loss"]), float(m["loss"])
    assert np.isfinite(l0) and np.isfinite(l1)
    assert l1 < l0, f"{name}: loss did not decrease ({l0} -> {l1})"


# -- launch/train.py: the slice end to end ---------------------------------

class _Crash(Exception):
    pass


def _crash_after(n):
    def hook(step, metrics):
        if step + 1 == n:
            raise _Crash(step)
    return hook


def test_train_loop_restart_is_bitwise(tmp_path):
    """The port's own 5 straight steps against a run that crashes after
    step 3's checkpoint and restarts for the last 2, at the reference
    test's shape (reduced h2o-danube, batch 2, seq 32): every state leaf
    and loss equal.  (The reference's test runs ``steps=3`` and then
    ``steps=5``; its learning-rate schedule follows ``steps``, so its two
    runs train differently, which its NaN params hide.)"""
    _, cfg = _configs("h2o-danube-3-4b")
    kw = dict(steps=5, batch=2, seq=32, quiet=True, device="cpu")
    full, losses = T.train_loop(cfg, ckpt_base=str(tmp_path / "a" / "ck"),
                                ckpt_every=100, **kw)
    with pytest.raises(_Crash):
        T.train_loop(cfg, ckpt_base=str(tmp_path / "b" / "ck"),
                     ckpt_every=3, on_step=_crash_after(3), **kw)
    resumed, tail = T.train_loop(cfg, ckpt_base=str(tmp_path / "b" / "ck"),
                                 ckpt_every=100, **kw)
    assert np.isfinite(losses).all() and len(tail) == 2
    assert losses[3:] == tail
    for a, b in zip(_flatten(full)[0], _flatten(resumed)[0]):
        assert torch.equal(a, b)


def test_train_cli_needs_cuda_unless_device_cpu(capsys):
    if torch.cuda.is_available():  # pragma: no cover - CPU-only here
        pytest.skip("the card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.main(["--arch", "rwkv6-1.6b", "--reduced", "--steps", "1"])
    T.main(["--arch", "rwkv6-1.6b", "--reduced", "--steps", "2", "--batch",
            "2", "--seq", "16", "--device", "cpu"])
    assert "over 2 steps" in capsys.readouterr().out
