"""The port's single-device MoE (``models/moe.py``) against the reference's
on the CPU, on the same numpy inputs and the reference's own weights.

Routing is discrete, so ``router_topk``'s choices, ``local_capacity`` and
``dispatch_indices`` are held bitwise; the router weights within 1e-6; the
FFN output, its aux loss and their gradients within 1e-5.  The mixtral and
dbrx configs, refused before this slice, now run the port's forward and
decode: prefill logits within 1e-4 of the reference's, and decode equal to
the forward at a no-drop capacity (the twin of ``test_arch_smoke.py``'s
``test_decode_matches_forward``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import MoEConfig as RMoEConfig  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models import transformer as RTF  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

W_TOL, FFN_TOL, MODEL_TOL = 1e-6, 1e-5, 1e-4
MOES = [(4, 2, 1.25), (8, 2, 1.0), (4, 1, 2.0)]


def _inputs(E, seed=0, N=48, D=16, F=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, N // 2, D)).astype(np.float32)
    p = RM.init_moe_params(jax.random.key(seed), D, F,
                           RMoEConfig(E, 2), jnp.float32)
    return x, jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("E,k,cf", MOES)
def test_routing_and_dispatch_match_reference(E, k, cf):
    x, p = _inputs(E, seed=E + k)
    x2d = x.reshape(-1, x.shape[-1])
    ridx, rw, (rme, rce, rcnt) = RM.router_topk(
        jnp.asarray(x2d), jnp.asarray(p["router"]), RMoEConfig(E, k, cf))
    idx, w, (me, ce, cnt) = M.router_topk(
        torch.tensor(x2d), torch.tensor(p["router"]), MoEConfig(E, k, cf))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=0, atol=W_TOL)
    np.testing.assert_allclose(me.numpy(), np.asarray(rme), rtol=0,
                               atol=W_TOL * 10)
    np.testing.assert_array_equal(ce.numpy(), np.asarray(rce))
    assert float(cnt) == float(rcnt)
    for n in (1, 7, 48, 1000, 16384):
        assert M.local_capacity(n, MoEConfig(E, k, cf)) == \
            RM.local_capacity(n, RMoEConfig(E, k, cf))
    C = M.local_capacity(x2d.shape[0], MoEConfig(E, k, cf))
    for C_ in (C, 8):  # the configured capacity, and one that drops
        want = RM.dispatch_indices(ridx, E, C_)
        got = M.dispatch_indices(idx, E, C_)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("E,k,cf", MOES)
def test_moe_ffn_and_gradients_match_reference(E, k, cf):
    x, p = _inputs(E, seed=10 + E + k)
    wy = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def ref_obj(params, xx):
        y, aux = RM.moe_ffn(xx, params, RMoEConfig(E, k, cf))
        return jnp.sum(y * wy) + 3.0 * aux, (y, aux)

    (_, (ry, raux)), (rgp, rgx) = jax.jit(jax.value_and_grad(
        ref_obj, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k_: torch.tensor(v, requires_grad=True) for k_, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = M.moe_ffn(tx, tp, MoEConfig(E, k, cf))
    keys = sorted(tp)
    grads = torch.autograd.grad((y * torch.tensor(wy)).sum() + 3.0 * aux,
                                [tp[k_] for k_ in keys] + [tx])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry), rtol=0,
                               atol=FFN_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(raux), rtol=0,
                               atol=FFN_TOL)
    for k_, g in zip(keys + ["x"], grads):
        want = rgx if k_ == "x" else rgp[k_]
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0,
                                   atol=FFN_TOL, err_msg=k_)


def test_token_chunked_dispatch_matches_reference(monkeypatch):
    """Past ``TOKEN_CHUNK`` tokens the FFN dispatches a chunk at a time and
    averages the aux, as the reference (the cap cut to 16 in both)."""
    monkeypatch.setattr(RM, "TOKEN_CHUNK", 16)
    monkeypatch.setattr(M, "TOKEN_CHUNK", 16)
    x, p = _inputs(4, seed=3)
    ry, raux = RM.moe_ffn_local(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                                RMoEConfig(4, 2))
    y, aux = M.moe_ffn_local(torch.tensor(x),
                             {k_: torch.tensor(v) for k_, v in p.items()},
                             MoEConfig(4, 2))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=0,
                               atol=FFN_TOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=0, atol=FFN_TOL)


def test_init_moe_params_shapes_match_reference():
    moe = MoEConfig(8, 2)
    got = M.init_moe_params(32, 48, moe, generator=torch.Generator(),
                            device="cpu", dtype=torch.bfloat16, n=3)
    want = RM.init_moe_params(jax.random.key(0), 32, 48, RMoEConfig(8, 2),
                              jnp.bfloat16)
    for k_ in want:
        assert tuple(got[k_].shape) == (3,) + want[k_].shape
        assert str(got[k_].dtype).removeprefix("torch.") == str(
            want[k_].dtype)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dbrx-132b"])
def test_moe_models_prefill_and_decode(arch):
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    TF.abstract_params(cfg)  # MoE is no longer refused
    jparams = RTF.init_params(jax.random.key(0), rcfg, dtype=jnp.float32)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                               (2, 16)).astype(np.int32)
    rlogits, _, raux = RTF.forward(jparams, jnp.asarray(tokens), rcfg,
                                   q_chunk=8)
    logits, _, aux = TF.forward(params, torch.tensor(tokens), cfg, q_chunk=8)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), rtol=0,
                               atol=MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=0,
                               atol=FFN_TOL)
    # decode equals the forward at a capacity that drops nothing
    cfg8 = dataclasses.replace(cfg, moe=MoEConfig(cfg.moe.n_experts,
                                                  cfg.moe.top_k, 8.0))
    full, _, _ = TF.forward(params, torch.tensor(tokens[:1, :12]), cfg8,
                            q_chunk=4)
    cache = TF.init_cache(cfg8, 1, 12, device="cpu")
    outs = []
    for t in range(12):
        lg, cache = TF.decode_step(params, cache,
                                   torch.tensor(tokens[:1, t:t + 1]), cfg8)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)
