"""The port's loss and its gradient against the reference's on the CPU,
for the reduced config of every arch the port trains: qwen3, granite, phi4,
h2o-danube (sliding window), recurrentgemma at 5 layers (one scanned
(rglru, rglru, attn_local) block and an (rglru, rglru) tail), rwkv6,
mixtral and dbrx (MoE, with their load-balance aux).  The reference's
``init_params(jax.random.key(0), cfg)`` is carried across with
``params_from_reference``; the port's loss takes the recurrences'
differentiable training route.  The loss and its metrics are held to 1e-5,
every gradient leaf to 1e-4.  Each reference loss compiles once (the
costly part), so each arch is one case.
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
from repro.models import transformer as RTF  # noqa: E402
from repro_torch.ckpt.store import _flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
B, T_SEQ, Q_CHUNK = 2, 32, 8
ARCHS = ["qwen3-8b", "granite-20b", "phi4-mini-3.8b", "h2o-danube-3-4b",
         "recurrentgemma-tail", "rwkv6-1.6b", "mixtral-8x22b", "dbrx-132b"]


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


def _close(got, want, tol, what=""):
    got, want = _leaves(got), [np.asarray(x, np.float32)
                                for x in jax.tree.leaves(want)]
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (what, i)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                   err_msg=f"{what} leaf {i}")


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


# -- the loss and its gradient, every arch -----------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_gradients_match_reference(name):
    rcfg, cfg, jparams = _model(name)
    batch = _batch(cfg.vocab_size, seed=1)
    loss_fn = RLM.make_loss_fn(rcfg, remat="full", q_chunk=Q_CHUNK)
    (rtotal, rm), rgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    params = params_from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    total, m, grads = _port_grads(cfg, params, batch)
    np.testing.assert_allclose(float(total), float(rtotal), rtol=0,
                               atol=LOSS_TOL)
    for k in ("loss", "aux", "n_tokens"):
        np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=0,
                                   atol=LOSS_TOL, err_msg=k)
    if cfg.moe is not None:
        assert float(m["aux"]) > 0.0
    _close(grads, rgrads, GRAD_TOL, name)
