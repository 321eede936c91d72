"""The port's encoder-decoder stack and modality frontends against the
reference on the CPU: ``whisper-tiny`` (audio frames through the encoder,
cross-attention in every decoder block) and ``llava-next-34b`` (patch
embeddings projected and prepended), both ``.reduced()``.

The reference's ``init_params(jax.random.key(0), cfg)`` is carried across
with ``params_from_reference``, and both packages get the same numpy
tokens and frontend inputs from a seed.  Tolerances: the encoder and the
cross K/V 1e-5, logits and caches 1e-4, greedy tokens equal, the loss
1e-5 and every gradient leaf 1e-4, three train steps 1e-5.  Training runs
at 16 frames and a ``q_chunk`` that divides both the frames and the text,
because the reference's attention gradient is NaN at padded query rows
(ROADMAP §C).
"""
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
from repro.optim import AdamWConfig as RAdamWConfig  # noqa: E402
from repro_torch.ckpt.store import _flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as S  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.convert import (cache_from_reference,  # noqa: E402
                                        params_from_reference,
                                        train_state_from_reference)
from repro_torch.optim import AdamWConfig  # noqa: E402

ENC_TOL, MODEL_TOL = 1e-5, 1e-4
LOSS_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 1e-5
B, T_TEXT, Q_CHUNK, GEN = 2, 16, 8, 6
ARCHS = ["whisper-tiny", "llava-next-34b"]


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference config, port config, reference params, port params)."""
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    jparams = RTF.init_params(jax.random.key(0), rcfg, dtype=jnp.float32)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    return rcfg, cfg, jparams, params


def _inputs(cfg, seed=0, t=T_TEXT):
    """Tokens, labels (10 % masked) and the frontend input, as numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)
    labels = np.where(rng.random((B, t)) < 0.9, tokens, -1).astype(np.int32)
    n = cfg.encoder_seq if cfg.frontend == "audio" else cfg.n_frontend_tokens
    frontend = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "frontend": frontend}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def _assert_trees_close(got, want, tol, path="tree"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], tol, f"{path}[{k!r}]")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_close(g, w, tol, f"{path}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=path)


def _shapes(tree):
    """{path: (shape, dtype name)} of a jax or torch tree."""
    def leaf(x):
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k, sub in tree.items()
                for p, v in _shapes(sub).items()}
    if isinstance(tree, list):
        return {f"{i}/{p}": v for i, sub in enumerate(tree)
                for p, v in _shapes(sub).items()}
    return {"": leaf(tree)}


def _leaves(tree):
    """Leaves in ``jax.tree`` order (dict keys sorted), as numpy."""
    return [np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                       else x, np.float32) for x in _flatten(tree)[0]]


def _close_leaves(got, want, tol, what):
    got, want = _leaves(got), [np.asarray(x, np.float32)
                                for x in jax.tree.leaves(want)]
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (what, i)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                   err_msg=f"{what} leaf {i}")


# -- trees ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_trees_match_reference(arch):
    """``init_params``, ``abstract_params`` and ``init_cache``: the
    reference's keys, shapes and dtypes (``frontend_proj``, ``encoder``,
    ``enc_norm``, ``normx``, ``xattn`` without qk norms, ``cache["enc"]``
    stacked over the encoder's layers)."""
    rcfg, cfg, jparams, _ = _model(arch)
    g = torch.Generator().manual_seed(0)
    assert _shapes(TF.init_params(cfg, generator=g, device="cpu")) == \
        _shapes(jparams)
    assert _shapes(TF.abstract_params(cfg)) == _shapes(
        RTF.abstract_params(rcfg))
    want = RTF.init_cache(rcfg, 3, 40, dtype=jnp.float32)
    got = TF.init_cache(cfg, 3, 40, device="cpu")
    assert got["pos"] == 0
    assert _shapes({k: v for k, v in got.items() if k != "pos"}) == _shapes(
        {k: v for k, v in want.items() if k != "pos"})
    assert ("enc" in got) == cfg.is_encdec
    assert ("frontend_proj" in jparams) and (
        ("encoder" in jparams) == cfg.is_encdec)


# -- the encoder, forward ----------------------------------------------------

def test_encode_and_cross_cache_match_reference():
    rcfg, cfg, jparams, params = _model("whisper-tiny")
    frames = _inputs(cfg)["frontend"]
    want = RTF.encode(jparams, jnp.asarray(frames), rcfg, q_chunk=Q_CHUNK)
    got = TF.encode(params, torch.tensor(frames), cfg, q_chunk=Q_CHUNK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ENC_TOL)
    assert got.shape == (B, cfg.encoder_seq, cfg.d_model)
    want_kv = RTF._enc_cross_cache(jparams, want, rcfg)
    got_kv = TF._enc_cross_cache(params, got, cfg)
    _assert_trees_close(_numpy(got_kv), _numpy(want_kv), ENC_TOL, "enc")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_caches_match_reference(arch):
    rcfg, cfg, jparams, params = _model(arch)
    x = _inputs(cfg, seed=1)
    want_logits, want_cache, _ = RTF.forward(
        jparams, jnp.asarray(x["tokens"]), rcfg,
        frontend_embeds=jnp.asarray(x["frontend"]), want_cache=True,
        q_chunk=Q_CHUNK)
    logits, cache, _ = TF.forward(
        params, torch.tensor(x["tokens"]), cfg,
        frontend_embeds=torch.tensor(x["frontend"]), want_cache=True,
        q_chunk=Q_CHUNK)
    T = T_TEXT + (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
    assert logits.shape == (B, T, cfg.padded_vocab) and cache["pos"] == T
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=MODEL_TOL)
    assert ("enc" in cache) == cfg.is_encdec
    _assert_trees_close(_numpy({k: v for k, v in cache.items()}),
                        _numpy(want_cache), MODEL_TOL, "cache")


def test_audio_forward_without_frames_skips_cross_attention():
    """No frames: the decoder runs without its cross-attention and the
    cache has no ``enc``, as in the reference."""
    rcfg, cfg, jparams, params = _model("whisper-tiny")
    tokens = _inputs(cfg, seed=2)["tokens"]
    want, want_cache, _ = RTF.forward(jparams, jnp.asarray(tokens), rcfg,
                                      want_cache=True, q_chunk=Q_CHUNK)
    got, cache, _ = TF.forward(params, torch.tensor(tokens), cfg,
                               want_cache=True, q_chunk=Q_CHUNK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MODEL_TOL)
    assert "enc" not in cache and "enc" not in want_cache


# -- serving ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_greedy_decode_matches_reference(arch):
    """The twin of ``test_arch_smoke.py::test_prefill_then_decode`` held to
    the reference: ``generate``'s prefill (with the frontend input) and
    greedy decode give the reference loop's tokens and prefill logits
    within 1e-4; one more step from the reference's own cache
    (``cache_from_reference``, ``enc`` included) matches its next step,
    and ``enc`` comes through it unchanged."""
    rcfg, cfg, jparams, params = _model(arch)
    x = _inputs(cfg, seed=3)
    batch = {"tokens": jnp.asarray(x["tokens"]),
             "frontend": jnp.asarray(x["frontend"])}
    prefill = jax.jit(RLM.make_prefill_step(rcfg, q_chunk=T_TEXT))
    decode = jax.jit(RLM.make_decode_step(rcfg))
    rcache, last = prefill(jparams, batch)
    tok = jnp.argmax(last[:, :rcfg.vocab_size], -1).astype(jnp.int32)[:, None]
    want = [np.asarray(tok)]
    for _ in range(GEN - 1):
        tok, rcache = decode(jparams, rcache, tok, jax.random.key(0))
        want.append(np.asarray(tok))
    want = np.concatenate(want, axis=1)
    run = S.generate(params, torch.tensor(x["tokens"]), cfg, gen=GEN,
                     frontend=torch.tensor(x["frontend"]))
    np.testing.assert_array_equal(run["tokens"], want)
    np.testing.assert_allclose(run["logits"].numpy(), np.asarray(last),
                               rtol=0, atol=MODEL_TOL)
    cache = cache_from_reference(_numpy(rcache), "cpu")
    enc = {k: v.clone() for k, v in cache.get("enc", {}).items()}
    got_tok, cache = LM.make_decode_step(cfg)(params, cache,
                                              torch.tensor(want[:, -1:]))
    want_tok, rnext = decode(jparams, rcache, jnp.asarray(want[:, -1:]),
                             jax.random.key(0))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    got = _numpy({k: v for k, v in cache.items() if k != "pos"})
    _assert_trees_close(got, _numpy({k: v for k, v in rnext.items()
                                     if k != "pos"}), MODEL_TOL, "cache")
    assert cache["pos"] == int(rnext["pos"])
    for k, v in enc.items():
        assert torch.equal(cache["enc"][k], v)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_forward(arch):
    """After a one-token prefill (the frontend input with it), decoding
    the rest of the text token by token gives ``forward``'s logits: the
    check ``chip_smoke.py`` ``[encdec]`` makes on the card, here at 1e-4."""
    _, cfg, _, params = _model(arch)
    x = _inputs(cfg, seed=4)
    tokens, fe = torch.tensor(x["tokens"]), torch.tensor(x["frontend"])
    logits, _, _ = TF.forward(params, tokens, cfg, frontend_embeds=fe,
                              q_chunk=Q_CHUNK)
    _, pre, _ = TF.forward(params, tokens[:, :1], cfg, frontend_embeds=fe,
                           want_cache=True, q_chunk=1)
    T0 = pre["pos"]
    cache = TF.init_cache(cfg, B, T0 + T_TEXT - 1, device="cpu")
    for sn, c in pre["blocks"].items():
        for k in c:
            cache["blocks"][sn][k][:, :, :T0] = c[k]
    if "enc" in pre:
        cache["enc"] = pre["enc"]
    cache["pos"] = T0
    steps = []
    for t in range(1, T_TEXT):
        lg, cache = TF.decode_step(params, cache, tokens[:, t:t + 1], cfg)
        steps.append(lg)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(),
                               logits[:, T0:].numpy(), rtol=0,
                               atol=MODEL_TOL)


def test_serve_lm_cli_runs_whisper_on_the_cpu(capsys):
    S.main(["lm", "--arch", "whisper-tiny", "--reduced", "--batch", "2",
            "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    assert "[serve] sample output ids" in capsys.readouterr().out


# -- training ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    rcfg, cfg, jparams, params = _model(arch)
    batch = _inputs(cfg, seed=5)
    loss_fn = RLM.make_loss_fn(rcfg, remat="full", q_chunk=Q_CHUNK)
    (rtotal, rm), rgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jparams, jax.tree.map(jnp.asarray, batch))
    flat, spec = torch.utils._pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    total, m = LM.make_loss_fn(cfg, remat="full", q_chunk=Q_CHUNK)(
        torch.utils._pytree.tree_unflatten(leaves, spec), batch)
    grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(total.detach()), float(rtotal), rtol=0,
                               atol=LOSS_TOL)
    for k in ("loss", "aux", "n_tokens"):
        np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=0,
                                   atol=LOSS_TOL, err_msg=k)
    grads = torch.utils._pytree.tree_unflatten(list(grads), spec)
    _close_leaves(grads, rgrads, GRAD_TOL, arch)
    # every leaf learns, the frontend's, the encoder's and the
    # cross-attention's among them (assert_allclose takes NaN as equal)
    for i, g in enumerate(_leaves(grads)):
        assert np.isfinite(g).all() and np.abs(g).max() > 0, i


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    """Three steps of ``make_train_step`` from one carried-over state:
    params, master, m, v, step and the metrics within 1e-5."""
    rcfg, cfg, _, _ = _model(arch)
    ropt = RAdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20)
    rstate = RLM.init_train_state(jax.random.key(0), rcfg, ropt,
                                  param_dtype=jnp.float32)
    state = train_state_from_reference(jax.tree.map(np.asarray, rstate),
                                       "cpu")
    rstep = jax.jit(RLM.make_train_step(rcfg, ropt, remat="full",
                                        q_chunk=Q_CHUNK))
    step = LM.make_train_step(cfg, opt, remat="full", q_chunk=Q_CHUNK)
    for s in range(3):
        b = _inputs(cfg, seed=10 + s)
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, b)
        for k in ("loss", "aux", "n_tokens"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=0,
                                       atol=STEP_TOL, err_msg=k)
    assert int(state["step"]) == 3
    assert all(np.isfinite(a).all() for a in _leaves(state))
    _close_leaves(state, rstate, STEP_TOL, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_decreases_loss(arch):
    """The twin of ``test_arch_smoke.py::test_train_step_decreases_loss``
    on the port: six steps on one batch lower the loss."""
    _, cfg, _, _ = _model(arch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20)
    state = LM.init_train_state(cfg, opt,
                                generator=torch.Generator().manual_seed(0),
                                device="cpu", param_dtype=torch.float32)
    step = LM.make_train_step(cfg, opt, remat="full", q_chunk=Q_CHUNK)
    b = _inputs(cfg, seed=6)
    losses = []
    for _ in range(6):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
