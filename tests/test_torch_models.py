"""The port's model substrate and ``serve lm`` path against the reference on
the CPU, on the reference's own weights.

The reference's ``init_params(jax.random.key(0), cfg)`` is carried across
with ``params_from_reference``, so both packages run the same weights on
the same numpy prompts: ``rwkv6-1.6b`` and ``recurrentgemma-9b`` reduced,
and ``recurrentgemma-9b`` reduced at 8 layers (tail ``('rglru',
'rglru')``).  The port runs its recurrences step by step (the kernels'
plain versions); the reference prefills RWKV in its chunked form and the
RG-LRU with an associative scan.  The two agree to about 4e-6 in the
logits, so logits and caches are held to 1e-4 and greedy tokens must be
equal; layer functions that share their arithmetic are held to 1e-6.
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
from repro.models import layers as RL  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.models import rglru as RRG  # noqa: E402
from repro.models import rwkv as RRW  # noqa: E402
from repro.models import transformer as RTF  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as GK  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as WK  # noqa: E402
from repro_torch.launch import serve as S  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import rglru as RG  # noqa: E402
from repro_torch.models import rwkv as RW  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.convert import (cache_from_reference,  # noqa: E402
                                        params_from_reference)
from repro_torch.models.lm import make_decode_step  # noqa: E402

MODEL_TOL, LAYER_TOL = 1e-4, 1e-6
B, GEN = 4, 9  # the prefill's token and 8 decode steps
CONFIGS = ["rwkv6", "recurrentgemma", "recurrentgemma-tail"]


def _configs(name):
    """(reference config, port config) of one test model."""
    arch = {"rwkv6": "rwkv6-1.6b"}.get(name, "recurrentgemma-9b")
    ref, port = ref_config(arch).reduced(), get_config(arch).reduced()
    if name.endswith("-tail"):
        ref = dataclasses.replace(ref, n_layers=8)
        port = dataclasses.replace(port, n_layers=8)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


@functools.lru_cache(maxsize=None)
def _model(name):
    """The reference's weights, as jnp and carried into the port, and the
    reference's jitted serving steps."""
    rcfg, cfg = _configs(name)
    jparams = RTF.init_params(jax.random.key(0), rcfg, dtype=jnp.float32)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    decode = jax.jit(RLM.make_decode_step(rcfg))
    return rcfg, cfg, jparams, params, decode


def _prompts(T, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return np.asarray(tree)


def _assert_trees_close(got, want, tol, path="cache"):
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


def _port_cache(cache):
    out = _numpy({k: v for k, v in cache.items() if k != "pos"})
    out["pos"] = np.asarray(cache["pos"])
    return out


def _ref_generate(rcfg, jparams, prompts, decode, gen=GEN):
    """The reference's serving loop: prefill, then greedy decode."""
    T = prompts.shape[1]
    prefill = jax.jit(RLM.make_prefill_step(rcfg, q_chunk=min(64, T)))
    cache, last = prefill(jparams, {"tokens": jnp.asarray(prompts)})
    tok = jnp.argmax(last[:, :rcfg.vocab_size], -1).astype(jnp.int32)[:, None]
    out = [np.asarray(tok)]
    key = jax.random.key(0)
    for _ in range(gen - 1):
        tok, cache = decode(jparams, cache, tok, key)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1), np.asarray(last), cache


# -- the whole stack ------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_forward_logits_and_caches_match_reference(name):
    rcfg, cfg, jparams, params, _ = _model(name)
    tokens = _prompts(32, cfg.vocab_size, seed=1)
    want_logits, want_cache, _ = jax.jit(
        functools.partial(RTF.forward, cfg=rcfg, want_cache=True,
                          q_chunk=16))(jparams, jnp.asarray(tokens))
    logits, cache, _ = TF.forward(params, torch.tensor(tokens), cfg,
                                  want_cache=True, q_chunk=16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=MODEL_TOL)
    _assert_trees_close(_port_cache(cache), _numpy(want_cache), MODEL_TOL)
    kinds = {k.split("_", 1)[1] for k in cache["blocks"]}
    assert kinds == set(cfg.block_pattern)


@pytest.mark.parametrize("T", [32, 100])
@pytest.mark.parametrize("name", CONFIGS)
def test_greedy_serving_matches_reference(name, T):
    """Prefill plus 8 greedy decode steps: equal tokens, prefill logits and
    the decode cache after the last step within 1e-4.  T = 100 crosses the
    reference's RWKV chunk of 64 and wraps the local-attention ring."""
    rcfg, cfg, jparams, params, decode = _model(name)
    prompts = _prompts(T, cfg.vocab_size)
    want_toks, want_last, want_cache = _ref_generate(rcfg, jparams, prompts,
                                                     decode)
    run = S.generate(params, torch.tensor(prompts), cfg, gen=GEN)
    np.testing.assert_array_equal(run["tokens"], want_toks)
    np.testing.assert_allclose(run["logits"].numpy(), want_last, rtol=0,
                               atol=MODEL_TOL)
    # the port's decode cache, stepped once more from the reference's
    # cache, against the reference's next step
    cache = cache_from_reference(_numpy(want_cache), "cpu")
    tok = torch.tensor(want_toks[:, -1:])
    got_tok, cache = make_decode_step(cfg)(params, cache, tok)
    want_tok, want_next = decode(jparams, want_cache,
                                 jnp.asarray(want_toks[:, -1:]),
                                 jax.random.key(0))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    _assert_trees_close(_port_cache(cache), _numpy(want_next), MODEL_TOL)


def test_serve_entry_point_returns_reference_tokens(capsys):
    """``serve(..., device="cpu", prompts=...)`` against the reference
    pipeline run on the port's own seeded weights."""
    rcfg, cfg = _configs("recurrentgemma-tail")
    prompts = _prompts(24, cfg.vocab_size, seed=3)
    before = (GK.LAUNCHES.total(), WK.LAUNCHES.total())
    toks = S.serve(cfg, batch=B, prompt_len=24, gen=6, seed=5, device="cpu",
                   prompts=prompts)
    assert (GK.LAUNCHES.total(), WK.LAUNCHES.total()) == before
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines] == [["[serve]", "prefill"],
                                                ["[serve]", "sample"]]
    params, _, _ = S.draw(cfg, batch=B, prompt_len=24, seed=5, device="cpu")
    jparams = jax.tree.map(jnp.asarray, _numpy(params))
    want, _, _ = _ref_generate(rcfg, jparams, prompts,
                               jax.jit(RLM.make_decode_step(rcfg)), gen=6)
    assert toks.dtype == np.int32 and toks.shape == (B, 6)
    np.testing.assert_array_equal(toks, want)


def test_draws_are_seeded_and_stacked():
    _, cfg = _configs("recurrentgemma-tail")
    p1, t1, f1 = S.draw(cfg, batch=2, prompt_len=5, seed=11, device="cpu")
    p2, t2, _ = S.draw(cfg, batch=2, prompt_len=5, seed=11, device="cpu")
    assert torch.equal(t1, t2) and f1 is None  # no frontend
    assert torch.equal(p1["blocks"]["b0_rglru"]["wx"],
                       p2["blocks"]["b0_rglru"]["wx"])
    n_full = cfg.n_layers // len(cfg.block_pattern)
    assert p1["blocks"]["b2_attn_local"]["wq"].shape == (
        n_full, cfg.d_model, cfg.n_heads_c * cfg.head_dim_)
    assert [sorted(t) for t in p1["tail"]] == [sorted(p1["blocks"]["b0_rglru"])] * 2
    assert float(p1["blocks"]["b0_rglru"]["lambda"].min()) >= 0.3


def test_init_cache_matches_reference_layout():
    rcfg, cfg = _configs("recurrentgemma-tail")
    want = _numpy(RTF.init_cache(rcfg, 3, 40, dtype=jnp.float32))
    got = _port_cache(TF.init_cache(cfg, 3, 40, device="cpu"))
    _assert_trees_close(got, want, 0.0)


def test_sampled_decode_is_seeded_and_in_vocab():
    _, cfg, _, params, _ = _model("rwkv6")
    prompts = torch.tensor(_prompts(8, cfg.vocab_size))
    step = make_decode_step(cfg, greedy=False)
    toks = []
    for _ in range(2):
        _, cache, _ = TF.forward(params, prompts, cfg, want_cache=True)
        g = torch.Generator().manual_seed(3)
        toks.append(step(params, cache, prompts[:, -1:], g)[0])
    assert torch.equal(toks[0], toks[1]) and toks[0].shape == (B, 1)
    assert bool(((toks[0] >= 0) & (toks[0] < cfg.vocab_size)).all())
    with pytest.raises(ValueError, match="generator"):
        step(params, cache, prompts[:, -1:])


def test_serve_without_cuda_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda:0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.serve(_configs("rwkv6")[1], batch=1, prompt_len=2, gen=1)


def test_serve_lm_cli_runs_on_the_cpu(capsys):
    S.main(["lm", "--arch", "rwkv6-1.6b", "--reduced", "--batch", "2",
            "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    assert "[serve] sample output ids" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "whisper-tiny",
                                  "llava-next-34b"])
def test_unported_families_raise(arch):
    """The families the port once refused (MoE until the training slice,
    the encoder-decoder stack and the frontends until theirs) now draw
    and serve on the CPU: tokens of the batch's shape, in the vocabulary;
    the frontend input is drawn with the prompts."""
    cfg = get_config(arch).reduced()
    g = torch.Generator().manual_seed(0)
    TF.init_params(cfg, generator=g, device="cpu")
    _, _, frontend = S.draw(cfg, batch=1, prompt_len=4, seed=0, device="cpu")
    assert (frontend is None) == (cfg.frontend is None)
    toks = S.serve(cfg, batch=1, prompt_len=4, gen=2, device="cpu",
                   quiet=True)
    assert toks.shape == (1, 2)
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()


# -- layer functions ------------------------------------------------------------

def _t(x):
    return torch.tensor(np.asarray(x))


def _layer_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LAYER_TOL)


def test_rms_norm_and_rope_match_reference(rng):
    x = rng.standard_normal((2, 7, 3, 32), dtype=np.float32)
    scale = rng.standard_normal(32, dtype=np.float32) * 0.1
    _layer_close(L.rms_norm(_t(x), _t(scale)),
                 RL.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    pos = np.arange(7, dtype=np.int32)[None].repeat(2, 0) + 3
    _layer_close(L.apply_rope(_t(x), _t(pos), 10000.0),
                 RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    bias = rng.standard_normal(32, dtype=np.float32)
    _layer_close(L.layer_norm(_t(x), _t(scale), _t(bias)),
                 RL.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                               jnp.asarray(bias)))
    w1 = rng.standard_normal((32, 48), dtype=np.float32) * 0.1
    w2 = rng.standard_normal((48, 32), dtype=np.float32) * 0.1
    w3 = rng.standard_normal((32, 48), dtype=np.float32) * 0.1
    _layer_close(L.swiglu(_t(x), _t(w1), _t(w3), _t(w2)),
                 RL.swiglu(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w3),
                           jnp.asarray(w2)))
    _layer_close(L.sq_relu_mlp(_t(x), _t(w1), _t(w2)),
                 RL.sq_relu_mlp(jnp.asarray(x), jnp.asarray(w1),
                                jnp.asarray(w2)))


@pytest.mark.parametrize("window,q_chunk", [(None, 16), (5, 4), (16, 7)])
def test_attention_matches_reference(rng, window, q_chunk):
    q = rng.standard_normal((2, 19, 4, 16), dtype=np.float32)
    k, v = (rng.standard_normal((2, 19, 4, 16), dtype=np.float32)
            for _ in range(2))
    got = L.attention(_t(q), _t(k), _t(v), window=window, q_chunk=q_chunk)
    want = RL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        window=window, q_chunk=q_chunk)
    _layer_close(got, want)


@pytest.mark.parametrize("pos", [1, 9, 16, 23, 40])
def test_decode_attention_matches_reference(rng, pos):
    """A 16-slot ring, written and wrapped."""
    q = rng.standard_normal((2, 1, 4, 16), dtype=np.float32)
    k, v = (rng.standard_normal((2, 16, 4, 16), dtype=np.float32)
            for _ in range(2))
    got = L.decode_attention(_t(q), _t(k), _t(v), pos, window=8)
    want = RL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.int32(pos), window=8)
    _layer_close(got, want)
    np.testing.assert_array_equal(L.ring_positions(pos, 16).numpy(),
                                  np.asarray(RL.ring_positions(
                                      jnp.int32(pos), 16)))


def test_rwkv_layer_functions_match_reference(rng):
    # outputs of order 1, where 1e-6 is a few float32 ulps (the two norms
    # round their rsqrt differently in the last place)
    o = rng.standard_normal((2, 5, 3, 16), dtype=np.float32)
    scale = rng.standard_normal(48, dtype=np.float32) * 0.25
    _layer_close(RW.group_norm_heads(_t(o), _t(scale)),
                 RRW.group_norm_heads(jnp.asarray(o), jnp.asarray(scale)))
    x = rng.standard_normal((2, 5, 48), dtype=np.float32)
    prev = rng.standard_normal((2, 48), dtype=np.float32)
    _layer_close(RW.token_shift(_t(x), _t(prev)),
                 RRW.token_shift(jnp.asarray(x), jnp.asarray(prev)))
    # the step-by-step oracle sums each readout in another order: 1e-4
    r, k, v = (rng.standard_normal((2, 5, 3, 16), dtype=np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((2, 5, 3, 16), dtype=np.float32))
    u = rng.standard_normal((3, 16), dtype=np.float32) * 0.1
    got = RW.rwkv_time_mix_scan(*map(_t, (r, k, v, logw, u)))
    want = RRW.rwkv_time_mix_scan(*map(jnp.asarray, (r, k, v, logw, u)))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=0,
                                   atol=MODEL_TOL)


def test_rglru_layer_functions_match_reference(rng):
    x = rng.standard_normal((2, 6, 40), dtype=np.float32)
    w = rng.standard_normal((4, 40), dtype=np.float32) * 0.1
    state = rng.standard_normal((2, 3, 40), dtype=np.float32)
    for st in (None, state):
        got = RG.causal_conv1d(_t(x), _t(w), None if st is None else _t(st))
        want = RRG.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                 None if st is None else jnp.asarray(st))
        for g, wv in zip(got, want):
            _layer_close(g, wv)
    p = {"gate_a_w": rng.standard_normal(40, dtype=np.float32),
         "gate_a_b": rng.standard_normal(40, dtype=np.float32),
         "gate_i_w": rng.standard_normal(40, dtype=np.float32),
         "gate_i_b": rng.standard_normal(40, dtype=np.float32),
         "lambda": rng.uniform(0.3, 0.8, 40).astype(np.float32)}
    got = RG._gates(_t(x), {k: _t(v) for k, v in p.items()})
    want = RRG._gates(jnp.asarray(x), {k: jnp.asarray(v)
                                       for k, v in p.items()})
    for g, wv in zip(got, want):
        _layer_close(g, wv)
