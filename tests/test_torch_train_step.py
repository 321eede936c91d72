"""The port's train step and ``launch/train.py`` against the reference's
on the CPU, from one carried-over state (``train_state_from_reference``).

Three steps of ``make_train_step`` (plain, two microbatches, and int8
gradient compression with two microbatches) are held to the reference's
jitted step: params, master, m, v, step and the metrics within 1e-5.  Then
the slice end to end: the reference's ``train_loop`` commits step 3 and
the port's resumes that same file, matching the reference's own resumed
run within 1e-5.

The reference's query padding makes its attention gradient NaN when the
sequence is not a multiple of ``q_chunk`` (``o / max(l, 1e-30)``
differentiates through ``1e-30 ** 2``, which underflows to 0, in padded
rows whose upstream gradient is 0): ``train_loop``'s ``q_chunk=64`` at its
own test's seq 32 gives NaN params from the first step.  The interchange
therefore runs at seq 64; ``test_torch_train.py`` checks the port at seq
32 on its own.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.data import pipeline as RP  # noqa: E402
from repro.launch import train as RT  # noqa: E402
from repro.models import lm as RLM  # noqa: E402
from repro.optim import AdamWConfig as RAdamWConfig  # noqa: E402
from repro.optim.compression import Int8Compressor as RInt8  # noqa: E402
from repro_torch.ckpt.store import _flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models.convert import train_state_from_reference  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim.compression import Int8Compressor  # noqa: E402

STEP_TOL = 1e-5
T_SEQ, Q_CHUNK = 32, 8


def _configs(name):
    ref, port = ref_config(name).reduced(), get_config(name).reduced()
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


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


# -- the train step --------------------------------------------------------------

@pytest.mark.parametrize("name,microbatches,compress", [
    ("qwen3-8b", 1, False), ("qwen3-8b", 2, False), ("rwkv6-1.6b", 2, True)])
def test_train_steps_match_reference(name, microbatches, compress):
    """Three steps of ``make_train_step`` from one carried-over state:
    params, master, m, v and step within 1e-5, metrics within 1e-5.  With
    int8 compression a gradient that lies within float rounding of a code's
    half-step rounds to neighbouring codes in the two packages (the codes
    themselves are bitwise on equal inputs: ``test_torch_optim.py``), so
    there up to 1 in 1000 elements may differ, each by less than lr."""
    rcfg, cfg = _configs(name)
    ropt = RAdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20)
    rstate = RLM.init_train_state(jax.random.key(0), rcfg, ropt,
                                  param_dtype=jnp.float32)
    state = train_state_from_reference(jax.tree.map(np.asarray, rstate),
                                       "cpu")
    rstep = jax.jit(RLM.make_train_step(
        rcfg, ropt, remat="full", q_chunk=Q_CHUNK, microbatches=microbatches,
        grad_compression=RInt8().pair() if compress else None))
    step = LM.make_train_step(
        cfg, opt, remat="full", q_chunk=Q_CHUNK, microbatches=microbatches,
        grad_compression=Int8Compressor().pair() if compress else None)
    data = RP.SyntheticTokens(RP.DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=T_SEQ, global_batch=4))
    for s in range(3):
        b = data.batch(s)
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, b)
        for k in ("loss", "aux", "n_tokens"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=0,
                                       atol=STEP_TOL, err_msg=k)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 3
    if not compress:
        _close(state, rstate, STEP_TOL, name)
        return
    got = np.concatenate([a.ravel() for a in _leaves(state)])
    want = np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(rstate)])
    off = np.abs(got - want) > STEP_TOL
    assert off.mean() <= 1e-3, off.mean()
    assert np.abs(got - want).max() < opt.lr


def test_train_loop_resumes_the_reference_checkpoint(tmp_path):
    """The reference's ``train_loop`` commits step 3; the port's resumes
    that same file to step 5 and matches the reference's own resumed run:
    losses and params within 1e-5 (the data cursor, the optimizer state,
    the loss and the checkpoint interchange together)."""
    rcfg, cfg = _configs("h2o-danube-3-4b")
    kw = dict(batch=2, seq=64, quiet=True)
    RT.train_loop(rcfg, steps=3, ckpt_base=str(tmp_path / "a" / "ck"),
                  ckpt_every=3, **kw)
    for f in (tmp_path / "a").iterdir():  # the same committed file, twice
        (tmp_path / "b").mkdir(exist_ok=True)
        (tmp_path / "b" / f.name).write_bytes(f.read_bytes())
    rstate, rlosses = RT.train_loop(rcfg, steps=5, ckpt_every=100,
                                    ckpt_base=str(tmp_path / "a" / "ck"),
                                    **kw)
    state, losses = T.train_loop(cfg, steps=5, ckpt_every=100,
                                 ckpt_base=str(tmp_path / "b" / "ck"),
                                 device="cpu", **kw)
    assert len(losses) == len(rlosses) == 2 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, rlosses, rtol=0, atol=STEP_TOL)
    _close(state, rstate, STEP_TOL, "resumed state")
