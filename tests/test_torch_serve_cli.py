"""The port's serve CLI (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``), side by side on the CPU
(``--device cpu``):

- ``decode`` under each engine (sync, pipelined, megakernel) for the
  surrogate and the attention LM, with a preemption probe every 2nd round:
  the streams equal the oracle and the reference's ``serve_decode`` on the
  same seed, and the report's keys are the reference's.  Only the
  megakernel path places its preemptions deterministically (the probe arms
  the one-shot flag), so only there ``decode_preemptions >= 1`` is
  asserted;
- ``scheduler`` (a batch replay and an open-loop run) and ``cluster`` (with
  a shell failure and without) with 4 tasks at 48^2: every result equals
  the reference's blur oracle, and the report's keys are the reference's;
- the parser: each subcommand takes the reference's flags and ``--device``;
  ``_translate_legacy`` maps legacy invocations as the reference does;
- every subcommand runs on ``cuda:0`` unless told otherwise, and
  ``decode --lm attention --engine megakernel`` on the card binds the
  attention kernels' persistent entries (M4/M5) before it serves;
- ``python -m repro_torch.launch.serve decode --device cpu`` end to end,
  with ``--metrics-out`` and ``--trace-out``.

Tolerances: token streams and median images bitwise; gaussian images
within 1e-6, the reference's blur tolerance (``tests/test_kernels.py``).
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # six test workers share the cores: see ROADMAP §C

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.blur.ref import iterated_blur_ref  # noqa: E402
from repro.launch import serve as R_serve  # noqa: E402
from repro.serving import engine as R_engine  # noqa: E402
from repro.serving.kernels import oracle_stream  # noqa: E402
from repro_torch.cluster import frontend as P_frontend  # noqa: E402
from repro_torch.core import scheduler as P_scheduler  # noqa: E402
from repro_torch.launch import serve as P_serve  # noqa: E402
from repro_torch.serving import engine as P_engine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GAUSS_TOL = 1e-6
KINDS = {"MedianBlur": "median", "GaussianBlur": "gaussian"}
DECODE = dict(n_sequences=3, prompt_len=6, max_new=5, slots=2,
              round_tokens=3, preempt_every=2, seed=4, quiet=True)
SURROGATE = dict(d_model=32, vocab=51865)


def _record(monkeypatch, cls, name):
    """Wrap ``cls.name`` to record every call's arguments and result."""
    calls = []
    orig = getattr(cls, name)

    def wrapper(self, *args, **kw):
        out = orig(self, *args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(cls, name, wrapper)
    return calls


def _streams(calls):
    return [h.result(timeout=0) for _a, _k, h in calls]


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("lm", ["surrogate", "attention"])
@pytest.mark.parametrize("engine", ["sync", "pipelined", "megakernel"])
def test_decode_streams_equal_oracle_and_reference(monkeypatch, engine, lm):
    """``serve_decode`` on the CPU: every stream equals the oracle (the
    run's own check, and for the surrogate the reference's
    ``oracle_stream`` here) and the reference's stream on the same seed;
    the report's keys are the reference's."""
    kw = dict(DECODE, engine=engine, lm=lm,
              **(SURROGATE if lm == "surrogate" else {}))
    p_calls = _record(monkeypatch, P_engine.ServingEngine, "submit")
    r_calls = _record(monkeypatch, R_engine.ServingEngine, "submit")
    p_rep = P_serve.serve_decode(device="cpu", **kw)
    r_rep = R_serve.serve_decode(**kw)
    got, want = _streams(p_calls), _streams(r_calls)
    assert len(got) == DECODE["n_sequences"]
    assert got == want
    if lm == "surrogate":
        for (args, kwargs, _h), toks in zip(p_calls, got):
            prompt, params = args
            assert toks == oracle_stream(list(prompt), params.seed,
                                         params.max_new_tokens,
                                         kw["d_model"], kw["vocab"])
    assert set(p_rep) == set(r_rep)
    assert p_rep["n_finished"] == DECODE["n_sequences"]
    assert p_rep["stranded_sequences"] == 0
    assert p_rep["tokens_out"] == sum(len(t) for t in got)
    if engine == "megakernel":
        assert p_rep["decode_preemptions"] >= 1


def test_decode_attention_megakernel_binds_the_persistent_entries(
        monkeypatch):
    """The attention LM's kernels carry persistent entries (M4/M5): on a
    CUDA device ``decode --lm attention --engine megakernel`` gets past the
    up-front check, binding ``AttnPrefill``'s and ``AttnDecode``'s ``mega``
    (stubbed here, so it runs without a card: the bound launches hand
    their arguments to the stubs), and goes on to build its shell."""
    import dataclasses

    from repro_torch.controller import kernels as PK
    from repro_torch.core import preemption as PP
    from repro_torch.core import shell as PS
    from repro_torch.core.context import ContextRecord

    names = P_serve._lm_kernels("attention", 64, 101)
    calls, bound = [], []
    for name in names:
        monkeypatch.setitem(PK._REGISTRY, name, dataclasses.replace(
            PK.get_kernel(name),
            mega=lambda *args, name=name: calls.append((name, args[1:]))))
    real = PP.make_megakernel

    def recording(kd, device=None):
        fn = real(kd, device)
        bound.append((kd.name, torch.device(device), fn))
        return fn

    class ShellBuilt(Exception):
        pass

    def shell(*args, **kw):
        raise ShellBuilt

    monkeypatch.setattr(PP, "make_megakernel", recording)
    monkeypatch.setattr(PS, "Shell", shell)
    with pytest.raises(ShellBuilt):
        P_serve.serve_decode(lm="attention", engine="megakernel",
                             device="cuda:0", quiet=True)
    assert [n for n, _, _ in bound] == list(names) == ["AttnPrefill",
                                                       "AttnDecode"]
    for name, device, fn in bound:
        assert device == torch.device("cuda", 0)
        fn(ContextRecord.fresh(), "bufs", "ints", "floats", 3, "flag")
    assert calls == [(n, ("bufs", "ints", "floats", 3, "flag"))
                     for n in names]


# ------------------------------------------------------ scheduler / cluster
def _oracle(task):
    img = np.asarray(task.args.bufs[0])
    iters = int(task.args.ints[2])
    want = np.asarray(iterated_blur_ref(jnp.asarray(img), iters,
                                        KINDS[task.kernel]))
    return iters, want


def _check_result(task, result):
    iters, want = _oracle(task)
    got = np.asarray(result[iters % 2])
    if task.kernel == "MedianBlur":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=GAUSS_TOL)


@pytest.mark.parametrize("mode", ["batch", "open-loop"])
def test_scheduler_subcommand_matches_oracle(monkeypatch, mode):
    """``serve_task_stream`` with 4 tasks at 48^2: the batch replay
    (pipelined) and the open-loop run (megakernel, wfq over 2 tenants):
    every result equals the oracle; the report's keys are the
    reference's."""
    kw = dict(n_tasks=4, seed=2, quiet=True)
    if mode == "open-loop":
        kw.update(open_loop=True, policy="wfq", tenants=2, burst=2,
                  arrival_rate=50.0, engine="megakernel")
        p_calls = _record(monkeypatch, P_scheduler.Scheduler, "submit")
    else:
        p_calls = _record(monkeypatch, P_scheduler.Scheduler, "run")
    p_rep = P_serve.serve_task_stream(device="cpu", **kw)
    r_rep = R_serve.serve_task_stream(**kw)
    tasks = ([a[0] for a, _k, _h in p_calls] if mode == "open-loop"
             else p_calls[0][0][0])
    assert len(tasks) == 4 and p_rep["n_done"] == 4
    for t in tasks:
        _check_result(t, t.result)
    assert set(p_rep) == set(r_rep)
    assert set(p_rep["pool"]) == set(r_rep["pool"])


@pytest.mark.parametrize("fail_shell", [None, 1])
def test_cluster_subcommand_matches_oracle(monkeypatch, fail_shell):
    """``serve_cluster`` with 4 tasks at 48^2 over two CPU shells, with one
    forced migration, and with shell 1 killed after the 2nd submission:
    every handle resolves to the oracle's image, none lost; the report's
    keys are the reference's."""
    kw = dict(n_tasks=4, seed=3, quiet=True, burst=2, arrival_rate=50.0,
              force_migrations=0 if fail_shell else 1,
              fail_shell=fail_shell, fail_after=2)
    p_calls = _record(monkeypatch, P_frontend.ClusterFrontend, "submit")
    p_rep = P_serve.serve_cluster(device="cpu", **kw)
    r_rep = R_serve.serve_cluster(**kw)
    assert len(p_calls) == 4
    for args, _kw, handle in p_calls:
        _check_result(args[0], handle.result(timeout=0))
    assert p_rep["n_done"] == 4 and p_rep["lost_tasks"] == 0
    assert p_rep["stranded_handles"] == 0
    if fail_shell is not None:
        shells = p_rep["per_shell"]
        assert shells[0]["crash"] is None and shells[1]["crash"]
    assert set(p_rep) == set(r_rep)


# ------------------------------------------------------------------ parser
def _flags(parser: argparse.ArgumentParser) -> dict:
    """subcommand -> {flag: (default, choices)}."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {cmd: {opt: (act.default, act.choices)
                  for act in p._actions for opt in act.option_strings}
            for cmd, p in sub.choices.items()}


def test_parser_takes_the_reference_flags_and_device(monkeypatch):
    """Each subcommand takes exactly the reference's flags (defaults and
    choices included) plus ``--device`` (default None: ``cuda:0``)."""
    captured = {}

    def grab(self, args=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        R_serve.main(["decode"])
    monkeypatch.undo()
    want = _flags(captured["parser"])
    got = _flags(P_serve.build_parser())
    assert set(got) == set(want) == {"lm", "scheduler", "cluster", "decode"}
    for cmd in want:
        assert got[cmd].pop("--device") == (None, None), cmd
        assert got[cmd] == want[cmd], cmd


@pytest.mark.parametrize("argv", [
    ["decode", "--slots", "3"],
    ["--mode", "decode", "--slots", "3"],
    ["--mode=cluster", "--shells", "2"],
    ["--n-tasks", "4", "--mode", "scheduler"],
    ["--arch", "qwen3-8b"],
    [],
    ["--help"],
])
def test_translate_legacy_matches_reference(argv):
    assert P_serve._translate_legacy(list(argv)) == \
        R_serve._translate_legacy(list(argv))


@pytest.mark.parametrize("cmd", ["scheduler", "cluster", "decode"])
def test_new_subcommands_default_to_cuda(monkeypatch, cmd):
    """Without ``--device`` a subcommand runs on ``cuda:0``: with no CUDA it
    raises naming ``--device cpu`` instead of falling back."""
    assert P_serve.build_parser().parse_args([cmd]).device is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda:0"):
        P_serve.main([cmd, "--quiet"])


def test_cli_decode_on_cpu_writes_metrics_and_trace(tmp_path):
    """``python -m repro_torch.launch.serve decode --device cpu`` serves
    and verifies every stream, and writes the report and a Chrome trace."""
    metrics, trace = tmp_path / "m.json", tmp_path / "t.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "decode",
         "--device", "cpu", "--sequences", "3", "--d-model", "32",
         "--slots", "2", "--engine", "megakernel", "--preempt-every", "2",
         "--metrics-out", str(metrics), "--trace-out", str(trace)],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "3/3 sequences" in proc.stdout
    rep = json.loads(metrics.read_text())
    assert rep["n_finished"] == 3 and rep["decode_preemptions"] >= 1
    events = json.loads(trace.read_text())
    assert events["traceEvents"]
