"""The port stands alone: importing every ``repro_torch`` module (among
them ``core.pool``, ``controller.controller``, ``obs`` with its six
modules, the megakernel engine's, the cluster fabric, the checkpoint
store, the surrogate and attention LMs' persistent kernels and the serve
CLI) and
``chip_smoke.py``
brings in neither ``jax`` nor any ``repro.`` module."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
# the elastic pool, the deprecated Controller and the flight recorder, by
# name: a module the walk missed would pass unchecked
for name in ("repro_torch.core.pool", "repro_torch.controller.controller",
             "repro_torch.obs", "repro_torch.obs.tracer",
             "repro_torch.obs.registry", "repro_torch.obs.metrics",
             "repro_torch.obs.export", "repro_torch.obs.exporter",
             "repro_torch.obs.slo",
             # the megakernel engine's modules
             "repro_torch.core.preemption", "repro_torch.core.region",
             "repro_torch.kernels.blur.kernel", "repro_torch.kernels.blur.ops",
             "repro_torch.kernels.blur.tasks",
             # the cluster fabric and the checkpoint store
             "repro_torch.cluster", "repro_torch.cluster.frontend",
             "repro_torch.cluster.node", "repro_torch.cluster.router",
             "repro_torch.ckpt", "repro_torch.ckpt.store",
             # the surrogate LM's persistent kernels and the serve CLI
             "repro_torch.kernels.seq_lm", "repro_torch.kernels.seq_lm.kernel",
             "repro_torch.kernels.seq_lm.ops", "repro_torch.launch.serve",
             # the attention LM's persistent kernels
             "repro_torch.kernels.attn_lm",
             "repro_torch.kernels.attn_lm.kernel",
             "repro_torch.kernels.attn_lm.ops"):
    assert name in names, name
for name in names:
    importlib.import_module(name)
from repro_torch.controller import Controller  # noqa: F401  (lazy export)
sys.path.insert(0, sys.argv[1])
import chip_smoke  # noqa: F401  (import only: main() runs under __main__)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
