"""A whole run of each cell on the CPU at tiny sizes (the plain kernels in
place of the card's), with the look for a card skipped: a sound run comes
out correct, and a run with the timed path broken underneath comes out not
correct, once for each fault the cells can have: a pass that leaves its
state unchanged, an answer altered where it is produced.  (A blur task is
no batch, and no cell has an exchange between chips.)"""
from __future__ import annotations

import pytest
import torch

from perfbench.tests.tiny import run_tiny

torch.set_num_threads(1)

CELLS = ["blur-2rr-batch"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run_tiny(name)
    run = out.pop("_run")
    assert out["correct"], out
    assert out["failed"] == 0 and out["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert list(out)[-1] == "checks"
    assert run.setup_s > 0
    assert {r.req.px for r in run.blur} == {60, 130}


def _blur_rows(monkeypatch, how):
    from repro_torch.kernels.blur import tasks
    real = tasks.blur_rows

    def broken(src, dst, rb, first, kind, count):
        if how == "unchanged":
            return None                 # the pass leaves its output as it was
        real(src, dst, rb, first, kind, count)
        dst[1 + first * rb, 1] += 0.25  # one pixel of the answer altered

    monkeypatch.setattr(tasks, "blur_rows", broken)


@pytest.mark.parametrize("how", ["unchanged", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_blur_fault_is_caught(monkeypatch, name, how):
    _blur_rows(monkeypatch, how)
    out = run_tiny(name)
    out.pop("_run")
    assert not out["correct"]
    assert out["checks"]["blur_max_abs_err"]["value"] > \
        out["checks"]["blur_max_abs_err"]["limit"]
