"""On the card only: each cell's control (the reference in the nearest
lower precision, put in the program's place) fails the limit that the
program meets, at the cell's own sizes over a short window.  Skipped
without a card.  Run: ``PYTHONPATH=src python -m pytest -q -m cuda
perfbench/tests/test_perfbench_cuda.py``."""
from __future__ import annotations

import pytest

from perfbench.harness import check, drive, spec


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the program's kernels run only on the "
                    "card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["blur-2rr-batch"])
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102,
                                  2 ** 31 + 103])
def test_control_fails_where_the_program_passes(card, name, seed):
    run = drive.run_cell(spec.resolve(name), seed, 5.0, False)
    rows = check.checks(run, control=True)
    assert rows
    for row in rows:
        assert row["n"] > 0
        assert row["value"] <= row["limit"] < row["control"], row
