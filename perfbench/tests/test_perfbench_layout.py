"""BENCHMARK.json against the benchmark's contract, every part found by
name, and the import rule: nothing under perfbench/ imports JAX, the JAX
package or its benchmarks, and the reference imports nothing of the port."""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from perfbench.harness import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_names_units_and_readers(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"
    assert callable(spec.reader(m["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves_and_reports_enough(w):
    cell = spec.resolve(w["name"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert set(cell.config["limits"])
    for m in cell.per_layer:      # what a layer metric moves, the cell reports
        assert m["moves"] in e2e
    for s in cell.mix["streams"]:
        assert s["kind"] == "blur" and s["clients"] >= 1
        # requests keep to the source's shapes: its image sizes, its tasks
        assert set(s["frame_px"]) <= set(cell.config["frame_px"])
        assert {tuple(k) for k in s["kernels"]} <= {
            tuple(k) for k in cell.config["task_set"]}
        assert set(s["priorities"]) <= set(range(cell.config["priorities"]))


def test_config_files_state_their_cuts():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_size")) or \
                key == "vocab_size", key


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


SOURCES = sorted((ROOT / "perfbench").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_nor_jax_package_imported(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    if "reference" in path.relative_to(ROOT / "perfbench").parts:
        assert "repro_torch" not in tops and "perfbench" not in tops


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench" / "metrics").glob("*.py")),
                         ids=lambda p: p.stem)
def test_every_reader_file_loads(path):
    assert callable(spec.reader(path.stem))
