"""BENCHMARK.json against the files that the harness finds by name, the
contract's character sets, and the import rules: nothing under benchmark/
imports JAX, Flax or the JAX package (top-level names compared whole), and
the reference imports nothing of the port."""

from __future__ import annotations

import ast
import json
import re

import pytest

from benchmark.tests.conftest import HERE, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "blackhole_simulation_tpu"}
PORT = "blackhole_simulation_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (HERE / "drivers" / f"{traffic['driver']}.py").is_file()
    assert (HERE / "limits" / f"{cell['name']}.json").is_file()
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["name"] == config["name"]
    assert config["file"].startswith("benchmark/configs/")


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_found_by_name(metric):
    assert (HERE / "metrics" / f"{metric['name']}.py").is_file()
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_names_and_units():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["workloads"]:
        assert NAME.match(c["config"]) and NAME.match(c["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize(
    "path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_imports(path):
    found = {name.split(".")[0] for name in _imports(path)}
    assert not found & FORBIDDEN, found & FORBIDDEN
    if "reference" in path.parts:
        assert PORT not in found
