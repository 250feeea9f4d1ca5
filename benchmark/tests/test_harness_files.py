"""BENCHMARK.json and the files it names: the contract's shape, every cell
naming a configuration, traffic mix, driver, limits and metric readers that
exist, and nothing the harness loads being JAX or the JAX package."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and c["name"] in used
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_names_files_that_exist(cell):
    from benchmark import harness
    from benchmark.reference import compare

    w = next(x for x in SPEC["workloads"] if x["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
    c = harness.Cell.named(cell)
    assert (BENCH / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert callable(harness.driver(c).run)
    assert set(c.limits) == set(compare.NUMBERS)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))


def test_metrics():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
        assert UNIT.match(m["unit"]) and set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"]) and _line(m["layer"])
        assert m["moves"] in e2e
        for cell in m["workloads"]:  # each listed cell reports what it moves
            assert cell in e2e[m["moves"]].get("workloads", cells)
        assert any((BENCH / "metrics" / f"{n}.py").exists()
                   for n in (m["name"], m["name"].split(".")[0]))
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"bevy_ggrs_tpu_torch", "bevy_ggrs_tpu", "jax", "jaxlib", "flax"}, path


def test_nothing_the_harness_loads_is_jax():
    """Import every module of the harness (drivers, readers, reference,
    and the program modules the drivers use) in a fresh process, then look
    at the whole top-level names in ``sys.modules``."""
    code = """
import sys
sys.path.insert(0, {root!r})
import benchmark.run, benchmark.calibrate
from benchmark import harness
from benchmark.reference import compare, flock, hash
for w in harness.benchmark_spec()["workloads"]:
    c = harness.Cell.named(w["name"])
    harness.driver(c)
    for m in c.per_layer:
        harness.metric_reader(m["name"])
import bevy_ggrs_tpu_torch.app, bevy_ggrs_tpu_torch.models.boids
import bevy_ggrs_tpu_torch.parallel.speculate, bevy_ggrs_tpu_torch.session
print(harness.forbidden_modules())
""".format(root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "bevy_ggrs_tpu_torch_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "bevy_ggrs_tpu.state", object())
    assert harness.forbidden_modules() == ["bevy_ggrs_tpu"]
