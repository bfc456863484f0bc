"""BENCHMARK.json and the data it names hold together."""

import ast
import json
import re
from pathlib import Path

import pytest

from gsbench import harness, spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "gaussian_splatting_tpu", "gaussian_splatting_torch"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gsbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (spec.ROOT / BENCH["command"][1]).is_file()
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=CELLS)
def test_workload_names_existing_config_and_traffic(w):
    assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1
    assert len(w["why"]) <= 200
    cfg = [c for c in BENCH["configs"] if c["name"] == w["config"]]
    assert cfg and (spec.ROOT / cfg[0]["file"]).is_file()
    traffic = spec.load_json(spec.HERE / "traffic" / f"{w['traffic']}.json")
    assert callable(spec.load_module("traffic", traffic["kind"]).make)
    config = spec.load_json(spec.ROOT / cfg[0]["file"])
    assert callable(spec.load_module("scenes", config["scene_maker"]).make)
    assert (spec.HERE / "limits" / f"{w['name']}.json").is_file()


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_setup_another_metric_and_a_layer(name):
    cell = spec.load_cell(name)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:  # each moves an end-to-end metric this cell reports
        assert m["moves"] in e2e, (m["name"], name)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert set(m.get("workloads", CELLS)) <= set(CELLS)
    if m in BENCH["per_layer"]:
        # a share of the peak counts its operations and takes its time on
        # the host's clock; every other per-layer metric reads the trace
        assert m["source"] == ("host_clock" if "mfu" in m["name"] else "device_trace")
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        assert (spec.HERE / "metrics" / spec.metric_file(m["name"])).is_file()
        assert callable(spec.metric_reader(m["name"]))
    else:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_a_kind_a_scene_and_a_metric_come_in_as_files(tmp_path, monkeypatch):
    """What a later cell needs beyond data is found by name, with no edit
    to a file the harness has."""
    bodies = dict(traffic="def make(cell, seed, device):\n    return ('run', seed)\n",
                  scenes="def make(config, n, seed, device):\n    return ('scene', n)\n",
                  metrics="def read(t):\n    return 42.0\n")
    for folder, body in bodies.items():
        (tmp_path / folder).mkdir()
        (tmp_path / folder / "made_up.py").write_text(body)
    monkeypatch.setattr(spec, "HERE", tmp_path)
    monkeypatch.setattr(spec, "_MODULES", {})
    cell = spec.Cell(name="x", chips=1, config={}, traffic={"kind": "made_up"}, limits={},
                     end_to_end=[], per_layer=[])
    assert harness.make(cell, 7, None) == ("run", 7)
    from gsbench import scene

    assert scene.load({"scene_maker": "made_up"}, 5, 0, None) == ("scene", 5)
    assert spec.metric_file("made_up.serve") == "made_up.py"
    assert spec.metric_reader("made_up.train")(None) == 42.0


def test_every_config_is_used_and_cut_nowhere():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["reduced"] == []
        assert spec.load_json(spec.ROOT / c["file"])["source"] == c["source"]


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program_or_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", sorted(p for p in spec.HERE.rglob("*.py")
                                        if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_harness_imports_no_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN - {"gaussian_splatting_torch"}]
    assert not bad, bad


def test_the_sample_is_a_copy_of_the_root_sample():
    root = spec.ROOT / "bench_scene_sample.npz"
    if not root.exists():
        pytest.skip("the root sample is not in this checkout")
    assert (spec.HERE / "data" / "bench_scene_sample.npz").read_bytes() == root.read_bytes()
