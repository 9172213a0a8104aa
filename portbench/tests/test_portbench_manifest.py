"""BENCHMARK.json against the rules of its format, and every name in it
resolving to its files."""
import json
import re
from pathlib import Path

import pytest

from portbench.lib import harness

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MAN["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["configs"]) <= 24 and 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16 and 1 <= len(MAN["per_layer"]) <= 128
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text_fields():
    names = [c["name"] for c in MAN["configs"]] + CELLS + [m["name"] for m in metrics()]
    for n in names:
        assert NAME.match(n), n
    for group in (MAN["configs"], MAN["workloads"], metrics()):
        assert len({x["name"] for x in group}) == len(group)
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in MAN["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for m in metrics():
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for text in ([w["why"] for w in MAN["workloads"]] + [c["why"] for c in MAN["configs"]]
                 + [c["source"] for c in MAN["configs"]] + [m["layer"] for m in MAN["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(CELLS) // 4)


def test_every_config_file_is_its_own_and_used():
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    for c in MAN["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert any(w["config"] == c["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_name(cell):
    c = harness.resolve(cell)
    assert hasattr(c.loop, "Loop")
    assert hasattr(c.reference, "__doc__")
    assert c.limits, "a cell's correctness limits"
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(c.reader(m["name"]).read)


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e, m
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert m["moves"] in {x["name"] for x in harness.cell_metrics(MAN, cell)[0]}, (
                m["name"], cell)
    for m in MAN["end_to_end"]:
        for cell in m.get("workloads", []):
            assert cell in CELLS


def test_layers_named_alike():
    by_layer = {}
    for m in MAN["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_paths_hold_only_the_benchmark():
    bench = ROOT / "portbench"
    for f in bench.rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert len(rel) <= 200 and re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
