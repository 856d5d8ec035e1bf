"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name."""

import json
import re
from pathlib import Path

import pytest

from bench import run

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(SPEC) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 << 10
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries_have_exactly_their_keys(section, keys):
    for e in SPEC[section]:
        assert set(e) == keys, e["name"]
        for k in ("name", "config", "traffic"):
            if k in e:
                assert NAME.match(e[k]), e[k]
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]


def test_metric_names_units_and_keys():
    names = []
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        names.append(m["name"])
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])


def _reports(cell):
    return {m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in SPEC["workloads"]:
        got = _reports(w["name"])
        assert "setup_s" in got and len(got) >= 2, w["name"]
        assert any(w["name"] in m["workloads"] for m in SPEC["per_layer"]), w["name"]


def test_each_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in _reports(cell), (m["name"], cell)


def test_configs_cells_and_their_files():
    cells = SPEC["workloads"]
    names = [w["name"] for w in cells]
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert any(w["config"] == c["name"] for w in cells), c["name"]
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("bench/")
        assert (ROOT / "bench" / "reference" / f"{c['name']}.py").exists()
    for w in cells:
        assert w["chips"] in (1, 4)
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "bench" / "limits" / f"{w['name']}.json").exists(), w["name"]
    for m in SPEC["per_layer"]:
        assert run.reader_path(ROOT, m["name"]).exists(), m["name"]


def test_reduced_names_no_width():
    width = re.compile(r"(_dim|_rank)$|hidden|intermediate|d_model|d_ff|head|expan|top_k|latent|state")
    for c in SPEC["configs"]:
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not width.search(k), k
