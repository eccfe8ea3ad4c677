"""BENCHMARK.json and the files it names: every cell found by name with its
configuration, traffic and limits, every metric with its reader."""

import json
import re

import pytest

from portbench.manifest import HERE, ROOT, find_cell, load_manifest, load_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def manifest():
    return load_manifest()


def test_every_cell_is_found_by_name(manifest):
    for w in manifest["workloads"]:
        cell = find_cell(w["name"], manifest)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["kind"] in ("full_graph_train", "batch_train", "serve")
        assert (HERE / "drivers" / f"{cell.traffic['kind']}.py").exists()
        assert "failed" in cell.limits and cell.limits["failed"] == 0
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    with pytest.raises(KeyError):
        find_cell("no-such-cell", manifest)


def test_every_metric_has_a_reader_and_reports_what_it_moves(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["end_to_end"]:
        if m["name"] != "setup_s":
            assert callable(load_reader(m["name"]))
    for m in manifest["per_layer"]:
        assert callable(load_reader(m["name"]))
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in manifest["workloads"]]):
            assert "workloads" not in moved or cell in moved["workloads"]


def test_contract_shapes(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["portbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in manifest[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in manifest["configs"]:
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg or any(key in v for v in cfg.values() if isinstance(v, dict))
    assert len(json.dumps(manifest)) < 64 * 1024
