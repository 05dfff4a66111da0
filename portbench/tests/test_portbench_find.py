"""Every configuration, mix, metric reader, reference and limit that
``BENCHMARK.json`` names is found by name under ``portbench/``."""

import json
import re

import pytest

from portbench import core
from portbench.traffic import Traffic

BENCH = core.load_json(core.CHECKOUT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_are_found_by_name(cell):
    c = core.Cell(cell)
    assert c.cfg["name"] == c.entry["config"]
    assert c.reference.__name__.startswith("portbench_reference_")
    traffic = Traffic(c.mix, c.cfg)
    names = {f"{op['name']}_gap" for op in traffic.ops}
    assert names == set(c.limits), "a limit for every number compared, and no other"
    for metric in c.end_to_end:
        assert callable(c.reader(metric, "end_to_end").read)
    for metric in c.per_layer:
        assert callable(c.reader(metric, "metrics").read)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=[c["name"] for c in BENCH["configs"]])
def test_config_files_state_what_they_changed(entry):
    cfg = core.load_json(core.CHECKOUT / entry["file"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    changed = {k for k, v in cfg["published"].items() if cfg[k] != v}
    assert changed == set(entry["reduced"])
    assert all(k in cfg["assumed"] for k in changed)
    grid = [s // c for s, c in zip(cfg["shape"], cfg["chunks"])]
    assert grid == [p // q for p, q in zip(cfg["published"]["shape"], cfg["published"]["chunks"])]


def test_benchmark_json_keeps_to_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1].startswith("portbench/")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_each_cell_reports_enough():
    for cell in CELLS:
        c = core.Cell(cell)
        e2e = [m["name"] for m in c.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in e2e, f"{m['name']} moves a metric that {cell} does not report"
