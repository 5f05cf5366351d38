"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file of its own."""

import json
import os
import re

import pytest

from perfbench import harness
from perfbench.tests import sizes

ROOT = harness.ROOT
B = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in B["workloads"]]
METRICS = B["end_to_end"] + B["per_layer"]


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(B["configs"]) <= 24 and 1 <= len(CELLS) <= 24
    assert 1 <= len(B["end_to_end"]) <= 16
    assert 1 <= len(B["per_layer"]) <= 128
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    # A full check of 24 cells at this length fits its 43,200 seconds.
    assert ((2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


def test_command_and_paths():
    cmd, paths = B["command"], B["paths"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    for w in cmd[1:]:
        assert not w.startswith("/") and ".." not in w
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w.startswith(p + "/") for p in paths)


def test_names_units_and_entry_keys():
    names = [c["name"] for c in B["configs"]] + CELLS + [
        m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    setup = [m for m in B["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("config", B["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    path = config["file"]
    assert any(path.startswith(p + "/") for p in B["paths"])
    data = harness.load_json(os.path.join(ROOT, *path.split("/")))
    for key in config["reduced"]:
        assert key in data
    assert any(w["config"] == config["name"] for w in B["workloads"])
    assert len({c["file"] for c in B["configs"]}) == len(B["configs"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    _, entry, wl, cfg = harness.cell(cell)
    drv = harness.driver(wl["driver"])
    for fn in ("setup", "window", "spans", "profiled", "check"):
        assert callable(getattr(drv, fn))
    assert wl["limits"] and all(NAME.match(k) for k in wl["limits"])
    e2e = [m for m in B["end_to_end"] if harness.applies(m, cell, B)]
    layer = [m for m in B["per_layer"] if harness.applies(m, cell, B)]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert layer
    for m in layer:
        assert m["moves"] in [x["name"] for x in e2e]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_tiny_sizes(cell):
    """The tests find a cell's sizes by its name: its file overrides only
    the workload's parameters, the configuration's (``config``) and, for
    the card's tests, both again (``card``); its driver plants faults."""
    _, _, wl, cfg = harness.cell(cell)
    assert os.path.exists(sizes.path(cell)), "no %s" % sizes.path(cell)
    tiny = harness.load_json(sizes.path(cell))
    card = tiny.pop("card", {})
    for s in (tiny, card):
        assert set(s) <= set(wl) | {"config"}, sorted(s)
        assert set(s.get("config", {})) <= set(cfg)
    assert getattr(harness.driver(wl["driver"]), "FAULTS", None), \
        "driver %s plants no faults" % wl["driver"]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert callable(harness.metric_reader(metric["name"]).read)


def test_layers_are_perf_md_layers():
    """Each metric's layer is a layer of PERF.md's list, letter for
    letter."""
    with open(os.path.join(ROOT, "PERF.md")) as f:
        text = f.read()
    section = text[text.index("## 3. Layers"):text.index("## 4. Cells")]
    layers = {row.split("|")[1].strip() for row in section.splitlines()
              if row.startswith("| ") and not row.startswith("| layer")}
    assert {m["layer"] for m in B["per_layer"]} <= layers


def test_workload_files_are_json():
    for cell in CELLS:
        with open(os.path.join(ROOT, "perfbench", "workloads",
                               cell + ".json")) as f:
            json.load(f)
