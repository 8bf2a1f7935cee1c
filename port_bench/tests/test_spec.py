"""BENCHMARK.json and the files it names: the shapes the benchmark's
format asks for, and that the harness finds every configuration, its
family, traffic mix, limit and per-layer reader by its name."""

from __future__ import annotations

import json
import os
import re

import pytest

from port_bench import run as harness
from port_bench.families import family

ROOT = harness.ROOT
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")


@pytest.fixture(scope="module")
def spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(spec["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in spec["command"])
    assert 1 <= len(spec["paths"]) <= 16
    assert all(PATH.fullmatch(p) for p in spec["paths"])
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert ((2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 2 * 90
            + 1200 <= 43200)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_configs(spec):
    names = [c["name"] for c in spec["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    used = {w["config"] for w in spec["workloads"]}
    files = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in spec["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])


def test_workloads(spec):
    names = [w["name"] for w in spec["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])


def test_metrics(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    layer = {m["name"]: m for m in spec["per_layer"]}
    assert len(e2e) == len(spec["end_to_end"])
    assert len(layer) == len(spec["per_layer"])
    assert not set(e2e) & set(layer)
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers: dict[str, str] = {}
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        # every cell that reports it reports the metric it moves
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", cells)) <= moved
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], m["layer"])
    for w in cells:
        reports = [m for m in spec["end_to_end"]
                   if w in m.get("workloads", cells)]
        assert len(reports) >= 2, w
        assert any(w in m.get("workloads", cells)
                   for m in spec["per_layer"]), w


def _cells() -> list[str]:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("workload", _cells())
def test_cells_found_by_name(spec, workload):
    cell = harness.load_cell(workload)
    assert cell["cfg"]["name"] == cell["cell"]["config"]
    fam = family(cell["cfg"]["family"])
    for fn in ("layers", "forward", "program_kwargs"):
        assert callable(getattr(fam, fn))
    assert isinstance(fam.TINY, dict)
    drv = harness.kind_module(cell["traffic"]["kind"])
    for fn in ("setup", "window", "check", "control"):
        assert callable(getattr(drv, fn))
    assert isinstance(drv.BUILDS_KERNELS, bool)
    assert cell["limits"] and all(v >= 0 for v in cell["limits"].values())
    for m in cell["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for m in cell["end_to_end"]:
        assert m["name"] == "setup_s" or m["workloads"]


def test_every_file_under_paths_has_a_name(spec):
    """Files under paths are named from a name's characters and '/'."""
    for p in spec["paths"]:
        for folder, dirs, files in os.walk(os.path.join(ROOT, p)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in files:
                rel = os.path.relpath(os.path.join(folder, f), ROOT)
                assert PATH.fullmatch(rel), rel
