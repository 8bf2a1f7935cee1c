"""The result line: exactly its keys, ``setup`` then ``checks`` last, the
traced run's device seconds and breakdown; no result without a card or
with JAX loaded."""

from __future__ import annotations

import json
import sys
import time
import types

from port_bench import run as harness
from port_bench.tests.test_faults import tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "setup",
        "checks"]


def test_untraced_line():
    cell = tiny_cell("resnet50_face.extract")
    r = harness.run_cell(cell, 5, 0.1, False, "cpu", time.monotonic())
    assert list(r) == KEYS
    assert set(r["metrics"]) == {"extract_faces_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    assert r["setup"] == {"setup_s": r["metrics"]["setup_s"]["value"],
                          "kernel_build_s": 0.0, "kernels_built": False}
    json.dumps(r)


def test_traced_line():
    cell = tiny_cell("resnet50_face.identify")
    r = harness.run_cell(cell, 5, 0.1, True, "cpu", time.monotonic())
    assert list(r) == KEYS[:-2] + ["breakdown", "setup", "checks"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in r["breakdown"].values())
    # no device ran here: the shares of a peak are left out, not 0
    assert "mfu.identify" not in r["metrics"]
    assert "topk_roofline" not in r["metrics"]


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "resnet50_face.extract", "--seed", "1",
                       "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "CUDA" in out.err


def test_forbidden_modules_by_whole_name(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tf_face_toolbox_tpu.bench",
                        types.ModuleType("tf_face_toolbox_tpu.bench"))
    assert harness.forbidden_modules() == ["tf_face_toolbox_tpu"]
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax", "tf_face_toolbox_tpu"]
