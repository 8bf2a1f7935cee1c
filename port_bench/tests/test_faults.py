"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a chip and drives the rest of a
run (``run.run_cell``) on the CPU at a small size, with the cell's own
limits, once sound and once for each fault the cell can have: a step
that leaves its state unchanged (for extraction: a batch answered with
the last batch's embeddings), half of the batch left out, and an answer
altered where it is produced. One card holds each cell, so no exchange
between chips can be left out. The cells are BENCHMARK.json's, by the
kind of their traffic.
"""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from port_bench import run as harness
from port_bench.families import family


def cells(kind: str) -> list[str]:
    """The cells of BENCHMARK.json whose traffic is of ``kind``."""
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    return [w["name"] for w in spec["workloads"]
            if harness.load_json(harness.HERE, "traffic", w["traffic"]
                                 + ".json")["kind"] == kind]


def tiny_cell(workload: str) -> dict:
    """The cell at its family's ``TINY`` sizes, on 32x32 crops of 36x36
    faces, with a traffic mix a CPU runs in a fraction of a second."""
    cell = harness.load_cell(workload)
    cfg, t = cell["cfg"], cell["traffic"]
    cfg.update(family(cfg["family"]).TINY, image_size=32, crop_from=36)
    if t["kind"] == "extract":
        t.update(batch=4, pool_faces=12, warmup_batches=1,
                 reference_block=6)
    elif t["kind"] == "identify":
        t.update(rows=3000, row_block=1024, batch=8, request_pool=6,
                 warmup_requests=1, checked_requests=6, removed_rows=3)
    return cell


def run(workload: str) -> dict:
    """A run with a window of a fifth of a second: several batches."""
    return harness.run_cell(tiny_cell(workload), 2**31 + 17, 0.2, False,
                            "cpu", time.monotonic())


EXTRACT = cells("extract")


@pytest.mark.parametrize("workload", EXTRACT)
def test_extract_sound(workload):
    assert run(workload)["correct"]


@pytest.mark.parametrize("workload", EXTRACT)
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_extract_faults(workload, fault, monkeypatch):
    from tf_face_toolbox_tpu_torch import extract

    real = extract.flip_averaged_embeddings
    last = []

    def broken(apply_fn, images, with_quality=False):
        n = images.shape[0]
        if fault == "half":
            out = real(apply_fn, images[:n // 2], with_quality)
            return torch.cat([out, out])[:n]
        out = real(apply_fn, images, with_quality)
        if fault == "stale":
            if last:
                out = last[0]
            last[:] = [out]
        if fault == "altered":
            out = out.clone()
            out[0] = -out[0]
        return out

    monkeypatch.setattr(extract, "flip_averaged_embeddings", broken)
    result = run(workload)
    assert not result["correct"], result["checks"]


IDENTIFY = cells("identify")


@pytest.mark.parametrize("workload", IDENTIFY)
def test_identify_sound(workload):
    assert run(workload)["correct"]


@pytest.mark.parametrize("workload", IDENTIFY)
@pytest.mark.parametrize("fault", ["half", "altered"])
def test_identify_faults(workload, fault, monkeypatch):
    from tf_face_toolbox_tpu_torch.serving import gallery

    real = gallery.search_store

    def broken(g, store, bias, n_valid, k, probes, *a, **kw):
        if fault == "half":
            half = probes.shape[0] // 2
            s, i = real(g, store, bias, n_valid, k, probes[:half], *a, **kw)
            return torch.cat([s, s]), torch.cat([i, i])
        s, i = real(g, store, bias, n_valid, k, probes, *a, **kw)
        s = s.clone()
        s[0, 0] += 1e-3
        return s, i

    monkeypatch.setattr(gallery, "search_store", broken)
    result = run(workload)
    assert not result["correct"], result["checks"]

