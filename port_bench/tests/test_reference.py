"""The plain reference against the program's own f32 paths on the CPU at
a small size: where both compute in f32 they agree to rounding, so the
gaps the benchmark reads on the card come from the program's lower
precision and from nothing else."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from port_bench import reference
from port_bench import run as harness
from port_bench import weights
from port_bench.families import family
from port_bench.kinds import extract
from port_bench.reference import search as ref_search
from port_bench.trace import Spans

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def configs() -> list[str]:
    return [c["name"] for c in load("..", "BENCHMARK.json")["configs"]]


def tiny(name: str) -> dict:
    cfg = load("configs", name + ".json")
    cfg.update(family(cfg["family"]).TINY, image_size=32, crop_from=36,
               dtype="float32")
    return cfg


@pytest.mark.parametrize("name", configs())
def test_eval_forward_matches_the_module_path(name):
    from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
    from tf_face_toolbox_tpu_torch.models import create_network
    from tf_face_toolbox_tpu_torch.ops.preprocess import preprocess_eval

    cfg = tiny(name)
    v = weights.make_variables(cfg, 4, "cpu")
    fam = family(cfg["family"])
    net = create_network(cfg["port_network"], **fam.program_kwargs(cfg))
    net = load_jax_variables(net, v).eval()
    u8 = torch.from_numpy(weights.make_faces(4, 6, 36, "cpu"))
    x = preprocess_eval(u8, 32, 32, cfg["input_norm"])
    ref_x = reference.standardized_crops(u8, 32, cfg["input_norm"])
    assert torch.allclose(ref_x, x.permute(0, 3, 1, 2), atol=1e-5)
    with torch.no_grad():
        got = net(x)
        want = fam.forward({k: torch.from_numpy(a) for k, a in v.items()},
                           ref_x, cfg)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * float(
        want.abs().max()))


@pytest.mark.parametrize("workload", [
    w["name"] for w in load("..", "BENCHMARK.json")["workloads"]
    if load("traffic", w["traffic"] + ".json")["kind"] == "extract"])
def test_extract_cell_agrees_in_f32(workload):
    """The whole extract cell at a small size in f32: its gap reads
    rounding, two orders under the limit the bf16 cell is held to."""
    cell = harness.load_cell(workload)
    cell["cfg"] = tiny(cell["cfg"]["name"])
    cell["traffic"].update(batch=4, pool_faces=8, warmup_batches=1,
                           reference_block=4)
    s = extract.setup(cell, 9, "cpu", Spans(False))
    run = extract.window(s, 0.0)
    got = extract.check(s, run)["emb_gap"]
    assert got["value"] < got["limit"] / 100


def test_exact_search_is_brute_force():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((500, 32)).astype(np.float32)
    probes = rng.standard_normal((6, 32)).astype(np.float32)
    dead = np.array([3, 77, 401])
    blocks = ((lo, torch.from_numpy(rows[lo:lo + 128]))
              for lo in range(0, 500, 128))
    top_s, top_i, got = ref_search.exact_search(
        blocks, torch.from_numpy(probes), 5, torch.from_numpy(dead),
        torch.tensor([[3, 0, 1, 2, 4]] * 6), "float32")
    s = probes @ rows.T
    s[:, dead] = -np.inf
    want = np.sort(s, axis=1)[:, ::-1][:, :5]
    assert np.allclose(top_s.numpy(), want, atol=1e-5)
    assert np.isneginf(got[:, 0]).all()
    assert np.allclose(got[:, 1].numpy(), s[:, 0], atol=1e-5)
    gap = ref_search.score_gap(top_s, top_s, top_s)
    assert gap == 0.0

