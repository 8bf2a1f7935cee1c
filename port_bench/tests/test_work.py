"""The yardstick's work counts: the FLOPs from a configuration's shapes
against torch's FlopCounterMode over the program's own module, and
kernel 3's bytes against the tensors a gallery holds."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import arch, work
from port_bench.families import family

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def config(name: str) -> dict:
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)


def configs() -> list[str]:
    with open(os.path.join(os.path.dirname(CONFIGS), "..",
                           "BENCHMARK.json")) as f:
        return [c["name"] for c in json.load(f)["configs"]]


@pytest.mark.parametrize("name", configs())
def test_forward_flops_match_the_program(name):
    """Convs and Denses counted from the shapes = what torch counts over
    the program's module at its published widths (one image, f32)."""
    from tf_face_toolbox_tpu_torch.models import create_network

    cfg = config(name)
    net = create_network(cfg["port_network"],
                         **family(cfg["family"]).program_kwargs(cfg))
    counter = FlopCounterMode(display=False)
    size = cfg["image_size"]
    with torch.no_grad(), counter:
        net(torch.zeros((1, size, size, 3)))
    assert work.forward_flops(cfg) == counter.get_total_flops()


@pytest.mark.parametrize("name,gflop", [("resnet50_face", 8.06),
                                        ("iresnet100", 24.18)])
def test_published_counts(name, gflop):
    cfg = config(name)
    assert work.forward_flops(cfg) / 1e9 == pytest.approx(gflop, abs=0.01)
    assert work.face_flops(cfg) == 2 * work.forward_flops(cfg)


@pytest.mark.parametrize("store", ["bfloat16", "float32", "int8"])
def test_topk_bytes_are_the_tensors(store):
    """The store's rows, the tombstone bias and the probes a search
    reads, and its (score, row) results, as the gallery holds them."""
    from tf_face_toolbox_tpu_torch.serving.gallery import DeviceGallery

    rows, dim, b, k = 3000, 512, 64, 5
    g = DeviceGallery(dim, dtype=store, block=1000, device="cpu")
    g.enroll(np.eye(rows, dim, dtype=np.float32), np.arange(rows))
    store_t = g._dev[:rows]
    expect = (store_t.numel() * store_t.element_size()
              + g._dev_bias[:rows].numel() * 4
              + b * dim * 4 + b * k * (4 + 4))
    if store == "int8":
        expect += g._dev_scale[:rows].numel() * 4
    assert work.topk_bytes(rows, dim, store, b, k) == expect
    assert work.topk_flops(rows, dim, b) == 2 * rows * dim * b


def test_layers_follow_the_shapes():
    """Every stage's blocks at the published widths and sizes."""
    layers, leaves = arch.layers_of(config("resnet50_face"))
    assert layers[0].h_out == 112 and layers[-2].h_out == 7
    assert sum(1 for lay in layers if lay.kind == "conv") == 53
    layers, leaves = arch.layers_of(config("iresnet100"))
    assert sum(np.prod(leaf.shape) for leaf in leaves) == 65_225_792
    assert layers[-1].cin == 512 * 7 * 7
