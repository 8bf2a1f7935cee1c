"""Every input a cell makes repeats exactly from its seed and differs
from one seed to the next: weights, faces, gallery rows, requests, the
Seeds past 32 bits are whole numbers like
any other."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from port_bench import weights
from port_bench.kinds import identify

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (7, 2**31 + 5, 2**40 + 3)


def load(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def tiny_resnet() -> dict:
    cfg = load("configs", "resnet50_face.json")
    cfg.update(stage_sizes=[1, 1], width_per_group=8, image_size=32,
               crop_from=36)
    return cfg


def same_and_different(make):
    a, b, c = (make(s) for s in SEEDS)
    again = make(SEEDS[1])
    flat = [np.concatenate([np.asarray(x, np.float64).ravel()
                            for x in (v if isinstance(v, tuple) else (v,))])
            for v in (a, b, c, again)]
    assert np.array_equal(flat[1], flat[3])
    assert not np.array_equal(flat[0], flat[1])
    assert not np.array_equal(flat[1], flat[2])


def test_variables():
    cfg = tiny_resnet()
    same_and_different(lambda s: np.concatenate(
        [v.ravel() for v in weights.make_variables(cfg, s, "cpu").values()]))


def test_faces():
    same_and_different(lambda s: weights.make_faces(s, 5, 36, "cpu"))
    faces = weights.make_faces(3, 5, 36, "cpu")
    assert faces.dtype == np.uint8 and faces.shape == (5, 36, 36, 3)
    assert len({f.tobytes() for f in faces}) == 5


def test_gallery_rows_and_requests():
    t = load("traffic", "identify_b64_k5.json")
    t.update(batch=8, request_pool=4, removed_rows=3)

    def rows(seed):
        return np.concatenate([r.numpy() for _, r in identify.gallery_rows(
            seed, 300, 16, 128, "cpu")])

    same_and_different(rows)
    r = rows(11)
    assert np.allclose(np.linalg.norm(r, axis=1), 1, atol=1e-6)
    # a block is the same whichever is asked for first
    lo, block = list(identify.gallery_rows(11, 300, 16, 128, "cpu"))[2]
    assert np.array_equal(block.numpy(), identify.unit_block(
        11, 2, 300 - 256, 16, "cpu").numpy())
    same_and_different(lambda s: identify.make_requests(s, t, rows(s),
                                                        "cpu"))
    probes, dead = identify.make_requests(11, t, r, "cpu")
    assert probes.shape == (4, 8, 16) and len(dead) <= 3
    # the copies match their rows best; the removed rows are among them
    best = (probes[:, :4].reshape(-1, 16) @ r.T).argmax(axis=1)
    assert set(dead) <= set(best)


@pytest.mark.parametrize("name", sorted(
    f[:-len(".json")] for f in os.listdir(os.path.join(HERE, "traffic"))))
def test_traffic_is_data(name):
    t = load("traffic", name + ".json")
    assert os.path.exists(os.path.join(HERE, "kinds",
                                       t["kind"] + ".py"))
    assert 1 <= len(t["why"]) <= 200
