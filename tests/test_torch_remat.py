"""Block remat in the port's ResNet (``remat=True`` and ``"save_convs"``).

Mirrors tests/test_models.py::test_save_convs_remat_grads_match and
tests/test_train.py::test_remat_blocks_train_and_match, and adds what
the JAX tests lack: with ``accum_steps`` 1 and 2, three train steps
with remat leave the BN running statistics (and everything else) equal
to those without. A recompute in backward runs each block's BatchNorms
again, and a BatchNorm already in the step's ``TrainContext`` starts
from its updated statistics, so an unguarded recompute would advance
them twice. Remat recomputes the same f32 operations on the same
inputs in one process, so the checks are exact (rtol 0), tighter than
the JAX test's 1e-5.
"""

import numpy as np
import pytest
import torch

from tf_face_toolbox_tpu_torch.models import create_network, init_parameters
from tf_face_toolbox_tpu_torch.models.layers import TrainContext
from tf_face_toolbox_tpu_torch.train.trainer import (
    TrainConfig,
    build_network,
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)

REMAT = [True, "save_convs"]
KW = dict(stage_sizes=(1, 1), width_per_group=16, embedding_dim=8,
          stem="face")


def _pair(remat):
    base = create_network("resnet_tiny", **KW)
    init_parameters(base, 0)
    with torch.no_grad():
        # non-zero branch scales, so gradients reach every block's convs
        for name, p in base.named_parameters():
            if name.endswith("BatchNorm_0.weight"):
                p.fill_(0.7)
    net = create_network("resnet_tiny", **KW, remat=remat)
    net.load_state_dict(base.state_dict())
    return base, net


def _grads(net, x):
    ctx = TrainContext()
    out = net(x, train=ctx)
    out.square().sum().backward()
    return ({n: p.grad.clone() for n, p in net.named_parameters()},
            {m: tuple(t.clone() for t in v) for m, v in ctx.stats.items()})


@pytest.mark.parametrize("remat", REMAT, ids=str)
def test_remat_grads_match(remat):
    """A scheduling change: the same gradients and the same updated
    running statistics from one train-mode forward."""
    base, net = _pair(remat)
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    g1, s1 = _grads(base, x)
    g2, s2 = _grads(net, x)
    assert g1.keys() == g2.keys()
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], rtol=0, atol=0, msg=k)
    names = {m: n for n, m in base.named_modules()}
    names2 = {m: n for n, m in net.named_modules()}
    got = {names2[m]: v for m, v in s2.items()}
    assert got.keys() == {names[m] for m in s1}
    for m, (mean, var) in s1.items():
        assert torch.equal(got[names[m]][0], mean)
        assert torch.equal(got[names[m]][1], var)


@pytest.mark.parametrize("remat", REMAT, ids=str)
def test_remat_blocks_train_and_match(remat):
    """The eval forward is the same function, and a train step runs."""
    base, net = _pair(remat)
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(net(x), base(x), rtol=0, atol=1e-6)
    cfg = TrainConfig(network="resnet_tiny", num_classes=6, embedding_dim=8,
                      image_size=16, crop_from=20, global_batch=8)
    state, net = create_train_state(cfg, 1, net=create_network(
        "resnet_tiny", **KW, remat=remat), device="cpu")
    step = make_train_step(net, cfg, state)
    images = np.random.default_rng(2).integers(0, 256, (8, 20, 20, 3),
                                               np.uint8)
    state, m = step(state, images, np.arange(8) % 6)
    assert np.isfinite(float(m["loss"])) and state.step == 1


def _three_steps(remat, accum):
    cfg = TrainConfig(network="resnet_tiny", num_classes=6, embedding_dim=16,
                      image_size=16, crop_from=20, global_batch=8,
                      accum_steps=accum, ema_decay=0.9)
    net = build_network(cfg, remat=remat, stage_sizes=(1, 1))
    state, net = create_train_state(cfg, 0, net=net, device="cpu")
    step = make_train_step(net, cfg, state)
    rng = np.random.default_rng(0)
    for _ in range(3):
        images = rng.integers(0, 256, (8, 20, 20, 3), np.uint8)
        state, _ = step(state, images, rng.integers(0, 6, 8))
    out = {**state.params, **state.batch_stats, "classifier": state.classifier}
    out.update({f"ema/{k}": v for k, v in state.ema_params.items()})
    return {k: v.detach().clone() for k, v in out.items()}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("remat", REMAT, ids=str)
def test_remat_keeps_the_running_statistics(remat, accum):
    """Three augmented steps with remat equal three without, bit for
    bit: params, classifier, EMA and the BN running statistics, which a
    recompute must not advance again (with accum_steps 2, the second
    micro-batch's forward starts from what the first's backward, and
    its recompute, left)."""
    want = _three_steps(False, accum)
    got = _three_steps(remat, accum)
    assert got.keys() == want.keys()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 10     # the stem, 4 + 4 in blocks, the head
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("remat", REMAT, ids=str)
def test_remat_keeps_the_state_dict_names(remat):
    base, net = _pair(remat)
    assert list(net.state_dict()) == list(base.state_dict())
    assert [n for n, _ in net.named_parameters()] == [
        n for n, _ in base.named_parameters()]


def test_remat_refuses_an_unknown_policy():
    with pytest.raises(ValueError, match="unknown remat"):
        create_network("resnet_tiny", remat="everything")


def test_bench_remat_grads_on_the_host():
    """``bench_train.remat_grads`` (the smoke's remat check) on a tiny
    net: each remat's gradients equal those without."""
    from tf_face_toolbox_tpu_torch import bench_train

    cfg = TrainConfig(network="resnet_tiny", num_classes=6, embedding_dim=16,
                      image_size=16, crop_from=20, global_batch=8)
    g = torch.Generator().manual_seed(3)
    images = torch.randint(0, 256, (8, 20, 20, 3), generator=g,
                           dtype=torch.uint8)
    got = bench_train.remat_grads(cfg, images, torch.arange(8) % 6,
                                  device="cpu")
    assert set(got) == {"True", "save_convs"}
    for r in got.values():
        assert r["max_abs_diff"] == 0 and r["min_cos"] > 1 - 1e-12
