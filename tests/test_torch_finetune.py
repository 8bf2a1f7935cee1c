"""Warm start (fine-tune) of the port: ``train.finetune``.

Mirrors tests/test_finetune.py (backbone and BN grafted; classifier,
optimizer and step fresh; mismatched leaves skipped by shape; resume
beats warm start; the CLI's ``--finetune_from``), and holds the port
against the JAX package: fed the same ``.npz``, both restore and skip
the same leaf names, and their next step agrees within the trainer
parity tolerance of the first step (tests/test_torch_trainer.py).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_trainer import BASE, _assert_states_close, _jax_snapshot
from tf_face_toolbox_tpu.interop.port import flatten_variables as jax_flatten
from tf_face_toolbox_tpu.interop.port import save_variables_npz as jax_save_npz
from tf_face_toolbox_tpu.models import create_network as jax_network
from tf_face_toolbox_tpu.models import init_variables as jax_init
from tf_face_toolbox_tpu.parallel.mesh import create_mesh
from tf_face_toolbox_tpu.train import finetune as jft
from tf_face_toolbox_tpu.train import trainer as jt
from tf_face_toolbox_tpu_torch.cli import train as cli_train
from tf_face_toolbox_tpu_torch.data.format import pack_arrays
from tf_face_toolbox_tpu_torch.interop.port import (
    named_to_flat,
    save_variables_npz,
    unflatten_variables,
)
from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager
from tf_face_toolbox_tpu_torch.train.finetune import (
    graft_tree,
    load_pretrained_variables,
    warm_start_state,
)
from tf_face_toolbox_tpu_torch.train.loop import train_loop
from tf_face_toolbox_tpu_torch.train.trainer import (
    TrainConfig,
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)

# the JAX test's CFG
KW = dict(network="resnet_tiny", num_classes=12, embedding_dim=16,
          image_size=16, global_batch=16, base_lr=0.05, warmup_steps=0,
          margin_m3=0.0, margin_scale=16.0, weight_decay=0.0, augment=False)
CFG = TrainConfig(**KW)


def _state(cfg=CFG, seed=0):
    return create_train_state(cfg, seed, device="cpu")


def _source(embedding_dim=16, seed=99):
    """Random backbone variables (nested, JAX key space) of a port
    resnet_tiny: a run's params and batch statistics."""
    src, _ = create_train_state(
        TrainConfig(**{**KW, "embedding_dim": embedding_dim}), seed,
        device="cpu")
    with torch.no_grad():
        for t in src.batch_stats.values():
            t.add_(torch.rand(t.shape))
    return unflatten_variables(named_to_flat({**src.params,
                                              **src.batch_stats}))


def _named(state):
    return {**state.params, **state.batch_stats}


def _equal_trees(state, variables):
    flat = named_to_flat(_named(state))
    src = jax_flatten(variables)
    return all(np.array_equal(flat[k], src[k]) for k in flat)


@pytest.mark.parametrize("leaf", ["numpy", "torch"])
def test_graft_tree_copies_matching_and_skips_rest(leaf):
    arr = np.asarray if leaf == "numpy" else torch.tensor
    dst = {"a": arr(np.zeros((2, 3))), "b": {"w": arr(np.zeros(4)),
                                            "missing": arr(np.zeros(2))},
           "shape_clash": arr(np.zeros((5,)))}
    src = {"a": np.ones((2, 3)), "b": {"w": np.full(4, 7.0)},
           "shape_clash": np.ones((6,)), "extra": np.ones(9)}
    out, restored, skipped = graft_tree(dst, src)
    assert type(out["a"]) is type(dst["a"])
    np.testing.assert_array_equal(np.asarray(out["a"]), 1.0)
    np.testing.assert_array_equal(np.asarray(out["b"]["w"]), 7.0)
    np.testing.assert_array_equal(np.asarray(out["b"]["missing"]), 0.0)
    np.testing.assert_array_equal(np.asarray(out["shape_clash"]), 0.0)
    assert sorted(restored) == ["a", "b/w"]
    assert any(s.startswith("b/missing") for s in skipped)
    assert any("shape" in s for s in skipped)
    # the same lists as the JAX package's graft
    _, j_restored, j_skipped = jft.graft_tree(
        {k: (np.asarray(v) if not isinstance(v, dict) else
             {kk: np.asarray(vv) for kk, vv in v.items()})
         for k, v in dst.items()}, src)
    assert (restored, skipped) == (j_restored, j_skipped)


def test_warm_start_grafts_backbone_keeps_classifier_fresh():
    state, net = _state()
    cls = state.classifier.detach().clone()
    src = _source()
    assert not _equal_trees(state, src)
    new = warm_start_state(state, src)
    assert new is state
    assert _equal_trees(new, src)
    torch.testing.assert_close(new.classifier, cls, rtol=0, atol=0)
    assert new.step == 0 and new.opt_state["count"] == 0
    assert not new.opt_state["optimizer"].state
    # the grafted state trains
    step_fn = make_train_step(net, CFG, new)
    new, m = step_fn(new, np.zeros((16, 16, 16, 3), np.float32),
                     np.arange(16) % 12)
    assert np.isfinite(float(m["loss"]))


def test_warm_start_restarts_ema_from_grafted_weights():
    state, _ = _state(TrainConfig(**{**KW, "ema_decay": 0.9}))
    new = warm_start_state(state, _source())
    for k, e in new.ema_params.items():
        assert torch.equal(e, new.params[k]), k


def test_warm_start_skips_mismatched_head_restores_convs():
    """A source with a different embedding_dim restores every conv/BN
    and skips only the head projection (and its BN), by shape."""
    state, _ = _state()
    fresh = named_to_flat(_named(state))
    src = jax_flatten(_source(embedding_dim=8))
    logs = []
    new = warm_start_state(state, unflatten_variables(src),
                           log=lambda fmt, *a: logs.append(fmt % a))
    assert logs and "kept fresh" in logs[0]
    got = named_to_flat(_named(new))
    matched = mismatched = 0
    for k, v in got.items():
        if k in src and src[k].shape == v.shape:
            np.testing.assert_array_equal(v, src[k])
            matched += 1
        else:
            np.testing.assert_array_equal(v, fresh[k])
            mismatched += 1
    assert matched > 0 and mismatched > 0


def test_warm_start_raises_on_foreign_tree():
    state, _ = _state()
    with pytest.raises(ValueError, match="restored nothing"):
        warm_start_state(state, {"params": {"not": np.zeros(3)}})


def test_load_pretrained_from_npz(tmp_path):
    src = _source()
    path = str(tmp_path / "vars.npz")
    save_variables_npz(path, src)
    got = load_pretrained_variables(path)
    want = jax_flatten(src)
    flat = jax_flatten(got)
    assert flat.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])
    with pytest.raises(ValueError, match="use_ema"):
        load_pretrained_variables(path, use_ema=True)


def test_load_pretrained_from_train_dir_and_full_cycle(tmp_path):
    """Pretrain 2 steps -> checkpoint -> a fine-tune run with another
    identity count warm-starts from it: backbone equals the checkpointed
    weights, the classifier is task-sized and fresh; a run with another
    embedding_dim grafts every conv/BN and skips the head (the raw
    restore makes that a graft-time skip, not a restore error)."""
    state, net = _state()
    step_fn = make_train_step(net, CFG, state)
    for _ in range(2):
        state, _ = step_fn(state, np.zeros((16, 16, 16, 3), np.float32),
                           np.arange(16) % 12)
    mgr = CheckpointManager(str(tmp_path / "pre"), save_every=1)
    assert mgr.maybe_save(state, force=True)
    pre = named_to_flat(_named(state))

    ft, _ = _state(TrainConfig(**{**KW, "num_classes": 5}), seed=1)
    pretrained = load_pretrained_variables(str(tmp_path / "pre"))
    new = warm_start_state(ft, pretrained)
    got = named_to_flat(_named(new))
    for k in pre:
        np.testing.assert_array_equal(got[k], pre[k])
    assert new.classifier.shape[0] == 5 != state.classifier.shape[0]
    assert new.step == 0

    big, _ = _state(TrainConfig(**{**KW, "embedding_dim": 32}), seed=2)
    grafted = warm_start_state(big, pretrained)
    assert grafted.params["EmbeddingHead_0.Dense_0.weight"].shape[0] == 32
    assert torch.equal(grafted.params["ConvBN_0.weight"],
                       state.params["ConvBN_0.weight"])
    with pytest.raises(ValueError, match="no EMA"):
        load_pretrained_variables(str(tmp_path / "pre"), use_ema=True)


def test_load_pretrained_ema_from_train_dir(tmp_path):
    cfg = TrainConfig(**{**KW, "ema_decay": 0.5})
    state, net = _state(cfg)
    step_fn = make_train_step(net, cfg, state)
    state, _ = step_fn(state, np.ones((16, 16, 16, 3), np.float32),
                       np.arange(16) % 12)
    CheckpointManager(str(tmp_path / "pre")).maybe_save(state, force=True)
    got = jax_flatten(load_pretrained_variables(str(tmp_path / "pre"),
                                                use_ema=True))
    want = named_to_flat({**state.ema_params, **state.batch_stats})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_train_loop_resume_beats_warm_start(tmp_path):
    """warm_start does not fire when train_dir already holds a
    checkpoint: a preempted fine-tune run resumes its own progress."""
    def batches():
        while True:
            yield {"image": np.zeros((16, 16, 16, 3), np.float32),
                   "label": (np.arange(16) % 12).astype(np.int32)}

    train_dir = str(tmp_path / "run")
    fired = []

    def warm(state):
        fired.append(True)
        return state

    train_loop(CFG, batches(), num_steps=1, train_dir=train_dir,
               save_every=1, log_every=1, warm_start=warm, device="cpu")
    assert fired == [True]
    train_loop(CFG, batches(), num_steps=2, train_dir=train_dir,
               save_every=1, log_every=1, warm_start=warm, device="cpu")
    assert fired == [True]


@pytest.mark.parametrize("src_dim", [16, 8], ids=["same_tree", "other_head"])
def test_warm_start_matches_jax(tmp_path, src_dim):
    """Both packages' warm starts from one JAX-written .npz, into the same
    fresh variables and classifier: the same leaves restored and skipped
    (the same log line, the same graft lists), the same grafted tree,
    and the same next step, on the trainer parity test's settings."""
    mesh = create_mesh(data=1, devices=jax.devices()[:1])
    jcfg = jt.TrainConfig(**BASE, dtype=jnp.float32)
    cfg = TrainConfig(**BASE)
    jstate, jnet = jt.create_train_state(jcfg, jax.random.key(0), mesh)
    src_net = jax_network("resnet_tiny", embedding_dim=src_dim,
                          dtype=jnp.float32)
    src = jax_init(src_net, jax.random.key(99), (1, 16, 16, 3))
    npz = str(tmp_path / "src.npz")
    jax_save_npz(npz, dict(src))

    fresh = jax_flatten({"params": jax.tree.map(np.asarray, jstate.params),
                         "batch_stats": jax.tree.map(np.asarray,
                                                     jstate.batch_stats)})
    state, net = create_train_state(cfg, 0, variables=fresh,
                                    classifier=np.asarray(jstate.classifier),
                                    device="cpu")
    jlogs, tlogs = [], []
    jvars = jft.load_pretrained_variables(npz)
    jstate = jft.warm_start_state(jstate, jvars,
                                  log=lambda f, *a: jlogs.append(f % a))
    state = warm_start_state(state, load_pretrained_variables(npz),
                             log=lambda f, *a: tlogs.append(f % a))
    assert tlogs == jlogs
    _, j_restored, j_skipped = jft.graft_tree(
        jax.tree.map(np.asarray, dict(jstate.params)), jvars["params"])
    dst = unflatten_variables(named_to_flat(state.params))["params"]
    _, restored, skipped = graft_tree(dst, load_pretrained_variables(
        npz)["params"])
    assert (restored, skipped) == (j_restored, j_skipped)

    def snap(st, step):
        return {"vars": named_to_flat(_named(st)),
                "classifier": st.classifier.detach().numpy(), "ema": None,
                "step": step}

    # the grafted states are equal, bit for bit
    _assert_states_close(snap(state, 0), _jax_snapshot(jstate), rtol=0,
                         atol=0)
    x = np.random.default_rng(1).standard_normal((16, 16, 16, 3)).astype(
        np.float32)
    y = (np.arange(16) % 12).astype(np.int32)
    jstate, jm = jt.make_train_step(jnet, jcfg, mesh, jstate)(
        jstate, jnp.asarray(x), jnp.asarray(y))
    state, m = make_train_step(net, cfg, state)(state, x, y)
    # the trainer parity test's tolerance after its third step: the
    # source's untrained flax init gives larger gradients than a trained
    # state, and f32 reduction order moves a classifier value by ~3e-6
    _assert_states_close(snap(state, 1), _jax_snapshot(jstate), rtol=1e-3,
                         atol=3e-4)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)


def _shard(path, n=24, size=20):
    faces = np.random.default_rng(0).integers(0, 256, (n, size, size, 3),
                                              dtype=np.uint8)
    pack_arrays(str(path), faces, [i % 4 for i in range(n)])
    return str(path)


@pytest.mark.parametrize("source", ["train_dir", "jax_npz"])
def test_cli_finetune_from(tmp_path, capsys, caplog, source):
    """--finetune_from a port train dir or a JAX .npz: a new run on
    another identity count warm-starts from it."""
    shard = _shard(tmp_path / "data.faceshard")
    common = ["--device=cpu", "--network=resnet_tiny", "--embedding_dim=16",
              "--image_size=12", "--crop_from=16", "--global_batch=8",
              "--nobf16", "--save_every=2", "--log_every=1",
              f"--data={shard}", "--loader=python"]
    if source == "train_dir":
        cli_train.main([*common, f"--train_dir={tmp_path / 'pre'}",
                        "--num_steps=2"])
        src = str(tmp_path / "pre")
    else:
        jnet = jax_network("resnet_tiny", embedding_dim=16,
                           dtype=jnp.float32)
        src = str(tmp_path / "jax.npz")
        jax_save_npz(src, dict(jax_init(jnet, jax.random.key(3),
                                        (1, 12, 12, 3))))
    capsys.readouterr()
    caplog.set_level(logging.INFO)
    cli_train.main([*common, f"--train_dir={tmp_path / 'ft'}",
                    "--num_steps=2", "--num_classes=9",
                    f"--finetune_from={src}"])
    out = capsys.readouterr().out
    assert "done: step=2" in out
    assert any("warm start" in r.getMessage() for r in caplog.records)
    assert CheckpointManager(str(tmp_path / "ft")).global_shapes()[
        "classifier"] == (9, 16)
