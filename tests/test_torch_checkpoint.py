"""The port's checkpoints: save, restore, resume, GC, the best-eval
checkpoint, and serving-time restore (``pretrained.load_variables``).

Round trips are bit-exact for every tensor, the SGD momentum buffers and
the optimizer's count. Resume is held two ways: k steps, a save, a
restore into a fresh state and N - k more steps equal N straight steps
bit for bit in f32 (through the step function and through
``train_loop``), and match the JAX ``make_train_step`` after the same
steps with ``tests/test_torch_trainer.py``'s tolerance.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from tests.test_torch_trainer import (
    CASES,
    _assert_states_close,
    _batches,
    _jax_case,
    _port_run,
    BASE,
)
from tf_face_toolbox_tpu_torch.interop.port import (
    jax_leaves,
    named_to_flat,
    to_jax_layout,
)
from tf_face_toolbox_tpu_torch.pretrained import load_variables
from tf_face_toolbox_tpu_torch.train import checkpoint as ckpt
from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager
from tf_face_toolbox_tpu_torch.train.loop import train_loop
from tf_face_toolbox_tpu_torch.train.trainer import (
    TrainConfig,
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)

TINY = dict(network="resnet_tiny", num_classes=6, embedding_dim=16,
            image_size=16, crop_from=20, global_batch=8)


def _cfg(**kw):
    return TrainConfig(**{**TINY, **kw})


def _u8_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (8, 20, 20, 3), np.uint8),
             "label": rng.integers(0, 6, 8)} for _ in range(n)]


def _trained(cfg, steps, seed=0):
    state, net = create_train_state(cfg, seed, device="cpu")
    step_fn = make_train_step(net, cfg, state)
    for b in _u8_batches(steps):
        state, _ = step_fn(state, b["image"], b["label"])
    return state, net


def _full(state):
    """Host copies of every tensor of ``state`` (momentum buffers
    included), and (step, count, rng)."""
    opt = state.opt_state["optimizer"]
    out = {f"params/{k}": v for k, v in state.params.items()}
    out.update({f"batch_stats/{k}": v for k, v in state.batch_stats.items()})
    out["classifier"] = state.classifier
    for k, v in (state.ema_params or {}).items():
        out[f"ema/{k}"] = v
    for name, p in {**state.params, "classifier": state.classifier}.items():
        buf = opt.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            out[f"momentum/{name}"] = buf
    return ({k: v.detach().cpu().clone() for k, v in out.items()},
            (state.step, state.opt_state["count"], state.rng))


def _assert_bit_equal(a, b):
    (ta, sa), (tb, sb) = a, b
    assert sa == sb
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


@pytest.mark.parametrize("ema", [0.0, 0.9], ids=["no_ema", "ema"])
def test_round_trip_is_bit_exact(tmp_path, ema):
    cfg = _cfg(ema_decay=ema)
    state, _ = _trained(cfg, 2)
    mgr = CheckpointManager(str(tmp_path / "c"), save_every=1)
    assert mgr.maybe_save(state, force=True)
    mgr.wait()
    fresh, _ = create_train_state(cfg, 42, device="cpu")
    assert not torch.equal(fresh.classifier, state.classifier)
    restored = mgr.restore(fresh)
    assert restored is fresh
    _assert_bit_equal(_full(restored), _full(state))
    assert any(k.startswith("momentum/") for k in _full(restored)[0])
    assert mgr.has_ema() is (ema > 0)
    assert mgr.latest_step() == 2 and mgr.all_steps() == [2]
    mgr.close()


def test_restore_keeps_the_optimizer_and_sets_its_momentum(tmp_path):
    """The optimizer keeps its parameter references, and the momentum
    buffers are the checkpoint's: a state that has stepped (and so has
    buffers) restored from a step-0 checkpoint (none) has none, rather
    than keeping its own."""
    cfg = _cfg()
    state, _ = create_train_state(cfg, 0, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.maybe_save(state, force=True)
    stepped, _ = _trained(cfg, 1, seed=5)
    opt = stepped.opt_state["optimizer"]
    refs = [p for g in opt.param_groups for p in g["params"]]
    assert len(opt.state) > 0
    mgr.restore(stepped)
    assert [p for g in opt.param_groups for p in g["params"]] == refs
    assert not any(opt.state.get(p) for p in refs)
    assert (stepped.step, stepped.opt_state["count"]) == (0, 0)
    _assert_bit_equal(_full(stepped), _full(state))


def test_a_skipped_step_holds_the_saved_count(tmp_path):
    """count is saved apart from step: after a skipped step they differ,
    and the restored learning rate follows the count."""
    cfg = _cfg(augment=False, skip_nonfinite=True)
    state, net = create_train_state(cfg, 0, device="cpu")
    step_fn = make_train_step(net, cfg, state)
    rng = np.random.default_rng(0)
    for i in range(3):
        x = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
        if i == 1:
            x[0, 0, 0, 0] = np.nan
        state, m = step_fn(state, x, rng.integers(0, 6, 8))
    assert (state.step, state.opt_state["count"]) == (3, 2)
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.maybe_save(state, force=True)
    meta = mgr.metadata()
    assert (meta["step"], meta["count"]) == (3, 2)
    fresh, _ = create_train_state(cfg, 1, device="cpu")
    _assert_bit_equal(_full(mgr.restore(fresh)), _full(state))


def test_cadence_and_keep_drops_the_oldest(tmp_path):
    cfg = _cfg()
    state, _ = create_train_state(cfg, 0, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "c"), save_every=2, keep=2)
    saved = []
    for step in range(1, 7):
        state.step = step
        saved.append(mgr.maybe_save(state))
    assert saved == [False, True, False, True, False, True]
    assert mgr.all_steps() == [4, 6]
    assert sorted(os.listdir(mgr.directory)) == ["4", "6"]
    # a step already on disk is kept as it is
    assert mgr.maybe_save(state, force=True)
    assert mgr.all_steps() == [4, 6]


def test_a_crash_before_the_rename_leaves_the_previous_step(tmp_path,
                                                            monkeypatch):
    cfg = _cfg()
    state, _ = create_train_state(cfg, 0, device="cpu")
    d = str(tmp_path / "c")
    mgr = CheckpointManager(d, save_every=1)
    state.step = 1
    mgr.maybe_save(state)

    def crash(src, dst):
        raise OSError("killed between the write and the rename")

    state.step = 2
    monkeypatch.setattr(ckpt.os, "replace", crash)
    with pytest.raises(OSError, match="killed"):
        mgr.maybe_save(state)
    monkeypatch.undo()
    assert os.path.isdir(os.path.join(d, ".2.tmp"))   # the torn write
    assert CheckpointManager(d).latest_step() == 1
    assert CheckpointManager(d).all_steps() == [1]
    # the next save of that step replaces the torn write
    assert mgr.maybe_save(state)
    assert mgr.all_steps() == [1, 2]
    assert not os.path.exists(os.path.join(d, ".2.tmp"))


def test_restore_raw_metadata_and_shapes(tmp_path):
    cfg = _cfg(ema_decay=0.5, subcenters=2)
    state, _ = _trained(cfg, 1)
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.maybe_save(state, force=True)
    raw = mgr.restore_raw()
    assert (raw["step"], raw["count"], raw["rng"]) == (1, 1, 0)
    assert torch.equal(raw["classifier"], state.classifier.detach())
    assert raw["params"].keys() == state.params.keys()
    assert raw["ema_params"].keys() == state.params.keys()
    assert raw["momentum"].keys() == {*state.params, "classifier"}
    shapes = mgr.global_shapes()
    assert shapes["classifier"] == (12, 16)        # C * K rows
    assert shapes["params/ConvBN_0.weight"] == (64, 3, 3, 3)
    assert mgr.head_state_children() == set()
    with open(os.path.join(mgr.directory, "1", "meta.json")) as f:
        assert json.load(f)["has_ema"] is True
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        CheckpointManager(str(tmp_path / "empty")).restore_raw()


def test_refresh_sees_another_managers_saves(tmp_path):
    cfg = _cfg()
    state, _ = create_train_state(cfg, 0, device="cpu")
    d = str(tmp_path / "c")
    watcher = CheckpointManager(d)
    assert watcher.latest_step() is None
    state.step = 3
    CheckpointManager(d).maybe_save(state, force=True)
    watcher.refresh()
    assert watcher.latest_step() == 3


def test_restore_refuses_a_mismatched_template(tmp_path):
    state, _ = create_train_state(_cfg(), 0, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.maybe_save(state, force=True)
    with pytest.raises(ValueError, match="EMA"):
        mgr.restore(create_train_state(_cfg(ema_decay=0.9), 0,
                                       device="cpu")[0])
    with pytest.raises(ValueError, match="classifier"):
        mgr.restore(create_train_state(_cfg(num_classes=7), 0,
                                       device="cpu")[0])


# (case, steps before the save): the skip_nonfinite case saves after its
# skipped step, so count != step is in the checkpoint
_RESUME = [("cosface", 1), ("ema", 2), ("skip_nonfinite", 2)]


@pytest.mark.parametrize("name,k", _RESUME, ids=[c for c, _ in _RESUME])
def test_resume_equals_straight_run_and_matches_jax(tmp_path, name, k):
    """k steps, a save, a restore into a fresh state, 3 - k more steps:
    bit-equal to the port's 3 straight steps, and within the trainer
    parity tolerance of the JAX trainer's 3 steps."""
    flat, cls, want_m, want = _jax_case(name)
    nan_at = 1 if name == "skip_nonfinite" else None
    _, straight, straight_state = _port_run(CASES[name], flat, cls,
                                            nan_at=nan_at)
    cfg = TrainConfig(**{**BASE, **CASES[name], "dtype": torch.float32})
    batches = _batches(nan_at)
    state, net = create_train_state(cfg, 0, variables=flat, classifier=cls,
                                    device="cpu")
    step_fn = make_train_step(net, cfg, state)
    for x, y in batches[:k]:
        state, _ = step_fn(state, x, y)
    mgr = CheckpointManager(str(tmp_path / "run"), save_every=k)
    assert mgr.maybe_save(state)
    fresh, net2 = create_train_state(cfg, 9, device="cpu")
    fresh = mgr.restore(fresh)
    step_fn = make_train_step(net2, cfg, fresh)
    metrics = []
    for x, y in batches[k:]:
        fresh, m = step_fn(fresh, x, y)
        metrics.append({key: float(v) for key, v in m.items()})
    _assert_bit_equal(_full(fresh), _full(straight_state))
    got = {"vars": named_to_flat({**fresh.params, **fresh.batch_stats}),
           "classifier": fresh.classifier.detach().numpy(),
           "ema": (named_to_flat(fresh.ema_params)
                   if fresh.ema_params is not None else None),
           "step": fresh.step}
    _assert_states_close(got, straight[-1], rtol=0, atol=0)
    _assert_states_close(got, want[-1], rtol=1e-3, atol=3e-4)
    for g, w in zip(metrics, want_m[k:]):
        for key in w:
            if np.isfinite(w[key]):
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                           err_msg=key)


def test_loop_resume_is_exact_with_augment_erase_dropout_and_ema(tmp_path):
    """train_loop through a train_dir: 2 steps, then a new loop resumes
    and takes 2 more; bit-equal to 4 straight steps. The augment crop
    and flips, random erasing and the flatten head's dropout draw from
    generators seeded from (rng, step, stream), so the resumed steps
    redraw what the straight run drew."""
    cfg = _cfg(ema_decay=0.9, random_erase=0.5, head_variant="flatten",
               dropout_rate=0.3)
    batches = _u8_batches(4, seed=3)
    straight = train_loop(cfg, iter(batches), num_steps=4, log_every=0,
                          rng_seed=7, device="cpu").state
    d = str(tmp_path / "run")
    first = train_loop(cfg, iter(batches[:2]), num_steps=2, log_every=0,
                       train_dir=d, save_every=100, rng_seed=7,
                       device="cpu")
    assert first.state.step == 2
    assert CheckpointManager(d).all_steps() == [2]      # the final flush
    resumed = train_loop(cfg, iter(batches[2:]), num_steps=4, log_every=0,
                         train_dir=d, save_every=100, rng_seed=99,
                         device="cpu").state
    _assert_bit_equal(_full(resumed), _full(straight))
    assert CheckpointManager(d).all_steps() == [2, 4]


def test_loop_resume_refuses_an_ema_mismatch(tmp_path):
    d = str(tmp_path / "run")
    train_loop(_cfg(), iter(_u8_batches(1)), num_steps=1, log_every=0,
               train_dir=d, device="cpu")
    with pytest.raises(ValueError, match="--ema_decay=0"):
        train_loop(_cfg(ema_decay=0.9), iter(_u8_batches(1)), num_steps=2,
                   log_every=0, train_dir=d, device="cpu")


def test_preempted_loop_flushes_at_the_current_step(tmp_path):
    d = str(tmp_path / "run")
    calls = iter([False, False, False, True])
    result = train_loop(_cfg(), iter(_u8_batches(5)), num_steps=5,
                        log_every=0, train_dir=d, save_every=100,
                        should_stop=lambda: next(calls), device="cpu")
    assert result.last_metrics["preempted"] == 1.0
    assert result.state.step == 3
    assert CheckpointManager(d).all_steps() == [3]


def test_keep_best_checkpoint(tmp_path):
    """--keep_best: the best eval's state survives in <train_dir>/best
    with its bar recorded, and the bar persists across a resumed run (a
    later worse eval never demotes it)."""
    d = str(tmp_path / "run")
    scripted = iter([0.5, 0.9, 0.7])

    def eval_fn(state):
        return {"lfw_accuracy": next(scripted)}

    train_loop(_cfg(), iter(_u8_batches(3)), num_steps=3, log_every=1,
               train_dir=d, save_every=1, eval_fn=eval_fn, eval_every=1,
               keep_best="lfw_accuracy", device="cpu")
    mgr = CheckpointManager(d)
    assert mgr.best_info() == {"step": 2, "metric": 0.9,
                               "name": "lfw_accuracy"}
    best = CheckpointManager(os.path.join(d, "best"))
    assert best.latest_step() == 2
    scripted = iter([0.6])
    train_loop(_cfg(), iter(_u8_batches(1)), num_steps=4, log_every=1,
               train_dir=d, save_every=1, eval_fn=eval_fn, eval_every=1,
               keep_best="lfw_accuracy", device="cpu")
    assert CheckpointManager(d).best_info()["step"] == 2
    assert best.all_steps() == [2]


def test_save_best_bar_logic(tmp_path):
    """save_best only fires on strict improvement; <dir>/best keeps one
    step."""
    state, _ = create_train_state(_cfg(), 0, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "d"))
    assert mgr.save_best(state, step=1, metric=0.5, name="m") is True
    assert mgr.save_best(state, step=2, metric=0.5, name="m") is False
    assert mgr.save_best(state, step=3, metric=0.6, name="m") is True
    mgr.wait()
    assert mgr.best_info() == {"step": 3, "metric": 0.6, "name": "m"}
    assert CheckpointManager(str(tmp_path / "d" / "best")).all_steps() == [3]
    assert mgr.all_steps() == []            # the ring is apart


def test_eval_metrics_are_logged_and_an_unknown_keep_best_warns(
        tmp_path, caplog):
    logged = []

    class Logger:
        def log(self, step, scalars):
            logged.append((step, dict(scalars)))

        def flush(self):
            pass

    with caplog.at_level(logging.WARNING):
        train_loop(_cfg(), iter(_u8_batches(4)), num_steps=4, log_every=0,
                   train_dir=str(tmp_path / "run"), logger=Logger(),
                   eval_fn=lambda s: {"acc": 0.5}, eval_every=2,
                   keep_best="lfw_accuracy", device="cpu")
    assert logged == [(2, {"eval/acc": 0.5}), (4, {"eval/acc": 0.5})]
    warned = [r for r in caplog.records if "keep_best" in r.getMessage()]
    assert len(warned) == 1
    assert CheckpointManager(str(tmp_path / "run")).best_info() is None


@pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema"])
def test_load_variables_serves_a_checkpoint(tmp_path, use_ema):
    """The flat JAX-key variables are the state's (its EMA params with
    the running statistics under use_ema), read with no template, and
    load into a module that gives the state's embeddings."""
    from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
    from tf_face_toolbox_tpu_torch.models import create_network

    cfg = _cfg(num_classes=11, ema_decay=0.5)
    state, net = _trained(cfg, 2)
    d = str(tmp_path / "c")
    CheckpointManager(d).maybe_save(state, force=True)
    got_net, flat = load_variables(d, "resnet_tiny", 16, 16, torch.float32,
                                   use_ema=use_ema)
    names = {id(t): n for n, t in net.named_parameters()}
    for key, t, kind in jax_leaves(net):
        if use_ema and id(t) in names:
            t = state.ema_params[names[id(t)]]
        np.testing.assert_array_equal(flat[key], to_jax_layout(t, kind),
                                      err_msg=key)
    assert not got_net.training
    x = torch.randn(2, 16, 16, 3)
    ref = create_network("resnet_tiny", embedding_dim=16)
    load_jax_variables(ref, flat)
    with torch.no_grad():
        torch.testing.assert_close(got_net(x), ref(x), rtol=0, atol=0)
    CheckpointManager(str(tmp_path / "n")).maybe_save(
        _trained(_cfg(), 1)[0], force=True)
    with pytest.raises(ValueError, match="no EMA"):
        load_variables(str(tmp_path / "n"), "resnet_tiny", 16, 16,
                       torch.float32, use_ema=True)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_variables(str(tmp_path / "none"), "resnet_tiny", 16, 16,
                       torch.float32)


def test_load_variables_pins_a_step_and_refuses_another_network(tmp_path):
    """``step`` serves a retained earlier checkpoint; a network whose
    tree differs from the checkpoint's raises instead of loading part
    of it."""
    cfg = _cfg()
    state, net = _trained(cfg, 1)
    d = str(tmp_path / "c")
    mgr = CheckpointManager(d)
    mgr.maybe_save(state, force=True)
    want = {key: to_jax_layout(t, kind) for key, t, kind in jax_leaves(net)}
    state, _ = _trained(cfg, 2)
    mgr.maybe_save(state, force=True)
    assert mgr.all_steps() == [1, 2]
    _, flat = load_variables(d, "resnet_tiny", 16, 16, torch.float32, step=1)
    assert flat.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(flat[key], want[key], err_msg=key)
    with pytest.raises(ValueError, match="do not match the network"):
        load_variables(d, "resnet_tiny", 16, 16, torch.float32,
                       stem="imagenet", head="flatten")


def test_checkpoints_hold_no_jax_types(tmp_path):
    """The files are torch tensors and JSON: they load with
    weights_only=True (no pickled classes)."""
    state, _ = _trained(_cfg(ema_decay=0.5), 1)
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.maybe_save(state, force=True)
    raw = torch.load(os.path.join(mgr.directory, "1", "state.pt"),
                     weights_only=True)
    assert set(raw) == {"params", "batch_stats", "classifier", "momentum",
                        "ema_params"}
