"""The port's train step with the loss heads against the JAX package's.

For each of MagFace, AdaFace, CurricularFace, center loss and batch-hard
triplet: three steps of the port's ``make_train_step`` on one device
against the JAX ``make_train_step`` on a one-device mesh, each step
taken from the JAX trainer's state before it (losses, metrics, every
leaf and the head state: AdaFace's statistics, t, the centers); then
four gloo ranks (``torch_dist.Ranks``, spawned once for the module)
against JAX's ``create_mesh(data=2, model=2)`` and against
``parallel.reference.replica_loop_step(model=2)`` (triplet on a model
axis of 4, data 1: its mining pool is a data row's batch, so a data
axis legitimately changes it, as tests/test_adaptive_losses.py says).
Why each step starts from the reference's state: three straight f32
steps flip a ReLU about half the time at these sizes
(tests/test_torch_parallel_model.py). Tolerances: JAX's state rtol
1e-4, and atol 2e-6 (the momentum's over the learning rate) or 1e-5 of
the tensor's largest value where that is more (the classifier's
gradient reaches ~24 here, as its rows are N(0, 0.01): f32 noise of
that size shows at its small elements); metrics rtol 1e-4; the plain
version at f32 rounding (rtol 1e-5 of each value, or of its tensor's
largest where smaller). On the grid one step from JAX's state can still
flip a ReLU whose input sits within f32 noise of 0 (measured: the
CurricularFace and center cases' second step, one unit at the block
output, whose channel's two BN biases move up to 9.4e-5 apart and the
stem kernel up to 4.1e-4), so there the weights and momentum are held
to JAX by each leaf's update cosine (>= 0.999, as the smoke holds the
card), the BN statistics, the head state and the metrics as above, and
everything at f32 rounding to the plain version.

Also: the refusals (accumulation with a stateful head, CurricularFace
with the sampled head), a skipped step holding the head state, the
head state through a checkpoint at data 2 x model 2 (the centers
gathered to (C_pad, D) and re-sliced), a resume that changes the heads,
``pretrained.load_variables`` on a sub-center + center checkpoint, the
P x K sampler index-exact with JAX's, and ``cli.train`` with
``--balanced_pk``, ``--center_loss`` and ``--triplet_loss``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_model as tpm
import torch_dist as td
from tf_face_toolbox_tpu.data.pipeline import (
    FaceShardSource as JaxSource,
    balanced_batch_iterator as jax_balanced,
)
from tf_face_toolbox_tpu.interop.port import flatten_variables
from tf_face_toolbox_tpu.models.resnet import ResNet as JaxResNet
from tf_face_toolbox_tpu.ops import losses as jl
from tf_face_toolbox_tpu.parallel.mesh import create_mesh
from tf_face_toolbox_tpu.train import trainer as jt
from tf_face_toolbox_tpu_torch.cli import train as cli_train
from tf_face_toolbox_tpu_torch.data.format import pack_arrays
from tf_face_toolbox_tpu_torch.data.pipeline import (
    FaceShardSource,
    balanced_batch_iterator,
)
from tf_face_toolbox_tpu_torch.ops import losses as tl
from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager
from tf_face_toolbox_tpu_torch.train.loop import train_loop
from tf_face_toolbox_tpu_torch.train.trainer import (
    TrainConfig,
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)

ONE = 16          # rows of the one-device runs
ROWS = tpm.ROWS   # 64 rows on the grid, 16 a rank
# the MagFace range around the tiny net's embedding norms (~4), so that
# the margin and the regularizer move with the norm
MAGFACE = dict(l_a=2.0, u_a=8.0, l_m=0.2, u_m=0.5, lambda_g=2.0)
CASES = {
    "magface": dict(margin_mode="magface", margin_m3=0.0, magface=MAGFACE),
    "adaface": dict(margin_mode="adaface", margin_m3=0.0),
    "curricular": dict(margin_mode="curricular", margin_m2=0.3,
                       margin_m3=0.0),
    "center": dict(center_weight=0.01, subcenters=2),
    "triplet": dict(triplet_weight=0.5),
}
# the grid's (data, model): triplet mines within a data row
GRID = {name: (1, 4) if name == "triplet" else (2, 2) for name in CASES}


@pytest.fixture(scope="module")
def ranks():
    with td.Ranks(4) as r:
        yield r


def _kw(name, jax_side: bool, **extra) -> dict:
    kw = {**CASES[name], **extra}
    if "magface" in kw:
        cls = jl.MagFaceConfig if jax_side else tl.MagFaceConfig
        kw["magface"] = cls(**kw["magface"])
    return kw


def _jax_snapshot(state):
    snap = tpm._jax_snapshot(state)
    head = state.head_state
    snap["head"] = None if not head else {
        f"{name}/{k}" if isinstance(v, dict) else name: np.array(leaf)
        for name, v in head.items()
        for k, leaf in (v.items() if isinstance(v, dict) else [(None, v)])}
    return snap


@functools.lru_cache(maxsize=None)
def _jax_case(name, data, model, rows):
    """(flat variables, global classifier, metrics, snapshots) of three
    JAX steps on a (data, model) mesh."""
    cfg = jt.TrainConfig(**{**td.BASE, **_kw(name, True),
                            "global_batch": rows, "dtype": jnp.float32})
    mesh = create_mesh(data=data, model=model,
                       devices=jax.devices()[:data * model])
    net = JaxResNet(stage_sizes=(1,), width_per_group=16, embedding_dim=16)
    state, net = jt.create_train_state(cfg, jax.random.key(3), mesh, net=net)
    flat = flatten_variables({"params": tpm._np(state.params),
                              "batch_stats": tpm._np(state.batch_stats)})
    cls = np.array(state.classifier)
    step = jt.make_train_step(net, cfg, mesh, state)
    metrics, snaps = [], []
    for x, y in td.batches(rows=rows, seed=tpm.DATA_SEED):
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        metrics.append({k: float(v) for k, v in m.items()})
        snaps.append(_jax_snapshot(state))
    return flat, cls, metrics, snaps


def _assert_jax_close(got, want):
    """``got`` against JAX's snapshot ``want`` (the module's tolerance)."""
    for path, a, b in tpm._walk(got, want):
        atol = 2e-6 / tpm.LR if path.startswith("/momentum") else 2e-6
        np.testing.assert_allclose(
            a, b, rtol=1e-4, atol=max(atol, 1e-5 * np.abs(b).max()),
            err_msg=path)


def _walk3(got, want, start, path=""):
    """(path, got, want, start) of each array leaf of ``want``; ``start``
    may lack a subtree (None: zeros, no momentum yet)."""
    if isinstance(want, dict):
        for k in want:
            yield from _walk3(got[k], want[k],
                              None if start is None else start.get(k),
                              f"{path}/{k}")
    elif want is None or isinstance(want, (int, float)):
        assert got == want, path
    else:
        yield path, got, want, np.zeros_like(want) if start is None else start


def _assert_jax_updates(got, want, start):
    """A grid step from ``start`` against JAX's: each weight's and
    momentum's update cosine >= 0.999, the rest at the module's
    tolerance. The Dense bias ahead of the head's BatchNorm has no
    gradient in exact arithmetic: its update is rounding noise."""
    for path, a, b, s in _walk3(got, want, start):
        if path.endswith("EmbeddingHead_0/Dense_0/bias"):
            continue
        if path.startswith(("/vars/params", "/classifier", "/momentum")):
            u, v = (a - s).ravel().astype(np.float64), (b - s).ravel()
            if u.any() or v.any():
                cos = u @ v / (np.linalg.norm(u) * np.linalg.norm(v))
                assert cos >= 0.999, (path, cos)
        else:
            np.testing.assert_allclose(
                a, b, rtol=1e-4, atol=max(2e-6, 1e-5 * np.abs(b).max()),
                err_msg=path)


def _start(name, flat, cls, model=1) -> dict:
    """A fresh state's snapshot from ``flat`` and ``cls``, its head state
    the port's initial one."""
    cfg = TrainConfig(**{**td.BASE, **_kw(name, False),
                         "dtype": torch.float32})
    state, _ = create_train_state(cfg, 0, classifier=cls, device="cpu",
                                  whole_classifier=True, mesh=td.Topology(
                                      data=1, model=model))
    return {**tpm._start(flat, cls),
            "head": td.head_snapshot(state.head_state)}


@pytest.mark.parametrize("name", list(CASES))
def test_three_steps_match_jax_on_one_device(name):
    """Each step from JAX's state before it, on the same f32 batch: the
    loss, the metrics (the head's terms, AdaFace's mean, t) and the state
    after it, the head state included."""
    flat, cls, want_m, want = _jax_case(name, 1, 1, ONE)
    cfg = TrainConfig(**{**td.BASE, **_kw(name, False), "global_batch": ONE,
                         "dtype": torch.float32})
    data = td.batches(rows=ONE, seed=tpm.DATA_SEED)
    got = []
    for snap, (x, y) in zip([_start(name, flat, cls), *want[:-1]], data):
        state, net = td.state_at(snap, cfg)
        state, m = make_train_step(net, cfg, state)(state, x, y)
        got.append(({k: float(v) for k, v in m.items()},
                    td.snapshot(state)))
    for (m, snap), w in zip(got, want, strict=True):
        _assert_jax_close(snap, w)
    tpm._assert_metrics([m for m, _ in got], want_m, rtol=1e-4)
    assert {"center": "center_loss", "triplet": "triplet_loss",
            "magface": "magface_reg_loss", "adaface": "adaface_norm_mean",
            "curricular": "curricular_t"}[name] in got[0][0]
    if name == "center":
        assert np.abs(got[-1][1]["head"]["centers"]).max() > 0


def _check_grid(out, model):
    """The ranks' runs: the same metrics and replicated state on every
    rank, each model index's classifier and center shards the same on
    every data rank (bit for bit); the snapshots with the shards of data
    row 0 reassembled."""
    def replicated(snap):
        head = dict(snap["head"] or {})
        head.pop("centers", None)
        return {**snap, "classifier": None, "head": head,
                "momentum": {**snap["momentum"], "classifier": None}}

    def shards(snap):
        return (snap["classifier"], snap["momentum"]["classifier"],
                (snap["head"] or {}).get("centers"))

    (m0, s0, _), *others = out
    for m, s, _ in others:
        assert m == m0
        for a, b in zip(s, s0, strict=True):
            for path, x, y in tpm._walk(replicated(a), replicated(b)):
                assert np.array_equal(x, y), path
    for r in range(model, len(out)):
        for a, b in zip(out[r][1], out[r % model][1]):
            for x, y in zip(shards(a), shards(b)):
                assert (x is None and y is None) or np.array_equal(x, y)
    return m0, [td.join_shards([out[r][1][k] for r in range(model)])
                for k in range(len(s0))]


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_jax_and_the_plain_version(ranks, name):
    """Four gloo ranks at data 2 x model 2 (triplet: 1 x 4), each step
    from the JAX trainer's state before it, against JAX's state after it
    and against replica_loop_step's step from the same state."""
    data, model = GRID[name]
    flat, cls, want_m, want = _jax_case(name, data, model, ROWS)
    kw = {**_kw(name, False), "global_batch": ROWS, "dtype": torch.float32}
    run = dict(model=model, data_seed=tpm.DATA_SEED)
    starts = [_start(name, flat, cls, model), *want[:-1]]
    metrics, forced = _check_grid(tpm._forced(ranks.run(
        td.steps_from, cfg_kw=kw, starts=starts, **run)), model)
    for got, w, start in zip(forced, want, starts, strict=True):
        _assert_jax_updates(got, w, start)
    tpm._assert_metrics(metrics, want_m, rtol=1e-4)
    plain = td.steps_from(None, kw, starts, world=4, **run)
    for got, (_, w) in zip(forced, plain, strict=True):
        tpm._assert_rounding(got, w)
    tpm._assert_metrics(metrics, [m for m, _ in plain], rtol=1e-5)


def test_adaface_with_centers_trains_three_straight_steps_on_the_grid(ranks):
    """AdaFace with center loss and 2 sub-centers, three straight steps
    at 2 x 2: every rank ends with the same statistics, and each center
    shard on its two data ranks; the centers moved."""
    kw = dict(margin_mode="adaface", margin_m3=0.0, center_weight=0.01,
              subcenters=2, num_classes=13, global_batch=ROWS,
              dtype=torch.float32)
    out = ranks.run(td.train_steps, cfg_kw=kw, model=2, classes=13,
                    data_seed=tpm.DATA_SEED)
    metrics, snaps = _check_grid(out, 2)
    assert snaps[-1]["head"]["centers"].shape == (14, 16)
    assert np.abs(snaps[-1]["head"]["centers"]).max() > 0
    assert metrics[-1]["adaface_norm_mean"] != 20.0
    assert all(np.isfinite(m["loss"]) for m in metrics)


# ----------------------------------------------------------- refusals


@pytest.mark.parametrize("kw", [dict(margin_mode="magface"),
                                dict(margin_mode="adaface"),
                                dict(margin_mode="curricular"),
                                dict(center_weight=0.1)],
                         ids=["magface", "adaface", "curricular", "center"])
def test_accumulation_refuses_a_stateful_head(kw):
    with pytest.raises(ValueError, match="stateless losses only"):
        TrainConfig(accum_steps=2, **kw)


def test_triplet_accumulates_and_curricular_refuses_sampling():
    assert TrainConfig(accum_steps=2, triplet_weight=0.1).accum_steps == 2
    with pytest.raises(ValueError, match="curricular"):
        TrainConfig(margin_mode="curricular", pfc_sample_rate=0.5)
    with pytest.raises(ValueError, match="unknown margin_mode"):
        TrainConfig(margin_mode="sphere")


def test_a_skipped_step_holds_the_head_state():
    """skip_nonfinite: a NaN in step 1's batch holds AdaFace's statistics
    and the centers with every other leaf; the steps around it move
    them."""
    kw = dict(td.BASE, margin_mode="adaface", margin_m3=0.0,
              center_weight=0.01, skip_nonfinite=True, global_batch=ONE)
    cfg = TrainConfig(**kw)
    state, net = create_train_state(cfg, 0, device="cpu")
    step = make_train_step(net, cfg, state)
    heads, skipped = [], []
    for x, y in td.batches(nan_at=1, rows=ONE):
        state, m = step(state, x, y)
        heads.append(td.head_snapshot(state.head_state))
        skipped.append(m["skipped_nonfinite"])
    assert skipped == [0.0, 1.0, 0.0]
    for k in heads[0]:
        np.testing.assert_array_equal(heads[1][k], heads[0][k])
        assert not np.array_equal(heads[2][k], heads[1][k]), k


# -------------------------------------------------------- checkpoints


def test_head_state_checkpoint_at_two_by_two(ranks, tmp_path):
    """A 2 x 2 save holds the global (C_pad, D) centers (13 classes
    padded to 14) and AdaFace's statistics; every rank restores its
    center shard and the rest bit for bit."""
    run = str(tmp_path / "run")
    kw = dict(num_classes=13, subcenters=2, margin_mode="adaface",
              margin_m3=0.0, center_weight=0.01, dtype=torch.float32)
    out = ranks.run(td.checkpoint_round_trip, train_dir=run, model=2,
                    cfg_kw=kw)
    for r in out:
        for path, a, b in tpm._walk(r["saved"], r["restored"]):
            assert np.array_equal(a, b), path
        assert "28 rows, this run's 32" in r["error"], r["error"]
    shapes = out[0]["shapes"]
    assert shapes["head_state/centers"] == (14, 16)
    assert shapes["head_state/adaface/norm_mean"] == ()
    raw = CheckpointManager(run).restore_raw()
    whole = td.join_shards([out[0]["saved"], out[1]["saved"]])
    np.testing.assert_array_equal(raw["head_state"]["centers"].numpy(),
                                  whole["head"]["centers"])
    assert np.abs(whole["head"]["centers"]).max() > 0


def test_restore_refuses_other_heads_or_center_rows(tmp_path):
    """A resume with other loss flags raises naming the heads; a center
    table of another row count raises naming both counts."""
    def batches():
        for x, y in td.batches(steps=10, rows=ONE):
            yield {"image": x, "label": y}

    base = dict(td.BASE, global_batch=ONE)
    run = str(tmp_path / "run")
    train_loop(TrainConfig(**base, center_weight=0.01), batches(),
               num_steps=1, train_dir=run, save_every=1, log_every=0,
               device="cpu")
    with pytest.raises(ValueError, match="loss-head state"):
        train_loop(TrainConfig(**base, margin_mode="adaface"), batches(),
                   num_steps=2, train_dir=run, save_every=1, log_every=0,
                   device="cpu")
    state, _ = create_train_state(TrainConfig(**base, center_weight=0.01),
                                  0, device="cpu")
    state.head_state["centers"] = torch.zeros(td.CLASSES - 2, 16)
    with pytest.raises(ValueError, match="centers have 12 rows, this run's "
                                         "10"):
        CheckpointManager(run).restore(state)


def test_load_variables_serves_a_subcenter_center_checkpoint(tmp_path):
    """pretrained.load_variables on a checkpoint trained with 2
    sub-centers and center loss (classifier C * K rows, centers C): the
    backbone as trained; the head state is not needed to serve."""
    from tf_face_toolbox_tpu_torch.interop.port import named_to_flat
    from tf_face_toolbox_tpu_torch.pretrained import load_variables

    cfg = TrainConfig(**dict(td.BASE, global_batch=ONE, subcenters=2,
                             center_weight=0.01, margin_mode="curricular"))
    state, net = create_train_state(cfg, 0, device="cpu")
    x, y = td.batches(steps=1, rows=ONE)[0]
    state, _ = make_train_step(net, cfg, state)(state, x, y)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.maybe_save(state, force=True)
    assert mgr.head_state_children() == {"centers", "curricular"}
    assert state.classifier.shape[0] == 2 * state.head_state[
        "centers"].shape[0]
    _, flat = load_variables(str(tmp_path / "ck"), "resnet_tiny", 16, 16,
                             torch.float32)
    want = named_to_flat({**state.params, **state.batch_stats})
    assert flat.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])


# ------------------------------------------------------- P x K sampler


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """60 raw 20 x 20 faces: identities 0-9 with 2-9 images each."""
    path = tmp_path_factory.mktemp("pk") / "faces.faceshard"
    rng = np.random.default_rng(0)
    labels = np.concatenate([[i] * (2 + i % 8) for i in range(10)])
    labels = labels[rng.permutation(len(labels))]
    faces = rng.integers(0, 256, (len(labels), 20, 20, 3), dtype=np.uint8)
    pack_arrays(str(path), faces, labels.tolist())
    return str(path)


@pytest.mark.parametrize("hosts", [(0, 1), (1, 2)])
def test_balanced_batches_are_jax_s(shard, hosts):
    """The same record ids, images and labels as JAX's sampler for each
    step (a host's records with two hosts), from step 0 and resumed at
    step 3; P identities of K images each."""
    index, count = hosts
    p, k = 3, 2
    port = balanced_batch_iterator(
        FaceShardSource(shard, seed=5, host_index=index, host_count=count),
        ids_per_batch=p, images_per_id=k, num_threads=1)
    want = jax_balanced(
        JaxSource(shard, seed=5, host_index=index, host_count=count),
        ids_per_batch=p, images_per_id=k, num_threads=1)
    got = [next(port) for _ in range(5)]
    for g, w in zip(got, [next(want) for _ in range(5)]):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])
        assert g["step"] == w["step"] and g["epoch"] == 0
        ids, counts = np.unique(g["label"], return_counts=True)
        assert len(ids) == p and (counts == k).all()
    resumed = next(balanced_batch_iterator(
        FaceShardSource(shard, seed=5, host_index=index, host_count=count),
        ids_per_batch=p, images_per_id=k, start_step=3, num_threads=2))
    np.testing.assert_array_equal(resumed["image"], got[3]["image"])


def test_balanced_batches_refuse_thin_identities(shard):
    with pytest.raises(ValueError, match=r"only 3 identities have >= 7"):
        next(balanced_batch_iterator(FaceShardSource(shard), ids_per_batch=5,
                                     images_per_id=7))


TINY = ["--device=cpu", "--network=resnet_tiny", "--embedding_dim=16",
        "--image_size=16", "--crop_from=20", "--nobf16", "--log_every=1"]


def test_cli_trains_pk_batches_with_center_and_triplet(shard, tmp_path,
                                                       capsys):
    """--balanced_pk 4,2 on a shard with center loss and triplet: P x K
    batches, the terms logged, a resume by the global step."""
    argv = [*TINY, f"--data={shard}", "--global_batch=8",
            "--balanced_pk=4,2", "--center_loss=0.01", "--triplet_loss=0.5",
            f"--train_dir={tmp_path / 'run'}", "--save_every=2"]
    cli_train.main([*argv, "--num_steps=2"])
    cli_train.main([*argv, "--num_steps=3"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("done: step=3 loss=")
    assert np.isfinite(float(out[-1].split("loss=")[1]))
    ck = CheckpointManager(str(tmp_path / "run"))
    assert ck.head_state_children() == {"centers"}
    assert ck.global_shapes()["head_state/centers"] == (10, 16)


@pytest.mark.parametrize("argv,why", [
    (["--balanced_pk=4,2"], "ONE FaceShard"),
    (["--balanced_pk=4"], "must be 'P,K'"),
    (["--balanced_pk=3,2", "--data=SHARD"], r"P\*K=6 must equal"),
    (["--balanced_pk=4,2", "--data=SHARD", "--loader=native"],
     "python-loader"),
    (["--margin=adaface", "--margin_value=0.3"], "does not apply"),
], ids=["synthetic", "format", "batch", "loader", "margin_value"])
def test_cli_refusals_of_the_loss_head_flags(shard, argv, why):
    argv = [a.replace("SHARD", shard) for a in argv]
    with pytest.raises(SystemExit, match=why):
        cli_train.main([*TINY, "--global_batch=8", "--num_steps=1", *argv])


@pytest.mark.parametrize("margin,mode,m", [
    ("magface", "magface", (1.0, 0.0, 0.0)),
    ("adaface", "adaface", (1.0, 0.0, 0.0)),
    ("curricular", "curricular", (1.0, 0.5, 0.0))])
def test_cli_margin_rules_are_jax_s(margin, mode, m):
    """JAX's --margin rules: magface and adaface on zero base margins,
    curricular's ArcFace margin 0.5 (--margin_value sets it); the
    MagFace and AdaFace flags reach their configs."""
    args = cli_train.parse_args([f"--margin={margin}", "--magface_lm=0.3",
                                 "--adaface_h=0.5", "--center_loss=0.2"])
    cfg = cli_train.build_config(args, 10)
    assert cfg.margin_mode == mode
    assert (cfg.margin_m1, cfg.margin_m2, cfg.margin_m3) == m
    assert cfg.magface == dataclasses.replace(tl.MagFaceConfig(), l_m=0.3)
    assert cfg.adaface == dataclasses.replace(tl.AdaFaceConfig(), h=0.5)
    assert cfg.center_weight == 0.2
    if margin == "curricular":
        args = cli_train.parse_args(["--margin=curricular",
                                     "--margin_value=0.4"])
        assert cli_train.build_config(args, 10).margin_m2 == 0.4


def test_the_adaface_preset_through_the_cli_is_preset_8():
    """--preset adaface_noisy_data builds the preset's TrainConfig (AdaFace
    on its base CosFace 0.35, 3 sub-centers, random erase, cosine LR over
    its 220,000 steps); an explicit --margin adaface takes the zero base
    margins of JAX's CLI."""
    from tf_face_toolbox_tpu_torch import configs

    argv = ["--preset=adaface_noisy_data", "--network=resnet_tiny",
            "--image_size=16", "--crop_from=20"]
    args = cli_train.parse_args(argv)
    cli_train.apply_preset(args, argv, world=1)
    want = dataclasses.replace(configs.get_config("adaface_noisy_data"),
                               network="resnet_tiny", image_size=16,
                               crop_from=20)
    assert cli_train.build_config(args, args.num_classes) == want
    argv = [*argv, "--margin=adaface"]
    args = cli_train.parse_args(argv)
    cli_train.apply_preset(args, argv, world=1)
    assert cli_train.build_config(args, args.num_classes) == \
        dataclasses.replace(want, margin_m3=0.0)
