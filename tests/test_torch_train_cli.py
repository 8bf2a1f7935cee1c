"""The port's training entry points on the CPU: ``cli.train``, the loop,
the training iterators and the metric logger.

The trainer's numbers are held against the JAX package in
tests/test_torch_trainer.py, checkpoints in tests/test_torch_checkpoint.py;
here the command line and the loop around it run end to end with
``--device cpu`` and ``resnet_tiny``: SIGTERM and resume, the data
stream's alignment on resume, and the in-training LFW hook (against
the JAX package's extraction and verification).
"""

import inspect
import logging
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tf_face_toolbox_tpu.data.pipeline import (
    FaceShardSource as JaxSource,
    batch_iterator as jax_batch_iterator,
)
from tf_face_toolbox_tpu_torch.cli import train as cli_train
from tf_face_toolbox_tpu_torch.cli.eval_lfw import load_pairs
from tf_face_toolbox_tpu_torch.data.format import pack_arrays
from tf_face_toolbox_tpu_torch.data.pipeline import (
    FaceShardSource,
    batch_iterator,
    device_prefetch,
    host_prefetch,
    native_batch_iterator,
)
from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager
from tf_face_toolbox_tpu_torch.train.loop import train_loop
from tf_face_toolbox_tpu_torch.train.trainer import (
    TrainConfig,
    create_train_state,
)
from tf_face_toolbox_tpu_torch.utils.metrics import MetricLogger

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device=cpu", "--network=resnet_tiny", "--embedding_dim=16",
        "--image_size=16", "--crop_from=20", "--global_batch=8",
        "--num_steps=4", "--log_every=2", "--nobf16"]


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """24 raw 20x20 faces of 6 identities."""
    path = tmp_path_factory.mktemp("train_cli") / "faces.faceshard"
    faces = np.random.default_rng(0).integers(0, 256, (24, 20, 20, 3),
                                              dtype=np.uint8)
    pack_arrays(str(path), faces, [i % 6 for i in range(24)])
    return str(path)


def test_cli_trains_on_synthetic_data_in_a_subprocess():
    proc = subprocess.run(
        [sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.train", *TINY,
         "--data=synthetic", "--num_classes=10", "--pallas_input"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1].startswith("done: step=4 loss=")
    # on the CPU the kernel's plain version runs: no launch
    assert "kernel launches: preprocess=0" in lines
    assert "step 2: loss=" in proc.stderr and "step 4: loss=" in proc.stderr


@pytest.mark.parametrize("loader", ["native", "python"])
def test_cli_trains_on_a_packed_shard(shard, loader, capsys):
    cli_train.main([*TINY, f"--data={shard}", f"--loader={loader}",
                    "--margin=arcface", "--ema_decay=0.9"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("done: step=4 loss=")
    loss = float(out[-1].split("loss=")[1])
    assert np.isfinite(loss)


# every flag of the JAX CLI whose path is not ported: (argv, item)
def _set(name, default):
    if isinstance(default, bool):
        return [f"--{name}"]
    if isinstance(default, str):
        return [f"--{name}=x"]
    return [f"--{name}={default + (1 if isinstance(default, int) else 0.25)}"]


# --drop_path (item 17b) raised naming it until it was ported: it now
# refuses only a net with no transformer blocks, as JAX's trainer does
_REFUSED = [(["--drop_path=0.25"], "ViT-family knob")]
# --qat (item 18) raised naming it until it was ported: it now trains
# (its steps are held against JAX in tests/test_torch_qat.py)
_REFUSED += [(["--qat"], None)]
# item 9's flags (the loss heads) raised naming it until it was ported:
# each now trains (why None), and a malformed --balanced_pk refuses
_ITEM_9 = {"magface_la": 10.0, "magface_ua": 110.0, "magface_lm": 0.45,
           "magface_um": 0.8, "magface_lambda_g": 35.0, "adaface_m": 0.4,
           "adaface_h": 0.333, "center_loss": 0.0, "center_alpha": 0.5,
           "triplet_loss": 0.0, "triplet_margin": 0.3, "balanced_pk": ""}
_REFUSED += [(_set(name, d), "must be 'P,K'" if name == "balanced_pk"
              else None) for name, d in _ITEM_9.items()]
_REFUSED += [(argv, None) for argv in (
    ["--margin=adaface"], ["--margin=magface"], ["--margin=curricular"])]
# --loader=native_dct (item 17b) is ported: it entropy-decodes a recoded
# FaceShard, so synthetic data refuses it (a shard trains in
# tests/test_torch_dct.py)
_REFUSED += [(["--loader=native_dct"], "ONE FaceShard")]
# item 10c's flags raised naming it until it was ported: each now trains
# (a teacher trained in the module's fixture, ``{teacher}``)
_REFUSED += [(argv, None) for argv in (
    ["--distill_from={teacher}", "--distill_network=resnet_tiny"],
    ["--distill_network=resnet_tiny", "--distill_from={teacher}"],
    ["--distill_stem=imagenet"], ["--distill_head=flatten"],
    ["--distill_alpha=0.5", "--distill_network=resnet_tiny",
     "--distill_from={teacher}"],
    ["--distill_use_ema", "--distill_network=resnet_tiny",
     "--distill_from={teacher}"],
    ["--optimizer=lars"])]
# item 4's stem raised naming it until it was ported: it now trains
_REFUSED += [(["--stem=space2depth"], None)]
# item 11's flags are served: each refuses only what it cannot do (a
# model axis wider than the ranks; sampling classes that sub-centers
# split)
_REFUSED += [(["--mesh_model=2"], "1 ranks not divisible by model=2"),
             (["--pfc_sample_rate=0.5", "--subcenters=2"],
              "cannot pool sub-centers")]


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """A train dir of 2 resnet_tiny steps with EMA: a distillation
    teacher."""
    run = str(tmp_path_factory.mktemp("teacher") / "run")
    cli_train.main([*TINY, "--data=synthetic", "--num_classes=10",
                    "--num_steps=2", f"--train_dir={run}", "--save_every=2",
                    "--ema_decay=0.9"])
    return run


@pytest.mark.parametrize("argv,why", _REFUSED,
                         ids=[a[0].split("=")[0] for a, _ in _REFUSED])
def test_unported_flags_raise_naming_their_item(argv, why, capsys, request):
    if any("{teacher}" in a for a in argv):
        run = request.getfixturevalue("teacher")
        argv = [a.replace("{teacher}", run) for a in argv]
        capsys.readouterr()
    if why is None:      # ported since: the flag trains
        cli_train.main([*TINY, *argv])
        out = capsys.readouterr().out.strip().splitlines()
        assert out[-1].startswith("done: step=4 loss="), out
        return
    with pytest.raises(SystemExit, match=why):
        cli_train.main([*TINY, *argv])


def test_flags_keep_the_jax_defaults():
    from tf_face_toolbox_tpu.cli import train as jax_cli   # noqa: F401
    from absl import flags

    args = vars(cli_train.parse_args([]))
    for name, value in args.items():
        if name in ("device", "preset"):    # the port's own flags
            continue
        want = flags.FLAGS[name].default
        if name == "lr_boundaries":
            want = ",".join(want)
        assert value == want, name


def test_entry_points_default_to_the_card():
    for fn in (create_train_state, train_loop):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert cli_train.parse_args([]).device == "cuda"


def _tiny_cfg(**kw):
    return TrainConfig(network="resnet_tiny", num_classes=6,
                       embedding_dim=16, image_size=16, crop_from=20,
                       global_batch=8, **kw)


def test_loop_logs_and_counts_skips():
    rng = np.random.default_rng(0)

    def batches(nan_at):
        i = 0
        while True:
            x = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
            if nan_at(i):
                x[0, 0, 0, 0] = np.nan
            i += 1
            yield {"image": x, "label": rng.integers(0, 6, 8)}

    logged = []

    class Logger(MetricLogger):
        def log(self, step, scalars):
            logged.append((step, super().log(step, scalars)))

    cfg = _tiny_cfg(augment=False, skip_nonfinite=True)
    result = train_loop(cfg, batches(lambda i: i in (1, 2)), num_steps=5,
                        log_every=2,
                        logger=Logger(batch_size=8), device="cpu")
    assert result.state.step == 5
    assert result.state.opt_state["count"] == 3
    assert [s for s, _ in logged] == [2, 4, 5]
    assert logged[0][1]["skipped_nonfinite_total"] == 1.0
    assert result.last_metrics["skipped_nonfinite_total"] == 2.0
    assert "faces_per_sec" in logged[1][1]
    with pytest.raises(FloatingPointError, match="consecutive"):
        train_loop(cfg, batches(lambda i: i >= 1), num_steps=5, log_every=0,
                   max_consecutive_skips=2, device="cpu")


def test_loop_raises_on_an_unguarded_nonfinite_loss():
    def batches():
        while True:
            yield {"image": np.full((8, 16, 16, 3), np.nan, np.float32),
                   "label": np.zeros(8, np.int64)}

    with pytest.raises(FloatingPointError, match="non-finite loss"):
        train_loop(_tiny_cfg(augment=False), batches(), num_steps=2,
                   log_every=1, device="cpu")


def test_loop_refuses_a_teacher_naming_item_10c():
    """Distillation (item 10c) raised here until it was ported: the loop
    now trains a student against a teacher (a module or (module,
    variables)) and logs its distill loss."""
    from tf_face_toolbox_tpu_torch.models import init_parameters
    from tf_face_toolbox_tpu_torch.train.trainer import build_network

    cfg = _tiny_cfg(augment=False)
    teacher = build_network(cfg)
    init_parameters(teacher, 7)
    rng = np.random.default_rng(0)
    batches = ({"image": rng.standard_normal((8, 16, 16, 3)).astype(
        np.float32), "label": rng.integers(0, 6, 8)} for _ in range(3))
    result = train_loop(cfg, batches, num_steps=3, log_every=1,
                        device="cpu", teacher=teacher)
    assert result.state.step == 3
    assert np.isfinite(result.last_metrics["distill_loss"])
    assert "margin_loss" not in result.last_metrics


@pytest.mark.parametrize("argv,why", [
    (["--keep_best=lfw_accuracy", "--train_dir=run"], "needs --eval_data"),
    (["--keep_best=lfw_accuracy", "--eval_data=a", "--eval_pairs=b",
      "--eval_every=1"], "pass --train_dir")], ids=["no_eval", "no_train_dir"])
def test_keep_best_refusals(argv, why):
    with pytest.raises(SystemExit, match=why):
        cli_train.main([*TINY, *argv])


def test_cli_train_preemption_flush(tmp_path):
    """SIGTERM mid-training flushes a checkpoint at the CURRENT step and
    exits 0; the same command then continues from it."""
    run = str(tmp_path / "run")
    args = [sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.train",
            *TINY, "--data=synthetic", "--num_classes=10",
            f"--train_dir={run}", "--num_steps=100000",
            "--save_every=100000", "--log_every=1"]
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.Popen(args, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    captured = []
    stepped = threading.Event()

    def reader():
        for line in proc.stdout:
            captured.append(line)
            if re.match(r"step [3-9]:", line):
                stepped.set()

    threading.Thread(target=reader, daemon=True).start()
    try:
        assert stepped.wait(timeout=240), captured[-8:]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, captured[-8:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    deadline = time.time() + 5    # the reader drains the pipe
    while time.time() < deadline and not any("preempted:" in ln
                                             for ln in captured):
        time.sleep(0.1)
    flushed = [ln for ln in captured
               if ln.startswith("preempted: checkpoint flushed at step=")]
    assert flushed, captured[-8:]
    assert "resume with the same command" in flushed[0]
    step = int(re.search(r"step=(\d+)", flushed[0]).group(1))
    assert step >= 3
    assert CheckpointManager(run).all_steps() == [step]
    launches = [ln for ln in captured if ln.startswith("kernel launches:")]
    assert launches == ["kernel launches: preprocess=0\n"]

    again = subprocess.run([*args[:-3], f"--num_steps={step + 2}",
                            "--save_every=100000", "--log_every=1"],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=300, env=env)
    assert again.returncode == 0, again.stderr[-2000:]
    assert f"resumed from step {step}" in again.stderr
    logged = [int(m) for m in re.findall(r"^step (\d+):", again.stderr,
                                         re.M)]
    assert logged == [step + 1, step + 2]
    assert again.stdout.strip().splitlines()[-1].startswith(
        f"done: step={step + 2} loss=")
    assert CheckpointManager(run).all_steps() == [step, step + 2]


@pytest.mark.parametrize("loader", ["python", "native"])
def test_cli_resume_continues_the_data_stream(shard, tmp_path, loader):
    """2 steps, then a resumed run to 5 (across the 3-step epoch's end),
    on a packed shard: the checkpoint equals a straight 5-step run's,
    bit for bit; the data stream resumes at (epoch, step) = divmod(2, 3)
    and the augment draws at step 2."""
    common = [*TINY, f"--data={shard}", f"--loader={loader}",
              "--save_every=100", "--ema_decay=0.5"]
    straight, resumed = str(tmp_path / "a"), str(tmp_path / "b")
    cli_train.main([*common, f"--train_dir={straight}", "--num_steps=5"])
    cli_train.main([*common, f"--train_dir={resumed}", "--num_steps=2"])
    cli_train.main([*common, f"--train_dir={resumed}", "--num_steps=5"])
    want = CheckpointManager(straight).restore_raw(5)
    got = CheckpointManager(resumed).restore_raw(5)
    assert CheckpointManager(resumed).all_steps() == [2, 5]
    for part in ("params", "batch_stats", "momentum", "ema_params"):
        assert got[part].keys() == want[part].keys()
        for k in want[part]:
            assert torch.equal(got[part][k], want[part][k]), (part, k)
    assert torch.equal(got["classifier"], want["classifier"])
    assert (got["step"], got["count"]) == (want["step"], want["count"])


def _pairs_file(path, n_faces, n_pairs=20):
    with open(path, "w") as f:
        f.write("# idx1 idx2 label\n")
        for i in range(n_pairs):
            f.write(f"{i % n_faces} {(i + 7) % n_faces} {i % 2}\n")
    return str(path)


def test_eval_hook_matches_jax_and_leaves_the_module(shard, tmp_path):
    """build_eval_fn on a tiny EMA state: the EMA weights (here the JAX
    variables, while the trained params drift away from them) give the
    JAX package's extract_shard + verify_pairs report on the same shard
    and pairs; the training module keeps its mode, values and autograd
    flags."""
    import jax

    from tests.test_serving import _warm_variables
    from tf_face_toolbox_tpu.extract import extract_shard as jax_extract
    from tf_face_toolbox_tpu.interop.port import flatten_variables
    from tf_face_toolbox_tpu.models import create_network as jax_network
    from tf_face_toolbox_tpu.ops.verification import verify_pairs as jax_vp

    jnet = jax_network("resnet_tiny", embedding_dim=16)
    variables = _warm_variables(jnet, jax.random.key(0), (4, 16, 16, 3))
    pairs = _pairs_file(tmp_path / "pairs.txt", 24)
    i1, i2, labels = load_pairs(pairs)
    emb = jax_extract(jnet, variables, JaxSource(shard), image_size=16,
                      crop_from=20, batch=8)
    want = jax_vp(emb[i1], emb[i2], labels)

    cfg = _tiny_cfg(ema_decay=0.5)
    state, net = create_train_state(cfg, 0,
                                    variables=flatten_variables(variables),
                                    device="cpu")
    with torch.no_grad():
        for p in state.params.values():
            p.add_(0.05)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    args = cli_train.parse_args([f"--eval_data={shard}",
                                 f"--eval_pairs={pairs}", "--eval_every=1",
                                 "--eval_batch=8"])
    got = cli_train.build_eval_fn(cfg, args, "cpu")(state)
    assert got["lfw_accuracy"] == pytest.approx(want["accuracy_mean"],
                                                abs=1e-9)
    assert got["lfw_std"] == pytest.approx(want["accuracy_std"], abs=1e-9)
    assert np.isnan(got["tar_at_far_1e2"]) == np.isnan(
        want.get("tar@far=0.01", np.nan))
    assert net.training
    assert all(p.requires_grad for p in net.parameters())
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert cli_train.build_eval_fn(cfg, cli_train.parse_args([]),
                                   "cpu") is None


def test_cli_eval_hook_keeps_the_best(shard, tmp_path, caplog):
    run = str(tmp_path / "run")
    pairs = _pairs_file(tmp_path / "pairs.txt", 24)
    caplog.set_level(logging.INFO)
    cli_train.main([*TINY, f"--data={shard}", "--loader=python",
                    f"--train_dir={run}", f"--eval_data={shard}",
                    f"--eval_pairs={pairs}", "--eval_every=2",
                    "--eval_batch=8", "--keep_best=lfw_accuracy"])
    evals = [r.getMessage() for r in caplog.records
             if "eval/lfw_accuracy=" in r.getMessage()]
    assert [m.split(":")[0] for m in evals] == ["step 2", "step 4"]
    info = CheckpointManager(run).best_info()
    assert info["name"] == "lfw_accuracy" and info["step"] in (2, 4)
    assert CheckpointManager(os.path.join(run, "best")).all_steps() == [
        info["step"]]


def test_loop_stops_when_asked():
    rng = np.random.default_rng(0)
    batches = ({"image": rng.integers(0, 256, (8, 20, 20, 3), np.uint8),
                "label": rng.integers(0, 6, 8)} for _ in range(10))
    calls = iter([False, False, True])
    result = train_loop(_tiny_cfg(), batches, num_steps=10, log_every=0,
                        should_stop=lambda: next(calls), device="cpu")
    assert result.state.step == 2 and result.last_metrics["preempted"] == 1.0


def test_batch_iterator_matches_jax_and_resumes(shard):
    """Same shuffled order, images and labels as the JAX iterator; a
    resumed iterator continues the same stream (4 batches an epoch)."""
    ours = batch_iterator(FaceShardSource(shard, seed=3), 6, num_threads=2)
    theirs = jax_batch_iterator(JaxSource(shard, seed=3), 6, num_threads=2)
    got = [next(ours) for _ in range(6)]
    want = [next(theirs) for _ in range(6)]
    for g, w in zip(got, want):
        assert (g["epoch"], g["step"]) == (w["epoch"], w["step"])
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])
    resumed = batch_iterator(FaceShardSource(shard, seed=3), 6,
                             start_epoch=1, start_step=1, num_threads=1)
    b = next(resumed)
    assert (b["epoch"], b["step"]) == (1, 1)
    np.testing.assert_array_equal(b["image"], got[5]["image"])
    with pytest.raises(ValueError, match="smaller than one batch"):
        next(batch_iterator(FaceShardSource(shard), 100))


def test_native_iterator_follows_the_same_order(shard):
    nat = native_batch_iterator(FaceShardSource(shard, seed=3), 6,
                                out_h=20, out_w=20, num_threads=2)
    py = batch_iterator(FaceShardSource(shard, seed=3), 6, num_threads=1)
    for _ in range(5):
        a, b = next(nat), next(py)
        assert (a["epoch"], a["step"]) == (b["epoch"], b["step"])
        np.testing.assert_array_equal(a["label"], b["label"])
        np.testing.assert_array_equal(a["image"], b["image"])
    nat.close()


def test_native_reader_decodes_under_load(shard):
    """More decoding threads than cores, the switch interval shortened:
    every batch equals the serial decode. (The library's own pool
    signalled a batch's end on the caller's stack; under load a worker
    locked it after the caller had returned: a glibc abort, or a later
    batch read before its decode ended.)"""
    from tf_face_toolbox_tpu_torch.data.native import NativeShardReader

    ref = NativeShardReader(shard, num_threads=1)
    ids = [np.random.default_rng(i).permutation(24)[:8] for i in range(16)]
    want = [ref.decode_batch(i, 16, 16) for i in ids]
    bad, done = [], []

    def worker(k):
        reader = NativeShardReader(shard, num_threads=4)
        try:
            end = time.monotonic() + 2.0
            while time.monotonic() < end:
                for i, w in zip(ids, want):
                    if not np.array_equal(reader.decode_batch(i, 16, 16), w):
                        bad.append(k)
        finally:
            reader.close()
        done.append(k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        n = max(16, 2 * len(os.sched_getaffinity(0)))    # > the cores
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        ref.close()
    assert not any(t.is_alive() for t in threads)
    assert len(done) == len(threads) and not bad


def test_host_and_device_prefetch():
    def gen():
        for i in range(5):
            yield {"image": np.full((2, 3), i, np.uint8), "step": i}

    out = list(device_prefetch(host_prefetch(gen()), device="cpu"))
    assert [o["step"] for o in out] == list(range(5))
    assert all(isinstance(o["image"], torch.Tensor) for o in out)
    assert out[3]["image"].tolist() == [[3] * 3] * 2

    def broken():
        yield {"image": np.zeros(1)}
        raise RuntimeError("corrupt record")

    it = host_prefetch(broken())
    next(it)
    with pytest.raises(RuntimeError, match="corrupt record"):
        next(it)


def test_metric_logger_rates():
    log = MetricLogger(batch_size=256)
    first = log.log(10, {"loss": 1.0})
    assert "faces_per_sec" not in first
    second = log.log(20, {"loss": 0.5})
    assert second["faces_per_sec"] == pytest.approx(
        second["steps_per_sec"] * 256)
