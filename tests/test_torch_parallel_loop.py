"""The data-parallel loop, checkpoints and CLI on two gloo ranks (CPU).

``train_loop(mesh=)`` on the ranks of ``torch_dist.Ranks`` (spawned once
for the module): a resumed run equals the straight one bit for bit on
both ranks; rank 0 alone writes checkpoints and runs the eval hook, and
``keep_best`` decides the same on both; a stop asked on one rank stops
both at the same step. ``cli.train --multihost`` as two processes with
torchrun's environment: SIGTERM to one rank flushes one checkpoint and
both exit 0. The weighted shard mixture yields the JAX package's
sources and labels step by step. The model-axis paths (``--mesh_model``,
``--pfc_sample_rate``, config 7's preset) train as four ranks on a 2 x
2 grid, and a one-process run on a host with several GPUs refuses with
the torchrun line.
"""

import dataclasses
import os
import re
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import torch_dist as td
from tf_face_toolbox_tpu.data.pipeline import (
    mixed_batch_iterator as jax_mixed_batch_iterator,
    mixture_sources as jax_mixture_sources,
)
from tf_face_toolbox_tpu_torch import configs
from tf_face_toolbox_tpu_torch.cli import train as cli_train
from tf_face_toolbox_tpu_torch.data.format import pack_arrays
from tf_face_toolbox_tpu_torch.data.pipeline import (
    mixed_batch_iterator,
    mixture_sources,
)
from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device=cpu", "--network=resnet_tiny", "--embedding_dim=16",
        "--image_size=16", "--crop_from=20", "--global_batch=8",
        "--nobf16"]


@pytest.fixture(scope="module")
def ranks():
    with td.Ranks(2) as r:
        yield r


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Two raw shards of 20x20 faces: 24 of 6 identities, 16 of 4."""
    d = tmp_path_factory.mktemp("mixture")
    rng = np.random.default_rng(0)
    paths = []
    for name, n, ids in (("a", 24, 6), ("b", 16, 4)):
        path = str(d / f"{name}.faceshard")
        pack_arrays(path, rng.integers(0, 256, (n, 20, 20, 3), np.uint8),
                    [i % ids for i in range(n)])
        paths.append(path)
    return paths


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif a is None or isinstance(a, (int, float)):
        assert a == b
    else:
        assert np.array_equal(a, b)


def test_two_rank_resume_is_bit_exact(ranks, tmp_path):
    """4 straight steps against 2, a new loop that resumes, and 2 more,
    with the augment, random erase and EMA on: equal bit for bit, and
    the two ranks equal to each other. Rank 0 alone writes."""
    kw = {"ema_decay": 0.9}
    straight = ranks.run(td.loop_run, train_dir=str(tmp_path / "a"),
                         num_steps=4, cfg_kw=kw)
    first = ranks.run(td.loop_run, train_dir=str(tmp_path / "b"),
                      num_steps=2, cfg_kw=kw)
    resumed = ranks.run(td.loop_run, train_dir=str(tmp_path / "b"),
                        num_steps=4, cfg_kw=kw)
    for r in range(2):
        _same(resumed[r]["state"], straight[r]["state"])
    _same(straight[0]["state"], straight[1]["state"])
    assert straight[0]["state"]["step"] == 4
    assert [x["writes"] for x in first] == [[2], []]
    assert [x["writes"] for x in resumed] == [[4], []]
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [2, 4]


def test_eval_hook_runs_on_rank_0_and_keep_best_agrees(ranks, tmp_path):
    run = str(tmp_path / "run")
    out = ranks.run(td.loop_run, train_dir=run, num_steps=3, cfg_kw={},
                    eval_every=1)
    assert out[0]["evals"] == [1, 2, 3] and out[1]["evals"] == []
    # each eval beat the last: three best saves and the final one, all
    # written by rank 0
    assert out[0]["writes"] == [1, 2, 3, 3] and out[1]["writes"] == []
    mgr = CheckpointManager(run)
    assert mgr.best_info() == {"step": 3, "metric": 0.53, "name": "acc"}
    assert CheckpointManager(os.path.join(run, "best")).all_steps() == [3]
    _same(out[0]["state"], out[1]["state"])


def test_a_stop_on_one_rank_stops_both(ranks, tmp_path):
    """Rank 1 alone asks to stop from step 3; the ranks agree every 10
    steps, so both stop at 10 and one checkpoint is flushed there."""
    run = str(tmp_path / "run")
    out = ranks.run(td.loop_run, train_dir=run, num_steps=50, cfg_kw={},
                    stop_rank=1, stop_at=3)
    assert [x["state"]["step"] for x in out] == [10, 10]
    assert [x["metrics"]["preempted"] for x in out] == [1.0, 1.0]
    assert [x["writes"] for x in out] == [[10], []]
    assert CheckpointManager(run).all_steps() == [10]


def _launch(args, world=2):
    """``cli.train --multihost`` as ``world`` processes with the variables
    torchrun would set."""
    port = td.free_port()
    procs = []
    for r in range(world):
        env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
               "RANK": str(r), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(world),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.train",
             "--multihost", *TINY, *args], cwd=ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    return procs


def _finish(procs, timeout=240):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return outs


def test_sigterm_to_one_rank_flushes_once_and_both_exit_0(tmp_path):
    run = str(tmp_path / "run")
    procs = _launch(["--data=synthetic", "--num_classes=10",
                     f"--train_dir={run}", "--num_steps=100000",
                     "--save_every=100000", "--log_every=1"])
    logged = []
    stepped = threading.Event()

    def reader():
        # rank 0 logs; the steps it logs say how far both have come
        for line in procs[0].stderr:
            logged.append(line)
            if re.match(r"step [3-9]:", line):
                stepped.set()

    threading.Thread(target=reader, daemon=True).start()
    try:
        assert stepped.wait(timeout=240), logged[-8:]
        procs[1].send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    outs = [p.stdout.read() for p in procs]
    assert codes == [0, 0], (outs, logged[-8:], procs[1].stderr.read())
    steps = [int(re.search(r"preempted: checkpoint flushed at step=(\d+)",
                           o).group(1)) for o in outs]
    assert steps[0] == steps[1] and steps[0] % 10 == 0, steps
    assert CheckpointManager(run).all_steps() == [steps[0]]
    assert not [n for n in os.listdir(run) if n.endswith(".tmp")]


def test_two_rank_cli_trains_a_weighted_mixture(shards):
    outs = _finish(_launch([f"--data={','.join(shards)}",
                            "--data_weights=3,1", "--num_steps=3",
                            "--log_every=1", "--loader=python"]))
    for code, out, err in outs:
        assert code == 0, err[-3000:]
    done = [o.strip().splitlines()[-1] for _, o, _ in outs]
    # the loss is the global batch's on both ranks
    assert done[0] == done[1] and done[0].startswith("done: step=3 loss=")
    assert "step 3: loss=" in outs[0][2] and "step 3:" not in outs[1][2]


@pytest.mark.parametrize("host", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("start", [0, 5])
def test_mixture_matches_jax_step_by_step(shards, host, start):
    """The same source, labels (offset by the sources before) and images
    at every step, from ``start_step`` on, on each host's slice."""
    index, count = host
    batch = 4 // count
    got = mixed_batch_iterator(
        shards, batch, weights=[3, 1], seed=11, start_step=start,
        sources=mixture_sources(shards, seed=11, host_index=index,
                                host_count=count), num_threads=1)
    want = jax_mixed_batch_iterator(
        shards, batch, weights=[3, 1], seed=11, start_step=start,
        sources=jax_mixture_sources(shards, seed=11, host_index=index,
                                    host_count=count), num_threads=1)
    seen = set()
    for _ in range(12):
        a, b = next(got), next(want)
        assert (a["source"], a["step"]) == (b["source"], b["step"])
        np.testing.assert_array_equal(a["label"], b["label"])
        np.testing.assert_array_equal(a["image"], b["image"])
        seen.add(a["source"])
        if a["source"] == 1:
            assert a["label"].min() >= 6           # offset past shard a
    assert seen == {0, 1}


@pytest.mark.parametrize("argv,why", [
    (["--data_weights=3,1"], "needs a multi-shard"),
    (["--data=SHARDS", "--data_weights=1,2,3"], "3 entries for 2 shards"),
    (["--data=SHARDS", "--data_weights=a,b"], "comma floats"),
    (["--data=SHARDS", "--num_classes=5"], "combined identity count 10"),
    (["--data=SHARDS", "--loader=native"], "python loader"),
])
def test_mixture_refusals(shards, argv, why):
    argv = [a.replace("SHARDS", ",".join(shards)) for a in argv]
    with pytest.raises(SystemExit, match=why):
        cli_train.main([*TINY, "--num_steps=1", *argv])


@pytest.mark.parametrize("argv", [["--mesh_model=2"],
                                  ["--pfc_sample_rate=0.5"],
                                  ["--preset=large_id_pfc_v5e8"]],
                         ids=lambda a: a[0].split("=")[0])
def test_the_model_axis_paths_raise_naming_item_11(argv):
    """The model-axis paths named item 11 until it was ported; now each
    trains: cli.train --multihost as four ranks on a 2 x 2 grid (the
    exact head at 13 classes, the sampled one at 201, config 7's preset
    at its 93,431 classes, cut to the tiny net), 2 steps, the same loss
    on every rank."""
    extra = {"--mesh_model": ["--num_classes=13"],
             "--pfc_sample_rate": ["--num_classes=201"],
             "--preset": []}[argv[0].split("=")[0]]
    outs = _finish(_launch(["--mesh_model=2", *argv, *extra,
                            "--num_steps=2", "--log_every=1"], world=4))
    for code, out, err in outs:
        assert code == 0, err[-3000:]
    done = [o.strip().splitlines()[-1] for _, o, _ in outs]
    assert len(set(done)) == 1 and done[0].startswith("done: step=2 loss=")
    assert np.isfinite(float(done[0].split("loss=")[1]))


def test_the_adaface_preset_raises_naming_item_9():
    """Preset 8 named item 9 until the loss heads were ported; now it
    trains: cli.train --multihost as four ranks on a 2 x 2 grid, AdaFace
    on 3 sub-centers at 13 classes, cut to the tiny net, 2 steps, the
    same loss and the same AdaFace statistics on every rank."""
    outs = _finish(_launch(["--mesh_model=2", "--preset=adaface_noisy_data",
                            "--num_classes=13", "--num_steps=2",
                            "--log_every=1"], world=4))
    for code, out, err in outs:
        assert code == 0, err[-3000:]
    done = [o.strip().splitlines()[-1] for _, o, _ in outs]
    assert len(set(done)) == 1 and done[0].startswith("done: step=2 loss=")
    assert np.isfinite(float(done[0].split("loss=")[1]))
    # rank 0 logs: AdaFace's EMA mean has moved from its start of 20
    means = re.findall(r"adaface_norm_mean=([0-9.e+-]+)", outs[0][2])
    assert len(means) == 2 and float(means[-1]) != 20.0


def test_a_preset_gives_the_defaults_of_the_flags_it_sets():
    """--preset v5e8_data_parallel builds config 5 at one rank; flags on
    the command line win."""
    argv = ["--preset=v5e8_data_parallel", "--network=resnet_tiny",
            "--image_size=16", "--crop_from=20"]
    args = cli_train.parse_args(argv)
    cli_train.apply_preset(args, argv, world=1)
    got = cli_train.build_config(args, args.num_classes)
    want = dataclasses.replace(
        configs.get_config("v5e8_data_parallel", world=1),
        network="resnet_tiny", image_size=16, crop_from=20,
        lr_total_steps=args.num_steps)
    assert got == want
    args = cli_train.parse_args(argv)
    cli_train.apply_preset(args, argv, world=4)
    assert args.global_batch == 1024


def test_one_process_on_several_gpus_refuses_with_the_torchrun_line():
    args = cli_train.parse_args([])
    with pytest.raises(SystemExit, match="torchrun --standalone "
                                         "--nproc_per_node 8"):
        cli_train.check_launch(args, gpus=8, env={})
    cli_train.check_launch(args, gpus=1, env={})
    cli_train.check_launch(cli_train.parse_args(["--device=cuda:0"]),
                           gpus=8, env={})
    with pytest.raises(SystemExit, match="pass --multihost"):
        cli_train.check_launch(args, gpus=1, env={"WORLD_SIZE": "2"})
    cli_train.check_launch(cli_train.parse_args(["--multihost"]), gpus=8,
                           env={"WORLD_SIZE": "8"})


def test_multihost_needs_torchrun_and_slices_must_divide(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        cli_train.main([*TINY, "--multihost", "--num_steps=1"])
    with pytest.raises(SystemExit, match="not divisible into 2 nodes"):
        cli_train.main([*TINY, "--mesh_slices=2", "--num_steps=1"])
