"""The port's acceptance runner (tf_face_toolbox_tpu_torch.acceptance)
vs ``tools/acceptance.py``.

Its helpers are held against the JAX runner's (imported by path:
``tools/`` is not a package); then both runners run on the same
``--variables_npz`` (a seeded 16-d resnet_tiny) and the same LFW-layout
directory (``tests/test_acceptance.py``'s fixture) at that test's tiny
settings, the port's with ``--device cpu``. Held: the same gate names,
PASS/FAIL verdicts, statuses and exit codes for NO_REFERENCE, PASS
(reference = the JAX run's embeddings) and FAIL (an unrelated
reference: random unit rows, with the --identification stage); LFW
accuracies equal; gate values (cosines, accuracy and identification
deltas) within 1e-4.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_acceptance import MODEL, _make_lfw_dir
from tf_face_toolbox_tpu_torch import acceptance

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_runner():
    spec = importlib.util.spec_from_file_location(
        "jax_acceptance", os.path.join(REPO, "tools", "acceptance.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_build_list_is_jax_s(tmp_path):
    from PIL import Image

    jax_acc = _jax_runner()
    for person, k in (("B_Person", 2), ("A_Person", 1)):
        d = tmp_path / "lfw" / person
        d.mkdir(parents=True)
        for i in range(1, k + 1):
            Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
                str(d / f"{person}_{i:04d}.jpg"))
    flat = tmp_path / "flat"
    flat.mkdir()
    for name in ("x_0001.png", "x_0002.png", "solo.bmp", "notes.txt"):
        (flat / name).write_bytes(b"")
    for data in (tmp_path / "lfw", flat):
        got, want = tmp_path / "got.txt", tmp_path / "want.txt"
        assert (acceptance.build_list(str(data), str(got))
                == jax_acc.build_list(str(data), str(want)))
        assert got.read_text() == want.read_text()
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no images"):
        acceptance.build_list(str(empty), str(tmp_path / "e.txt"))


def test_cosine_stats_is_jax_s(tmp_path):
    jax_acc = _jax_runner()
    rng = np.random.default_rng(0)
    a, b = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    np.save(a, rng.normal(size=(9, 8)).astype(np.float32))
    np.save(b, rng.normal(size=(9, 8)).astype(np.float32))
    assert acceptance.cosine_stats(a, b) == jax_acc.cosine_stats(a, b)
    np.save(b, np.eye(5, 8, dtype=np.float32))
    with pytest.raises(SystemExit, match="mismatch"):
        acceptance.cosine_stats(a, b)


@pytest.mark.parametrize("listing", [
    "a/1.jpg 0\na/2.jpg 0\nb/1.jpg 1\nc/1.jpg 2\nc/2.jpg 2\nc/3.jpg 2\n",
    "a/1.jpg 0\n\nb/1.jpg 1\na/2.jpg 0\n\nb/2.jpg 1\nz/1.jpg 9\n",
    "a/1.jpg 0\nb/1.jpg 1\n",
])
def test_identification_split_is_jax_s(tmp_path, listing):
    jax_acc = _jax_runner()
    path = tmp_path / "list.txt"
    path.write_text(listing)
    try:
        want = jax_acc.identification_split(str(path))
    except SystemExit as e:
        with pytest.raises(SystemExit, match="single image") as got:
            acceptance.identification_split(str(path))
        assert str(got.value) == str(e)
        return
    assert acceptance.identification_split(str(path)) == want


def test_model_and_source_flags_are_jax_s():
    import argparse

    jax_acc = _jax_runner()
    ns = argparse.Namespace(
        network="dct_resnet_50", embedding_dim=512, image_size=112,
        input_norm="fixed", head="gap", batch=64, loader="auto", stem="face",
        bf16=False, checkpoint_dir="", variables_npz="v.npz", bundle="",
        compare_network="resnet_v1_50", compare_embedding_dim=256,
        compare_image_size=96, compare_input_norm="per_image",
        compare_head="flatten", compare_loader="python", compare_stem="face",
        compare_checkpoint_dir="run", compare_variables_npz="",
        compare_bundle="b.npz")
    for prefix in ("", "compare_"):
        assert (acceptance.model_flags(ns, prefix)
                == jax_acc.model_flags(ns, prefix))
    assert acceptance.source_flags(ns) == jax_acc.source_flags(ns)
    with pytest.raises(SystemExit, match="exactly one") as got:
        acceptance.source_flags(ns, "compare_")
    with pytest.raises(SystemExit) as want:
        jax_acc.source_flags(ns, "compare_")
    assert str(got.value) == str(want.value)


# ---- both runners, end to end, on the same fixture -----------------------


def _start_jax(args: list) -> subprocess.Popen:
    env = dict(os.environ, TFFT_PLATFORM="cpu", OMP_NUM_THREADS="1")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=8").strip()
    return subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tools", "acceptance.py"), *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)


def _jax_done(proc: subprocess.Popen) -> int:
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode in (0, 1, 2), out[-3000:]
    return proc.returncode


def _port(args: list, capsys) -> int:
    rc = acceptance.main(args + ["--device=cpu"])
    capsys.readouterr()
    return rc


def _report(workdir: str) -> dict:
    with open(os.path.join(workdir, "acceptance_report.json")) as f:
        return json.load(f)


def _assert_same_verdicts(got: dict, want: dict) -> None:
    assert got["status"] == want["status"]
    assert got["lfw_accuracy"] == want["lfw_accuracy"]
    assert [(g["gate"], g["pass"]) for g in got["gates"]] == [
        (g["gate"], g["pass"]) for g in want["gates"]]
    for g, w in zip(got["gates"], want["gates"]):
        assert g["threshold"] == w["threshold"]
        assert abs(g["value"] - w["value"]) <= 1e-4, (g, w)


@pytest.mark.mid
def test_runner_verdicts_and_exit_codes_are_jax_s(tmp_path, capsys):
    from tf_face_toolbox_tpu_torch.interop.port import save_variables_npz
    from tf_face_toolbox_tpu_torch.models import create_network, random_variables

    data_dir, pairs = _make_lfw_dir(tmp_path / "lfw")
    npz = str(tmp_path / "tiny.npz")
    save_variables_npz(npz, random_variables(create_network(
        "resnet_tiny", embedding_dim=16, input_size=12), 3))
    common = [f"--data={data_dir}", f"--pairs={pairs}",
              f"--variables_npz={npz}"] + MODEL

    def args(tag: str, *extra) -> list:
        return common + [f"--workdir={tmp_path / tag}", *extra]

    # a reference no model here gives: random unit rows, one a face
    e = np.random.default_rng(1).standard_normal((26, 16))
    bad = str(tmp_path / "bad_ref.npy")
    np.save(bad, (e / np.linalg.norm(e, axis=1, keepdims=True)
                  ).astype(np.float32))

    # 1) no reference artifact: NO_REFERENCE, exit 2; 3) the unrelated
    # reference, with the 1:N stage: FAIL, exit 1 (the JAX runs side by
    # side)
    ident = ["--identification", "--identification_far=0.5"]
    jax1 = _start_jax(args("jax1"))
    jax3 = _start_jax(args("jax3", f"--reference_embeddings={bad}", *ident))
    assert _port(args("port1"), capsys) == 2
    assert _port(args("port3", f"--reference_embeddings={bad}", *ident),
                 capsys) == 1
    assert _jax_done(jax1) == 2
    # 2) reference = the JAX run's embeddings: PASS, exit 0
    ref = str(tmp_path / "jax1" / "emb_primary.npy")
    jax2 = _start_jax(args("jax2", f"--reference_embeddings={ref}"))
    assert _port(args("port2", f"--reference_embeddings={ref}"), capsys) == 0
    assert _jax_done(jax2) == 0 and _jax_done(jax3) == 1
    for tag, status in (("1", "NO_REFERENCE"), ("2", "PASS"), ("3", "FAIL")):
        got, want = (_report(str(tmp_path / f"port{tag}")),
                     _report(str(tmp_path / f"jax{tag}")))
        _assert_same_verdicts(got, want)
        assert got["status"] == status
        if tag != "1":
            assert [g["gate"] for g in got["gates"]][:2] == [
                "per_face_cosine_vs_reference", "lfw_accuracy_vs_reference"]
    gates = [g["gate"] for g in _report(str(tmp_path / "port3"))["gates"]]
    assert gates[2:] == ["identification_cmc1_vs_reference",
                         "identification_dir@far=0.5_vs_reference"]
    for key in ("identification_primary", "identification_reference"):
        got, want = (_report(str(tmp_path / "port3"))[key],
                     _report(str(tmp_path / "jax3"))[key])
        assert {k: got[k] for k in ("gallery", "probes", "skipped")} == {
            k: want[k] for k in ("gallery", "probes", "skipped")}
