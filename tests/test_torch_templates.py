"""IJB-style templates in the port (``ops/templates.py``,
``cli.eval_templates``), against the JAX package's.

The cases of tests/test_templates.py (the media-then-template order,
media ids scoped per template, the validation, well-separated subjects),
each also held against JAX's ``aggregate_templates`` and
``verify_templates`` on the same inputs: template embeddings allclose at
rtol 1e-5, atol 1e-6 (f32 segment means summed in another order), the
same keys, and the same report: counts and TAR values equal (the scores
agree to f32 rounding and no positive sits that close to a threshold),
the thresholds, which are scores, to rtol and atol 1e-6.
Scoring in slices of pairs gives the scores of one slice bit for bit.
The CLI's JSON report equals JAX's so, with labelled and unlabelled
pairs.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tf_face_toolbox_tpu.ops import templates as jax_templates
from tf_face_toolbox_tpu_torch.cli import eval_templates as cli
from tf_face_toolbox_tpu_torch.ops.templates import (
    aggregate_templates,
    pair_scores,
    verify_templates,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _aggregate(emb, tids, mids, **kw):
    got = aggregate_templates(emb, tids, mids, device="cpu", **kw)
    want = jax_templates.aggregate_templates(emb, tids, mids, **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert got[1].tolist() == want[1].tolist()
    return got


def test_media_then_template_mean_oracle():
    """A 3-frame video counts as ONE look: media are averaged before the
    template mean."""
    rng = np.random.default_rng(0)
    still = rng.standard_normal(4).astype(np.float32)
    frames = rng.standard_normal((3, 4)).astype(np.float32)
    emb = np.vstack([still, frames])
    t_emb, keys = _aggregate(emb, np.asarray(["t1"] * 4),
                             np.asarray(["a", "b", "b", "b"]))
    assert keys.tolist() == ["t1"]
    np.testing.assert_allclose(t_emb[0], _norm((still + frames.mean(0)) / 2),
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(t_emb[0], _norm(emb.mean(0)), atol=1e-3)


def test_media_ids_scoped_per_template():
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((4, 8)).astype(np.float32)
    t_emb, _ = _aggregate(emb, np.asarray(["t1", "t1", "t2", "t2"]),
                          np.asarray(["m", "m", "m", "m"]))
    np.testing.assert_allclose(t_emb[0], _norm(emb[:2].mean(0)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_emb[1], _norm(emb[2:].mean(0)),
                               rtol=1e-5, atol=1e-6)


def test_unnormalized_means_and_integer_ids():
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((50, 6)).astype(np.float32)
    tids = rng.integers(0, 7, 50)
    mids = rng.integers(0, 3, 50)
    _aggregate(emb, tids, mids, normalize=False)
    _aggregate(emb, tids, mids)


def test_aggregate_validates():
    with pytest.raises(ValueError, match="mismatch"):
        aggregate_templates(np.zeros((2, 4)), np.asarray(["a"]),
                            np.asarray(["m", "m"]), device="cpu")
    with pytest.raises(ValueError, match="no rows"):
        aggregate_templates(np.zeros((0, 4)), np.asarray([]),
                            np.asarray([]), device="cpu")


def _assert_report(got, want):
    """The same report: counts and TAR equal, thresholds (scores) to f32
    rounding."""
    assert got.keys() == want.keys()
    for k in want:
        if k.startswith("thr@"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
        else:
            assert got[k] == want[k] or (np.isnan(got[k])
                                         and np.isnan(want[k])), k


def _subjects(seed=2, subjects=4, dim=16):
    rng = np.random.default_rng(seed)
    centers = _norm(rng.standard_normal((subjects, dim)).astype(
        np.float32)) * 4
    rows, tids, mids = [], [], []
    for s in range(subjects):
        for t in range(2):
            for m in range(3):
                rows.append(centers[s] + 0.05 * rng.standard_normal(dim))
                tids.append(f"s{s}t{t}")
                mids.append(f"m{m}")
    pairs = [[f"s{s}t0", f"s{s}t1"] for s in range(subjects)]
    labels = [1] * subjects
    for s in range(subjects):
        pairs.append([f"s{s}t0", f"s{(s + 1) % subjects}t1"])
        labels.append(0)
    return (np.asarray(rows, np.float32), np.asarray(tids), np.asarray(mids),
            np.asarray(pairs), np.asarray(labels))


def test_verify_templates_separates_subjects():
    emb, tids, mids, pairs, labels = _subjects()
    t_emb, keys = _aggregate(emb, tids, mids)
    report = verify_templates(t_emb, keys, pairs, labels, fars=(0.25,),
                              device="cpu")
    assert report["tar@far=0.25"] == 1.0
    _assert_report(report, jax_templates.verify_templates(
        t_emb, keys, pairs, labels, fars=(0.25,)))
    with pytest.raises(ValueError, match="unknown template"):
        verify_templates(t_emb, keys, np.asarray([["s0t0", "nope"]]),
                         np.asarray([1]), device="cpu")


def test_report_matches_jax_on_noisy_templates():
    """Overlapping subjects: TAR below 1 at every FAR, equal to JAX's."""
    rng = np.random.default_rng(4)
    n, subjects = 3000, 40
    subj = rng.integers(0, subjects, n)
    centers = rng.standard_normal((subjects, 32)).astype(np.float32)
    emb = (centers[subj] + 8.0 * rng.standard_normal((n, 32))).astype(
        np.float32)
    tids = subj * 10 + rng.integers(0, 10, n)      # 10 templates a subject
    mids = rng.integers(0, 4, n)
    t_emb, keys = _aggregate(emb, tids, mids)
    i1 = rng.integers(0, len(keys), 4000)
    i2 = rng.integers(0, len(keys), 4000)
    pairs = np.stack([keys[i1], keys[i2]], axis=1)
    labels = (keys[i1] // 10 == keys[i2] // 10).astype(np.int64)
    fars = (1e-1, 1e-2, 1e-3)
    got = verify_templates(t_emb, keys, pairs, labels, fars=fars,
                           device="cpu", pair_chunk=1000)
    want = jax_templates.verify_templates(t_emb, keys, pairs, labels,
                                          fars=fars)
    _assert_report(got, want)
    assert 0 < got["tar@far=0.1"] < 1
    # slices of the pairs: the same scores as one slice, bit for bit
    whole = pair_scores(t_emb, i1, i2, device="cpu", pair_chunk=1 << 22)
    np.testing.assert_array_equal(
        pair_scores(t_emb, i1, i2, device="cpu", pair_chunk=777), whole)


def _write_cli_inputs(tmp_path, labelled: bool):
    rng = np.random.default_rng(3)
    centers = _norm(rng.standard_normal((3, 8)).astype(np.float32)) * 4
    emb, meta = [], []
    for s in range(3):
        for t in range(2):
            for m in range(2):
                emb.append(centers[s] + 0.05 * rng.standard_normal(8))
                meta.append(f"s{s}t{t} m{m} subj{s}")
    np.save(tmp_path / "emb.npy", _norm(np.asarray(emb, np.float32)))
    (tmp_path / "meta.txt").write_text("\n".join(meta) + "\n")
    if labelled:
        lines = [f"s{s}t0 s{s}t1 1" for s in range(3)]
        lines += [f"s{s}t0 s{(s + 1) % 3}t1 0" for s in range(3)]
    else:
        lines = [f"s{s}t0 s{s}t1" for s in range(3)]
        lines += [f"s{s}t0 s{(s + 1) % 3}t1" for s in range(3)]
    (tmp_path / "pairs.txt").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("labelled", [False, True],
                         ids=["labels_from_meta", "labelled_pairs"])
def test_cli_report_equals_jax(tmp_path, labelled, capsys):
    _write_cli_inputs(tmp_path, labelled)
    flags = [f"--embeddings={tmp_path / 'emb.npy'}",
             f"--meta={tmp_path / 'meta.txt'}",
             f"--pairs={tmp_path / 'pairs.txt'}", "--fars=0.34,0.1"]
    cli.main([*flags, "--device=cpu",
              f"--output_templates={tmp_path / 'tmpl.npy'}"])
    report = json.loads(capsys.readouterr().out)
    assert report["templates"] == 6 and report["images"] == 12
    assert report["tar@far=0.34"] == 1.0
    tmpl = np.load(tmp_path / "tmpl.npy")
    labels = np.load(tmp_path / "tmpl.labels.npy")
    assert tmpl.shape == (6, 8) and len(labels) == 6
    assert sorted(set(labels.tolist())) == ["subj0", "subj1", "subj2"]
    r = subprocess.run(
        [sys.executable, "-m", "tf_face_toolbox_tpu.cli.eval_templates",
         *flags, f"--output_templates={tmp_path / 'jax_tmpl.npy'}"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "TFFT_PLATFORM": "cpu", "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stderr[-2000:]
    want = json.loads(r.stdout)
    _assert_report(report, want)
    np.testing.assert_allclose(tmpl, np.load(tmp_path / "jax_tmpl.npy"),
                               rtol=1e-5, atol=1e-6)


def test_cli_refusals(tmp_path):
    _write_cli_inputs(tmp_path, labelled=False)
    (tmp_path / "meta1.txt").write_text("t1 m1\n")
    base = [f"--embeddings={tmp_path / 'emb.npy'}", "--device=cpu"]
    with pytest.raises(SystemExit, match="rows"):
        cli.main([*base, f"--meta={tmp_path / 'meta1.txt'}",
                  f"--pairs={tmp_path / 'pairs.txt'}"])
    (tmp_path / "meta2.txt").write_text("t1 m1\nt1 m2\n")
    with pytest.raises(SystemExit, match="no labels"):
        cli.load_template_pairs(str(tmp_path / "pairs.txt"),
                                cli.load_meta(str(tmp_path / "meta2.txt"))[2])
    (tmp_path / "meta3.txt").write_text("t1 m1 a\nt1 m2 b\n")
    with pytest.raises(SystemExit, match="spans subjects"):
        cli.load_meta(str(tmp_path / "meta3.txt"))


def test_cli_defaults_to_the_card():
    assert cli.parse_args(["--embeddings=a", "--meta=b",
                           "--pairs=c"]).device == "cuda"
