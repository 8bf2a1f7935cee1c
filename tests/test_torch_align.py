"""The port's face alignment (ops/align) vs the JAX package's.

Tolerances: the numpy half (Umeyama, the float64 warp, align_face) is
bit-equal to JAX's; ``warp_similarity_torch`` on the CPU is bit-equal to
``warp_similarity_jax`` (the same f32 arithmetic as
``map_coordinates(order=1, cval=0)``), and within 1 LSB of the float64
numpy warp on every value with >= 98% equal (JAX's own bar,
``tests/test_align.py:73-81``); packing with landmarks writes JAX's
shard byte for byte.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_align import _apply, _similarity
from tf_face_toolbox_tpu.data.format import pack_image_list as jax_pack
from tf_face_toolbox_tpu.ops import align as jax_align
from tf_face_toolbox_tpu_torch.data.format import pack_image_list
from tf_face_toolbox_tpu_torch.ops import align

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_run = functools.partial(
    subprocess.run, cwd=ROOT, capture_output=True, text=True, timeout=300,
    env={**os.environ, "OMP_NUM_THREADS": "1"})


# ---- the numpy half: bit-equal --------------------------------------------


def test_template_is_jax_s():
    assert np.array_equal(align.ARCFACE_TEMPLATE_112,
                          jax_align.ARCFACE_TEMPLATE_112)


@pytest.mark.parametrize("case", ["exact", "noise", "reflection", "inverse"])
def test_umeyama_is_jax_s(case):
    rng = np.random.default_rng(0)
    src = align.ARCFACE_TEMPLATE_112
    if case == "exact":
        dst = _apply(_similarity(1.37, 0.41, 12.0, -7.5), src)
    elif case == "noise":
        dst = (_apply(_similarity(0.8, -0.2, 3.0, 4.0), src)
               + 0.5 * rng.normal(size=src.shape))
    elif case == "reflection":
        dst = src * np.array([-1.0, 1.0])
    else:
        src, dst = _apply(_similarity(1.37, 0.41, 12.0, -7.5), src), src
    got = align.umeyama(src, dst)
    assert np.array_equal(got, jax_align.umeyama(src, dst))
    assert np.linalg.det(got[:, :2]) > 0
    with pytest.raises(ValueError, match="degenerate"):
        align.umeyama(np.ones((5, 2)), src)


@pytest.mark.parametrize("matrix, shape", [
    (np.array([[1.0, 0, 0], [0, 1.0, 0]]), (20, 24)),
    (np.array([[1.0, 0, 3.0], [0, 1.0, 2.0]]), (16, 16)),
    (_similarity(0.9, 0.3, 4.0, -2.0), (24, 24)),
    (_similarity(1.6, 2.5, 40.0, -30.0), (32, 20)),
])
def test_numpy_warp_is_jax_s(matrix, shape):
    img = np.random.default_rng(1).integers(0, 256, (30, 26, 3), np.uint8)
    got = align.warp_similarity(img, matrix, *shape)
    assert np.array_equal(got, jax_align.warp_similarity(img, matrix, *shape))


def test_align_face_is_jax_s():
    m_off = _similarity(1.6, 0.25, 30.0, 18.0)
    lm = _apply(m_off, align.ARCFACE_TEMPLATE_112)
    img = np.random.default_rng(2).integers(0, 256, (320, 320, 3), np.uint8)
    for size in (112, 64):
        assert np.array_equal(align.align_face(img, lm, size=size),
                              jax_align.align_face(img, lm, size=size))
    with pytest.raises(ValueError, match=r"\(5, 2\)"):
        align.align_face(img, np.zeros((4, 2)))


# ---- the torch warp: bit-equal to JAX's, 1 LSB of numpy's ------------------


def _case(seed: int):
    """A seeded image and similarity; odd seeds sample far outside the
    source (rotations past 90 degrees, large shifts, scales < 1)."""
    rng = np.random.default_rng(seed)
    h, w = rng.integers(12, 64, 2)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    if seed % 2:
        m = _similarity(rng.uniform(0.3, 2.5), rng.uniform(-3.1, 3.1),
                        rng.uniform(-40, 40), rng.uniform(-40, 40))
    else:
        m = _similarity(rng.uniform(0.8, 1.3), rng.uniform(-0.4, 0.4),
                        rng.uniform(-4, 4), rng.uniform(-4, 4))
    return img, m, tuple(rng.integers(8, 48, 2))


@pytest.mark.parametrize("seed", range(8))
def test_torch_warp_is_jax_s(seed):
    img, m, (oh, ow) = _case(seed)
    got = align.warp_similarity_torch(img, m, oh, ow, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (oh, ow, 3)
    want = np.asarray(jax_align.warp_similarity_jax(img, m, oh, ow))
    assert np.array_equal(got.numpy(), want)
    ref = align.warp_similarity(img, m, oh, ow)
    diff = np.abs(got.numpy().astype(int) - ref.astype(int))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.98
    if seed % 2:
        assert (ref == 0).any()         # some taps fell outside


def test_torch_warp_batch_is_per_image():
    cases = [_case(s) for s in (10, 11, 12)]
    img = np.stack([np.resize(c[0], (30, 34, 3)) for c in cases])
    mats = np.stack([c[1] for c in cases])
    batch = align.warp_similarity_torch(torch.from_numpy(img), mats, 20, 18)
    for i in range(3):
        one = align.warp_similarity_torch(torch.from_numpy(img[i]), mats[i],
                                          20, 18)
        assert batch.device.type == "cpu" and torch.equal(batch[i], one)
    with pytest.raises(ValueError, match=r"\(N, 2, 3\)"):
        align.warp_similarity_torch(torch.from_numpy(img), mats[:2], 20, 18)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without CUDA: a host array goes to the card by default")
def test_torch_warp_host_array_defaults_to_the_card():
    img, m, _ = _case(0)
    with pytest.raises((RuntimeError, AssertionError)):
        align.warp_similarity_torch(img, m, 8, 8)


# ---- packing with landmarks: JAX's shard byte for byte ---------------------


def _faces(tmp_path):
    """``tests/test_align.py::test_pack_with_landmarks_e2e``'s fixture."""
    from PIL import Image

    rng = np.random.default_rng(4)
    lines, lm_lines = [], []
    for i in range(6):
        img = rng.integers(0, 256, (160, 140, 3), np.uint8)
        Image.fromarray(img).save(str(tmp_path / f"f{i}.jpg"),
                                  "JPEG", quality=95)
        lines.append(f"f{i}.jpg {i % 3}")
        m = _similarity(1.2 + 0.1 * i, 0.1 * i, 15.0, 20.0)
        lm = _apply(m, align.ARCFACE_TEMPLATE_112)
        lm_lines.append(" ".join(f"{v:.3f}" for v in lm.ravel()))
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    (tmp_path / "lm.txt").write_text("\n".join(lm_lines) + "\n")
    return str(tmp_path / "list.txt"), str(tmp_path / "lm.txt"), lm_lines


def _same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


@pytest.mark.parametrize("align_size", [112, 64])
def test_pack_with_landmarks_is_jax_s(tmp_path, align_size):
    listing, marks, _ = _faces(tmp_path)
    want, got = str(tmp_path / "jax.faceshard"), str(tmp_path / "port.faceshard")
    kw = dict(root=str(tmp_path), landmarks_path=marks, align_size=align_size)
    assert pack_image_list(listing, got, **kw) == jax_pack(listing, want,
                                                           **kw) == 6
    assert _same_bytes(got, want)


@pytest.mark.mid
def test_cli_pack_landmarks_is_jax_s(tmp_path):
    listing, marks, _ = _faces(tmp_path)
    want, got = str(tmp_path / "jax.faceshard"), str(tmp_path / "cli.faceshard")
    jax_pack(listing, want, root=str(tmp_path), landmarks_path=marks)
    proc = _run([sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.pack",
                 "--list", listing, "--root", str(tmp_path), "--landmarks",
                 marks, "--output", got])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"packed 6 records into {got}"
    assert _same_bytes(got, want)


@pytest.mark.parametrize("case", ["short", "long", "recode", "size", "floats"])
def test_pack_refusals_are_jax_s(tmp_path, case):
    listing, marks, lm_lines = _faces(tmp_path)
    kw = dict(root=str(tmp_path), landmarks_path=marks)
    if case == "short":
        (tmp_path / "lm.txt").write_text(lm_lines[0] + "\n")
    elif case == "long":
        (tmp_path / "lm.txt").write_text("\n".join(lm_lines * 2) + "\n")
    elif case == "recode":
        kw["recode_size"] = 112
    elif case == "size":
        kw["align_size"] = 100
    else:
        (tmp_path / "lm.txt").write_text("1 2 3\n")
    with pytest.raises(ValueError) as want:
        jax_pack(listing, str(tmp_path / "a.faceshard"), **kw)
    with pytest.raises(ValueError) as got:
        pack_image_list(listing, str(tmp_path / "b.faceshard"), **kw)
    assert str(got.value) == str(want.value)
