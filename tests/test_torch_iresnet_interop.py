"""The port's InsightFace iResNet interop (interop/torch_iresnet.py,
cli.import_torch, cli.export_torch) vs the JAX package's.

The oracle is ``tests/test_iresnet.py``'s torch iresnet with InsightFace
state_dict names (narrow widths, seeded, its BN statistics moved).
Tolerances: the ``.npz`` key space the port writes equals JAX's leaf for
leaf (bit-equal); import∘export is bit-exact; the port's iResNet forward
from the imported weights is allclose to the InsightFace net's (rtol
2e-4, atol 5e-4, f32, the JAX test's bar); a ``.pt`` either package's
``export_torch`` writes loads in the other's ``import_torch``,
bit-equal.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_iresnet import DIM, SIZE, STAGES, WIDTHS, _torch_iresnet
from tf_face_toolbox_tpu.interop import port as jax_port
from tf_face_toolbox_tpu.interop import torch_iresnet as jax_ti
from tf_face_toolbox_tpu_torch.interop import port
from tf_face_toolbox_tpu_torch.interop import torch_iresnet as ti
from tf_face_toolbox_tpu_torch.models.iresnet import IResNet

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_run = functools.partial(
    subprocess.run, cwd=ROOT, capture_output=True, text=True, timeout=300,
    env={**os.environ, "OMP_NUM_THREADS": "1", "TFFT_PLATFORM": "cpu"})


@pytest.fixture(scope="module")
def tnet():
    return _torch_iresnet()


def _sd(net) -> dict:
    return {k: v.numpy() for k, v in net.state_dict().items()}


def _assert_same_flat(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_import_is_jax_s_leaf_for_leaf(tnet):
    got = port.flatten_variables(
        ti.iresnet_state_dict_to_variables(_sd(tnet), stage_sizes=STAGES))
    want = jax_port.flatten_variables(
        jax_ti.iresnet_state_dict_to_variables(_sd(tnet), stage_sizes=STAGES))
    _assert_same_flat(got, want)


def test_prefix_fp16_and_wrapped_checkpoints_are_jax_s(tnet, tmp_path):
    """``module.`` prefixes stripped, fp16 leaves cast to f32, and a
    ``{"state_dict": ...}`` training checkpoint read as JAX reads it."""
    half = {f"module.{k}": (v.half() if v.is_floating_point() else v)
            for k, v in tnet.state_dict().items()}
    path = str(tmp_path / "wrapped.pth")
    torch.save({"state_dict": half, "epoch": 3}, path)
    sd = ti.load_torch_state_dict(path)
    _assert_same_flat(sd, jax_ti.load_torch_state_dict(path))
    got = port.flatten_variables(
        ti.iresnet_state_dict_to_variables(sd, stage_sizes=STAGES))
    want = jax_port.flatten_variables(
        jax_ti.iresnet_state_dict_to_variables(sd, stage_sizes=STAGES))
    _assert_same_flat(got, want)
    assert all(v.dtype == np.float32 for v in got.values())


def test_port_forward_matches_the_insightface_net(tnet):
    flat = port.flatten_variables(
        ti.iresnet_state_dict_to_variables(_sd(tnet), stage_sizes=STAGES))
    net = IResNet(stage_sizes=STAGES, stage_widths=WIDTHS, embedding_dim=DIM,
                  input_size=SIZE).eval()
    port.load_jax_variables(net, flat)
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (4, SIZE, SIZE, 3)).astype(np.float32)
    xn = torch.tensor((u8 - 127.5) / 127.5)
    with torch.no_grad():
        ref = tnet(xn.permute(0, 3, 1, 2)).numpy()
        out = net(xn).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=5e-4)


def test_export_loads_strict_and_round_trips(tnet):
    variables = ti.iresnet_state_dict_to_variables(_sd(tnet),
                                                   stage_sizes=STAGES)
    out_sd = ti.variables_to_iresnet_state_dict(variables,
                                                stage_sizes=STAGES)
    assert set(out_sd) == set(tnet.state_dict())
    _assert_same_flat(out_sd, jax_ti.variables_to_iresnet_state_dict(
        jax_ti.iresnet_state_dict_to_variables(_sd(tnet), stage_sizes=STAGES),
        stage_sizes=STAGES))
    tnet2 = _torch_iresnet()
    tnet2.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in out_sd.items()}, strict=True)
    tnet2.eval()
    x = torch.tensor(np.random.default_rng(1).normal(
        size=(3, 3, SIZE, SIZE)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(tnet2(x).numpy(), tnet(x).numpy(),
                                   rtol=1e-5, atol=1e-5)
    back = ti.iresnet_state_dict_to_variables(out_sd, stage_sizes=STAGES)
    _assert_same_flat(port.flatten_variables(back),
                      port.flatten_variables(variables))


@pytest.mark.parametrize("case", ["extra_key", "wrong_stages"])
def test_strict_refuses_as_jax_does(tnet, case):
    sd = _sd(tnet)
    stages = STAGES
    if case == "extra_key":
        sd["kps.weight"] = np.zeros(3, np.float32)  # a bundled extra head
    else:
        stages = (1, 1)         # the checkpoint has (1, 2)
    with pytest.raises(ValueError) as want:
        jax_ti.iresnet_state_dict_to_variables(dict(sd), stage_sizes=stages)
    with pytest.raises(ValueError, match="unconsumed") as got:
        ti.iresnet_state_dict_to_variables(dict(sd), stage_sizes=stages)
    assert str(got.value) == str(want.value)
    if case == "extra_key":
        _assert_same_flat(
            port.flatten_variables(ti.iresnet_state_dict_to_variables(
                dict(sd), stage_sizes=stages, strict=False)),
            jax_port.flatten_variables(jax_ti.iresnet_state_dict_to_variables(
                dict(sd), stage_sizes=stages, strict=False)))


def test_imported_keys_are_the_port_network_s(tnet):
    flat = port.flatten_variables(
        ti.iresnet_state_dict_to_variables(_sd(tnet), stage_sizes=STAGES))
    net = IResNet(stage_sizes=STAGES, stage_widths=WIDTHS, embedding_dim=DIM,
                  input_size=SIZE)
    assert {k: np.shape(v) for k, v in flat.items()} == {
        key: port.jax_shape(t, kind) for key, t, kind in port.jax_leaves(net)}


# ---- the CLIs, across the two packages -----------------------------------


def _cli(package: str, name: str, *args) -> str:
    """A JAX CLI as a subprocess (absl flags are process-global); a port
    CLI's ``main`` in this process."""
    if package == "tf_face_toolbox_tpu_torch" and name != "train":
        import contextlib
        import importlib
        import io

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            importlib.import_module(f"{package}.cli.{name}").main(list(args))
        return out.getvalue()
    proc = _run([sys.executable, "-m", f"{package}.cli.{name}", *args])
    assert proc.returncode == 0, f"{package}.{name}:\n{proc.stderr[-3000:]}"
    return proc.stdout


@pytest.mark.mid
def test_export_and_import_across_the_two_packages(tmp_path):
    """npz -> either package's export_torch -> the other's import_torch
    -> npz, bit-equal, over the registry's iresnet_tiny layout; the
    port's CLIs print the JAX CLIs' lines."""
    from tf_face_toolbox_tpu_torch.models import create_network, random_variables

    net = create_network("iresnet_tiny", embedding_dim=DIM, input_size=SIZE)
    flat = random_variables(net, 7)
    npz = str(tmp_path / "in.npz")
    port.save_variables_npz(npz, flat)
    size = f"--image_size={SIZE}"
    for exporter, importer in (("tf_face_toolbox_tpu_torch",
                                "tf_face_toolbox_tpu"),
                               ("tf_face_toolbox_tpu",
                                "tf_face_toolbox_tpu_torch")):
        pt = str(tmp_path / f"{exporter}.pth")
        out = _cli(exporter, "export_torch", f"--variables_npz={npz}",
                   f"--output={pt}", "--network=iresnet_tiny",
                   "--input_norm=fixed")
        assert out.strip().endswith("feed the torch side (x - 127.5) / 127.5")
        back = str(tmp_path / f"{importer}.npz")
        out = _cli(importer, "import_torch", f"--pt={pt}", f"--output={back}",
                   "--network=iresnet_tiny", size)
        assert f"({DIM}-d embedding)" in out and "serve with" in out
        _assert_same_flat(port.flatten_variables(port.load_variables_npz(back)),
                          flat)


@pytest.mark.mid
def test_export_torch_reads_a_port_checkpoint(tmp_path):
    """cli.export_torch --checkpoint_dir (--use_ema, --step) reads the
    port's own train checkpoints, as cli.extract does; the .pth is the
    exporter of those variables."""
    from tf_face_toolbox_tpu_torch.interop.port import unflatten_variables
    from tf_face_toolbox_tpu_torch.pretrained import load_variables

    run = str(tmp_path / "run")
    _cli("tf_face_toolbox_tpu_torch", "train", "--device", "cpu",
         "--network", "iresnet_tiny", "--input_norm", "fixed",
         "--embedding_dim", str(DIM), "--image_size", str(SIZE),
         "--crop_from", "20", "--global_batch", "8", "--num_classes", "10",
         "--num_steps", "2", "--save_every", "1", "--nobf16",
         "--ema_decay", "0.9", "--train_dir", run)
    pt = str(tmp_path / "ema1.pth")
    out = _cli("tf_face_toolbox_tpu_torch", "export_torch",
               f"--checkpoint_dir={run}", f"--output={pt}",
               "--network=iresnet_tiny", f"--embedding_dim={DIM}",
               f"--image_size={SIZE}", "--use_ema", "--step=1")
    assert "step=1, EMA" in out and "per-image standardization" in out
    _, flat = load_variables(run, "iresnet_tiny", DIM, SIZE, torch.float32,
                             use_ema=True, head="flatten", step=1)
    want = ti.variables_to_iresnet_state_dict(unflatten_variables(flat),
                                              stage_sizes=(1, 1))
    _assert_same_flat(ti.load_torch_state_dict(pt), want)
    _, latest = load_variables(run, "iresnet_tiny", DIM, SIZE, torch.float32,
                               head="flatten")
    assert not np.array_equal(latest["params/fc/kernel"],
                              flat["params/fc/kernel"])

