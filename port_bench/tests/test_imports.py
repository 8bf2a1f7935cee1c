"""No module of the benchmark imports JAX, flax or the JAX package, and
the reference (``reference/`` and the families' forwards in
``families/``) imports nothing of the program either. Names are compared
whole, by the part before the first dot: the program's package name
begins with the JAX package's."""

from __future__ import annotations

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "tf_face_toolbox_tpu"}
PROGRAM = "tf_face_toolbox_tpu_torch"


def modules() -> list[str]:
    out = []
    for folder, dirs, files in os.walk(HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out += [os.path.join(folder, f) for f in files if f.endswith(".py")]
    return sorted(out)


def top_level_imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_walks_every_module():
    found = modules()
    rel = {os.path.relpath(p, HERE) for p in found}
    assert "run.py" in rel and "reference/search.py" in rel
    assert "families/resnet.py" in rel
    assert any(r.startswith("metrics/") for r in rel)


@pytest.mark.parametrize("path", modules(),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in modules()
             if os.path.relpath(p, HERE).startswith(
                 ("reference" + os.sep, "families" + os.sep))],
    ids=lambda p: os.path.relpath(p, HERE))
def test_reference_is_independent(path):
    assert PROGRAM not in top_level_imports(path)


def test_names_compared_whole(tmp_path):
    """A program import reads as the program, not as the JAX package."""
    f = tmp_path / "m.py"
    f.write_text("import tf_face_toolbox_tpu_torch.models\n"
                 "from tf_face_toolbox_tpu import bench\n")
    names = top_level_imports(str(f))
    assert names == {PROGRAM, "tf_face_toolbox_tpu"}
    assert names & FORBIDDEN == {"tf_face_toolbox_tpu"}
