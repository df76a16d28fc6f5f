"""The PyTorch port stands alone: no module of ``ray_tpu_torch`` (and not
``chip_smoke.py``) imports JAX or anything of the JAX package ``ray_tpu``,
not even a module with no JAX in it. An AST walk, so the check also covers
imports inside functions."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "ray_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ray_tpu")


def _forbidden_imports(path):
    tree = ast.parse(open(path).read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and _forbidden(node.args[0].value)):
            bad.append(node.args[0].value)
    return bad


def test_port_files_found():
    files = _port_files()
    rel = {os.path.relpath(f, ROOT) for f in files}
    assert "chip_smoke.py" in rel
    assert "ray_tpu_torch/ops/flash_cuda.py" in rel
    assert "ray_tpu_torch/serve/llm.py" in rel


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_ray_tpu_imports(path):
    assert _forbidden_imports(path) == [], path


def test_checker_catches_forbidden_imports(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\n"
                   "def f():\n    from ray_tpu.models import config\n"
                   "import importlib\nimportlib.import_module('ray_tpu.ops')\n")
    assert sorted(_forbidden_imports(str(bad))) == [
        "jax.numpy", "ray_tpu.models", "ray_tpu.ops"]
    ok = tmp_path / "ok.py"
    ok.write_text("import ray_tpu_torch\nfrom ray_tpu_torch.ops import layers\n")
    assert _forbidden_imports(str(ok)) == []
