"""The PyTorch port stands alone: no module of ``ray_tpu_torch`` (and not
``chip_smoke.py``) imports JAX or anything of the JAX package ``ray_tpu``,
not even a module with no JAX in it. An AST walk, so the check also covers
imports inside functions.

The runtime also starts processes from module paths written as strings (the
zygote's and the worker's ``runpy.run_module``): no string literal may name
a ``ray_tpu.`` module, since a copy that kept one would quietly run the JAX
package's worker. And every ``ray_tpu_torch`` import the port writes must
resolve to a module of the port (and a name that module defines)."""

import ast
import os
import re

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
    assert "ray_tpu_torch/models/delta.py" in rel
    assert "ray_tpu_torch/serve/multiplex.py" in rel
    for mod in ("__init__", "block", "dataset", "execution", "grouped",
                "iterator", "optimizer", "read_api", "streaming"):
        assert f"ray_tpu_torch/data/{mod}.py" in rel
    for mod in ("__init__", "collective", "coordinator", "types"):
        assert f"ray_tpu_torch/collective/{mod}.py" in rel


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


# "ray_tpu." not preceded by a word character, a dot or a slash: names a
# module of the JAX package (``ray_tpu_torch.`` and ``ray_tpu/ops/...``
# file paths do not match)
_REF_MODULE = re.compile(r"(?<![\w./])ray_tpu\.[A-Za-z_]")


def _reference_module_strings(path):
    tree = ast.parse(open(path).read(), path)
    return sorted({node.value.strip()[:80] for node in ast.walk(tree)
                   if isinstance(node, ast.Constant)
                   and isinstance(node.value, str)
                   and _REF_MODULE.search(node.value)})


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_string_names_a_reference_module(path):
    assert _reference_module_strings(path) == [], path


def _module_file(name):
    base = os.path.join(ROOT, *name.split("."))
    for cand in (os.path.join(base, "__init__.py"), base + ".py"):
        if os.path.exists(cand):
            return cand
    return None


def _top_level_names(path):
    """Names a module defines at its top level (assignments, defs, classes,
    imports), plus its submodules if it is a package."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    if path.endswith("__init__.py"):
        d = os.path.dirname(path)
        names.update(f[:-3] if f.endswith(".py") else f
                     for f in os.listdir(d))
    return names


def _unresolved_port_imports(path):
    tree = ast.parse(open(path).read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names
                    if a.name.split(".")[0] == "ray_tpu_torch"
                    and _module_file(a.name) is None]
        elif (isinstance(node, ast.ImportFrom) and node.level == 0
              and node.module
              and node.module.split(".")[0] == "ray_tpu_torch"):
            target = _module_file(node.module)
            if target is None:
                bad.append(node.module)
                continue
            defined = _top_level_names(target)
            bad += [f"{node.module}.{a.name}" for a in node.names
                    if a.name != "*" and a.name not in defined]
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            bad += [m for m in re.findall(r"run_module\('([\w.]+)'",
                                          node.value)
                    if _module_file(m) is None]
    return bad


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_resolve_to_port_modules(path):
    assert _unresolved_port_imports(path) == [], path


def test_string_and_resolution_checkers_catch_faults(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "BOOT = \"runpy.run_module('ray_tpu.core.worker')\"\n"
        "ARGV = ['ray_tpu.core.worker', '--addr']\n"
        "def f():\n    from ray_tpu_torch.tune import Tuner\n"
        "    from ray_tpu_torch.core.runtime import no_such_name\n"
        "    import ray_tpu_torch.cluster.adapter\n"
        "BOOT2 = \"runpy.run_module('ray_tpu_torch.core.nothing')\"\n")
    assert len(_reference_module_strings(str(bad))) == 2
    assert sorted(_unresolved_port_imports(str(bad))) == [
        "ray_tpu_torch.cluster.adapter",
        "ray_tpu_torch.core.nothing",
        "ray_tpu_torch.core.runtime.no_such_name",
        "ray_tpu_torch.tune"]
    ok = tmp_path / "ok.py"
    ok.write_text("P = 'ray_tpu/ops/flash_pallas.py:63'\n"
                  "B = \"runpy.run_module('ray_tpu_torch.core.worker')\"\n"
                  "from ray_tpu_torch.core.runtime import init\n"
                  "from ray_tpu_torch.util import device_plane\n")
    assert _reference_module_strings(str(ok)) == []
    assert _unresolved_port_imports(str(ok)) == []


def _imported_modules(path):
    """Every module a file imports, at any depth (function bodies too);
    ``from pkg import name`` counts as ``pkg`` and ``pkg.name``."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
            out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


@pytest.mark.parametrize("rel,expected", [
    ("ray_tpu_torch/models/delta.py",
     {"ray_tpu_torch._device", "ray_tpu_torch.models.transformer"}),
    # the registry's runtime calls and residency probe sit in function
    # bodies: the walk must see them
    ("ray_tpu_torch/serve/multiplex.py",
     {"ray_tpu_torch", "ray_tpu_torch.util.state",
      "ray_tpu_torch.util.metric_defs", "ray_tpu_torch.serve.admission",
      "ray_tpu_torch.core.runtime_context"}),
    ("ray_tpu_torch/util/device_plane.py",
     {"ray_tpu_torch.util.events", "ray_tpu_torch.util.tracing",
      "ray_tpu_torch.util.metrics"}),
])
def test_walk_covers_the_multiplexed_slice(rel, expected):
    path = os.path.join(ROOT, rel)
    assert expected <= _imported_modules(path)
    assert _forbidden_imports(path) == []
    assert _unresolved_port_imports(path) == []
    assert _reference_module_strings(path) == []


@pytest.mark.parametrize("rel,expected", [
    ("ray_tpu_torch/experimental/channel.py",
     {"ray_tpu_torch.core.serialization", "ray_tpu_torch.util.metric_defs"}),
    ("ray_tpu_torch/experimental/device_channel.py",
     {"torch", "ray_tpu_torch.experimental.channel"}),
    # the transfer plane's channel, store and runtime-context uses sit in
    # function bodies: the walk must see them
    ("ray_tpu_torch/serve/kv_transfer.py",
     {"ray_tpu_torch", "ray_tpu_torch.serve.llm",
      "ray_tpu_torch.experimental.device_channel",
      "ray_tpu_torch.experimental.channel", "ray_tpu_torch.util.failpoints",
      "ray_tpu_torch.core.runtime_context"}),
    ("ray_tpu_torch/serve/disagg.py",
     {"ray_tpu_torch", "ray_tpu_torch.serve.handle",
      "ray_tpu_torch.serve.admission", "ray_tpu_torch.core.exceptions",
      "ray_tpu_torch.util.tracing"}),
    ("ray_tpu_torch/serve/llm.py",
     {"ray_tpu_torch.serve.kv_transfer", "ray_tpu_torch.util.events"}),
])
def test_walk_covers_the_disaggregated_slice(rel, expected):
    path = os.path.join(ROOT, rel)
    assert expected <= _imported_modules(path)
    assert _forbidden_imports(path) == []
    assert _unresolved_port_imports(path) == []
    assert _reference_module_strings(path) == []


@pytest.mark.parametrize("rel,expected", [
    ("ray_tpu_torch/dag/dag_node.py",
     {"ray_tpu_torch.experimental.device_channel",
      "ray_tpu_torch.dag.compiled_dag"}),
    # the exec loop's runtime, tracing and metric uses sit in function
    # bodies: the walk must see them
    ("ray_tpu_torch/dag/compiled_dag.py",
     {"torch", "ray_tpu_torch", "ray_tpu_torch.dag.dag_node",
      "ray_tpu_torch.experimental.channel",
      "ray_tpu_torch.experimental.device_channel",
      "ray_tpu_torch.core.runtime", "ray_tpu_torch.util.tracing",
      "ray_tpu_torch.util.metric_defs", "ray_tpu_torch.config"}),
    ("ray_tpu_torch/dag/__init__.py",
     {"ray_tpu_torch.dag.dag_node", "ray_tpu_torch.dag.compiled_dag"}),
    ("ray_tpu_torch/serve/handle.py",
     {"ray_tpu_torch", "ray_tpu_torch.dag",
      "ray_tpu_torch.experimental.channel"}),
    # grpc and yaml are imported inside functions: the package imports
    # without them
    ("ray_tpu_torch/serve/grpc_proxy.py",
     {"grpc", "ray_tpu_torch.serve.handle"}),
    ("ray_tpu_torch/serve/config_api.py",
     {"yaml", "ray_tpu_torch.serve", "ray_tpu_torch.serve.deployment",
      "ray_tpu_torch.serve.api"}),
    ("ray_tpu_torch/core/actor.py", {"ray_tpu_torch.dag.dag_node"}),
    ("ray_tpu_torch/core/remote_function.py", {"ray_tpu_torch.dag.dag_node"}),
])
def test_walk_covers_the_compiled_slice(rel, expected):
    path = os.path.join(ROOT, rel)
    assert expected <= _imported_modules(path)
    assert _forbidden_imports(path) == []
    assert _unresolved_port_imports(path) == []
    assert _reference_module_strings(path) == []


def test_serve_imports_without_grpc_or_yaml():
    """``import ray_tpu_torch.serve`` (and the DAG package) must work on a
    machine without ``grpcio`` or ``yaml``: the card's has neither."""
    import subprocess
    import sys

    code = ("import sys\n"
            "class _Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('grpc', 'yaml'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, _Block())\n"
            "import ray_tpu_torch.serve, ray_tpu_torch.dag\n"
            "from ray_tpu_torch.serve import GrpcProxy, config_api\n"
            "assert 'grpc' not in sys.modules and 'yaml' not in sys.modules\n"
            "assert 'jax' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
