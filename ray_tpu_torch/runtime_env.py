"""Runtime environments: env_vars, working_dir, py_modules, pip venvs.

Role analog: ``python/ray/runtime_env`` + ``_private/runtime_env/``
(``working_dir.py``, ``py_modules.py``, ``pip.py``, packaging/URI cache).
``py_modules`` ships local packages through the GCS KV as zip blobs the
same way the reference uploads working-dir packages to its GCS package
store, with content-addressed caching on both sides. ``pip`` builds an
isolated site directory per requirements-hash on the node (reference
``pip.py``'s URI-cached virtualenv role, realized as ``pip install
--target`` — workers share one interpreter, so prepending the site dir
is the whole isolation mechanism): the first task needing an env
creates it under an exclusive file lock, later tasks hit the cache, and
workers prepend it for the task's duration. The image has no
network, so pip sources must be reachable offline — pass
``pip_args=["--no-index", "--find-links", <wheel dir>]`` (the test
pattern) or point at an internal index. ``conda``/``container`` remain
rejected loudly (no conda/containers in the image).
"""

from __future__ import annotations

import hashlib
import io
import os
import zipfile
from typing import Any, Dict, Optional

_PKG_NAMESPACE = "rtpu_pkg"
_UNSUPPORTED = ("conda", "container", "uv")
_PIP_ENV_ROOT_VAR = "RTPU_PIP_ENV_DIR"


def package_runtime_env(renv: Optional[Dict[str, Any]],
                        runtime) -> Optional[Dict[str, Any]]:
    """Driver-side: turn local ``py_modules`` paths into content-addressed
    KV URIs so any worker on any node can materialize them."""
    if not renv:
        return renv
    for key in _UNSUPPORTED:
        if renv.get(key):
            raise ValueError(
                f"runtime_env[{key!r}] is not supported. Use "
                f"runtime_env={{'pip': [...]}} for per-task package "
                f"isolation (URI-cached per-requirements site dirs), or "
                f"ship pure-python code via py_modules.")
    out = dict(renv)
    pip = out.pop("pip", None)
    if pip is not None:
        # empty specs raise inside normalize (never silently dropped)
        out["pip_env"] = normalize_pip_env(pip)
    mods = renv.get("py_modules")
    if not mods:
        return out if out != renv else renv
    uris = []
    for mod in mods:
        path = getattr(mod, "__path__", None)
        if path:  # a module object
            mod = list(path)[0]
        mod = os.path.abspath(str(mod))
        blob = _zip_dir(mod)
        uri = f"pkg-{hashlib.sha256(blob).hexdigest()[:24]}"
        # content-addressed: overwrite=False makes re-uploads free
        runtime.kv_op("put", uri, blob, _PKG_NAMESPACE, False)
        uris.append((uri, os.path.basename(mod)))
    out.pop("py_modules")
    out["py_modules_uris"] = uris
    return out


def normalize_pip_env(pip) -> Dict[str, Any]:
    """Canonicalize ``runtime_env["pip"]`` and derive its cache URI.

    Accepts a list of requirement strings, or a dict
    ``{"packages": [...], "pip_args": [...]}``. The URI hashes the SORTED
    requirements, the ORDERED pip_args, and the interpreter version, so
    identical envs share one site dir regardless of package order or
    calling driver.
    """
    import sys

    if isinstance(pip, (list, tuple)):
        packages, pip_args = list(pip), []
    elif isinstance(pip, dict):
        packages = list(pip.get("packages") or [])
        pip_args = list(pip.get("pip_args") or [])
    else:
        raise ValueError(
            f"runtime_env['pip'] must be a list of requirements or a "
            f"dict with 'packages'/'pip_args', got {type(pip).__name__}")
    if not packages:
        raise ValueError("runtime_env['pip'] has no packages")
    # domain-separated sections; pip_args keep their ORDER (flag/value
    # pairs are positional) while packages sort (sets, not sequences)
    key = ("pkgs:" + "\n".join(sorted(str(p) for p in packages))
           + "\x00args:" + "\n".join(str(a) for a in pip_args)
           + f"\x00py{sys.version_info[0]}.{sys.version_info[1]}")
    uri = f"pipenv-{hashlib.sha256(key.encode()).hexdigest()[:24]}"
    return {"uri": uri, "packages": packages, "pip_args": pip_args}


def _pip_env_root() -> str:
    return os.environ.get(_PIP_ENV_ROOT_VAR) or os.path.join(
        "/tmp", "rtpu-pip-envs")


def ensure_pip_env(pip_env: Dict[str, Any]) -> str:
    """Materialize the environment for ``pip_env`` (reference ``pip.py``'s
    URI-cached virtualenv role) and return its site-packages dir.

    The env is a plain ``pip install --target`` site directory — workers
    PREPEND it to sys.path rather than exec-ing a separate interpreter,
    so a full venv skeleton (bin/, pyvenv.cfg) would be dead weight.
    First use on a node installs the requirements under an exclusive
    flock — concurrent workers needing the same env wait for the creator
    rather than racing; every later use is a cache hit gated on the
    ``.ready`` marker (which records the requirements for
    debuggability). Creation failures tear the dir down so a partial env
    can never be mistaken for a cache hit.
    """
    import fcntl
    import subprocess
    import sys

    root = _pip_env_root()
    env_dir = os.path.join(root, pip_env["uri"])
    ready = os.path.join(env_dir, ".ready")
    site = os.path.join(env_dir, "site-packages")
    if os.path.exists(ready):
        return site
    os.makedirs(root, exist_ok=True)
    lock_path = os.path.join(root, pip_env["uri"] + ".lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(ready):   # creator finished while we waited
                return site
            try:
                os.makedirs(site, exist_ok=True)
                cmd = [sys.executable, "-m", "pip", "install",
                       "--quiet", "--target", site,
                       *pip_env.get("pip_args", []),
                       *pip_env["packages"]]
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=600)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"pip install failed for runtime_env "
                        f"{pip_env['uri']}: {proc.stderr[-1000:]}")
                with open(ready, "w") as f:
                    f.write("\n".join(pip_env["packages"]) + "\n")
                return site
            except BaseException:
                import shutil

                shutil.rmtree(env_dir, ignore_errors=True)
                raise
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _zip_dir(path: str) -> bytes:
    if not os.path.exists(path):
        raise FileNotFoundError(f"py_modules path {path!r} does not exist")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        if os.path.isfile(path):
            zf.write(path, os.path.basename(path))
        else:
            base = os.path.basename(path)
            for root, _, files in os.walk(path):
                for f in files:
                    if f.endswith(".pyc"):
                        continue
                    full = os.path.join(root, f)
                    rel = os.path.join(base, os.path.relpath(full, path))
                    zf.write(full, rel)
    return buf.getvalue()


def materialize_py_modules(uris, kv_get) -> list:
    """Worker-side: fetch + extract each package (cached by content hash);
    returns the sys.path entries to add."""
    out = []
    cache_root = os.path.join("/tmp", "rtpu-pkgs")
    for uri, _name in uris:
        target = os.path.join(cache_root, uri)
        if not os.path.isdir(target):
            blob = kv_get(uri)
            if blob is None:
                raise RuntimeError(f"py_modules package {uri} not found in KV")
            tmp = target + ".tmp-" + str(os.getpid())
            os.makedirs(tmp, exist_ok=True)
            with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                zf.extractall(tmp)
            try:
                os.rename(tmp, target)  # atomic publish; loser cleans up
            except OSError:
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
        out.append(target)
    return out
