"""Declarative serve config: YAML/JSON schema + deploy + REST surface (twin
of ``ray_tpu/serve/config_api.py``).

Role analog: the reference's serve config pipeline — ``serve build`` /
``serve deploy`` CLI (``python/ray/serve/scripts.py``), the pydantic
config schema (``serve/schema.py``), and the dashboard serve REST API
(``dashboard/modules/serve``). Schema (YAML or JSON)::

    applications:
      - name: default            # optional (default "default")
        import_path: mypkg.app:app   # module:attr -> Application/Deployment
        route_prefix: /app           # optional (default = deployment name)
        deployments:                 # optional per-deployment overrides
          - name: Model
            num_replicas: 2
            max_ongoing_requests: 8

``deploy_config`` applies it against the in-process serve instance (a dict
works as well as a loaded file; ``yaml`` is imported only by
``load_config``). The ``serve_rest_*`` functions are the payloads of the
dashboard's GET/PUT/DELETE ``/api/serve/applications``; the port has no
dashboard yet (ROADMAP.md queue 1 item 4) and no ``serve`` CLI (item 9), so
they are called directly.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict) or "applications" not in cfg:
        raise ValueError(
            "serve config must be a mapping with an 'applications' list")
    return cfg


def import_attr(import_path: str):
    """``module.sub:attr`` -> the attribute (reference import_attr role)."""
    if ":" not in import_path:
        raise ValueError(
            f"import_path {import_path!r} must look like 'module:attr'")
    mod_name, _, attr = import_path.partition(":")
    mod = importlib.import_module(mod_name)
    obj = mod
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def deploy_config(cfg: Dict[str, Any]) -> List[str]:
    """Deploy every application in ``cfg`` in-process; returns app names."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.deployment import Application, Deployment

    deployed = []
    for app_cfg in cfg.get("applications", []):
        app = import_attr(app_cfg["import_path"])
        if isinstance(app, Deployment):
            app = app.bind()
        if not isinstance(app, Application):
            raise TypeError(
                f"{app_cfg['import_path']} resolved to {type(app).__name__};"
                " expected an Application or Deployment")
        overrides = {d["name"]: {k: v for k, v in d.items() if k != "name"}
                     for d in app_cfg.get("deployments", [])}
        if overrides:
            for node in app.flatten().values():
                dep = node.deployment
                opts = overrides.get(dep.name)
                if opts:
                    node.deployment = dep.options(**opts)
        name = app_cfg.get("name", "default")
        serve.run(app, name=name,
                  route_prefix=app_cfg.get("route_prefix"))
        deployed.append(name)
    return deployed


def serve_rest_get() -> Dict[str, Any]:
    """GET /api/serve/applications payload."""
    from ray_tpu_torch import serve

    try:
        return {"applications": serve.status()}
    except Exception as e:
        return {"applications": {}, "error": str(e)}


def serve_models_get() -> Dict[str, Any]:
    """GET /api/models payload: per-deployment replica model residency
    (tier, swap counters, inflight) plus prefix-digest summaries."""
    from ray_tpu_torch.serve import api as serve_api

    try:
        return {"deployments": serve_api.model_report()}
    except Exception as e:
        return {"deployments": {}, "error": str(e)}


def serve_rest_put(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """PUT /api/serve/applications: declarative (re)deploy."""
    return {"deployed": deploy_config(cfg)}


def serve_rest_delete() -> Dict[str, Any]:
    from ray_tpu_torch import serve

    serve.shutdown()
    return {"shutdown": True}
