"""serve.run / serve.shutdown / handles / multiplexing.

Role analog: ``python/ray/serve/api.py`` (``serve.run :545``). The client
side: package the bound application into specs, hand them to the named
controller actor, return the entry deployment's handle.
"""

from __future__ import annotations

import contextvars
import functools
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.deployment import Application, Deployment
from ray_tpu_torch.serve.handle import DeploymentHandle, _AppRefSentinel


def _get_or_create_controller():
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        cls = ray_tpu_torch.remote(ServeController)
        return cls.options(name=CONTROLLER_NAME, num_cpus=0).remote()


def _spec_for(app: Application) -> Dict[str, Any]:
    dep = app.deployment
    composed = []

    def encode(x):
        if isinstance(x, Application):
            composed.append(x.deployment.name)
            return _AppRefSentinel(x.deployment.name)
        return x

    init_args = tuple(encode(a) for a in app.init_args)
    init_kwargs = {k: encode(v) for k, v in app.init_kwargs.items()}
    cfg = dep.config
    return {
        "name": dep.name,
        "cls_blob": cloudpickle.dumps(dep.func_or_class),
        "init_args": cloudpickle.dumps(init_args),
        "init_kwargs": cloudpickle.dumps(init_kwargs),
        "composed": composed,
        "config": {
            "num_replicas": cfg.num_replicas,
            "max_ongoing_requests": cfg.max_ongoing_requests,
            "autoscaling_config": (vars(cfg.autoscaling_config)
                                   if cfg.autoscaling_config else None),
            "ray_actor_options": cfg.ray_actor_options,
            "user_config": cfg.user_config,
            "compiled": bool(getattr(cfg, "compiled", False)),
        },
    }


# app name -> (route, entry handle): feeds start_http_proxy / the CLI
_deployed_apps: Dict[str, tuple] = {}


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = None) -> DeploymentHandle:
    """Deploy the application; returns a handle to its entry deployment."""
    if isinstance(app, Deployment):
        app = app.bind()
    controller = _get_or_create_controller()
    specs = [_spec_for(a) for a in app.flatten().values()]
    ray_tpu_torch.get(controller.deploy_application.remote(specs))
    handle = DeploymentHandle(app.deployment.name, controller)
    handle._refresh(force=True)
    route = (route_prefix or app.deployment.name).strip("/")
    _deployed_apps[name] = (route, handle)
    return handle


def start_http_proxy(port: int = 8000, host: str = "127.0.0.1"):
    """Start the HTTP proxy with every deployed application's route
    registered (reference: per-node ProxyActor wiring routes from the
    controller's long-poll; here routes come from this process's deploys)."""
    from ray_tpu_torch.serve.proxy import HTTPProxy

    proxy = HTTPProxy(host=host, port=port)
    for route, handle in _deployed_apps.values():
        proxy.register(route, handle)
    proxy.start()
    return proxy


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, _get_or_create_controller())


def delete(name: str) -> None:
    controller = _get_or_create_controller()
    ray_tpu_torch.get(controller.delete_deployment.remote(name))
    # prune proxy-route entries whose entry deployment just went away
    for app, (_route, handle) in list(_deployed_apps.items()):
        if handle.deployment_name == name:
            _deployed_apps.pop(app, None)


def status() -> Dict[str, Any]:
    controller = _get_or_create_controller()
    return ray_tpu_torch.get(controller.list_deployments.remote())


def model_report() -> Dict[str, Any]:
    """Cluster-wide multi-model residency view (``rtpu list models`` /
    ``GET /api/models``). Read-only: never creates a controller."""
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        return {}
    return ray_tpu_torch.get(controller.model_report.remote())


def shutdown() -> None:
    _deployed_apps.clear()  # stale handles must not outlive the controller
    # compiled execution plane: tear down every cached per-replica DAG
    # while the replicas are still alive (graceful _Stop propagation) —
    # their shm channels must not outlive serve
    from ray_tpu_torch.serve import handle as _handle_mod

    with _handle_mod._dag_lock():
        dags = [ent[1] for ent in _handle_mod._dag_cache.values()]
        _handle_mod._dag_cache.clear()
    for dag in dags:
        try:
            dag.teardown(timeout=2.0)
        except Exception:
            pass
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote())
        ray_tpu_torch.kill(controller)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# Model multiplexing (reference serve/multiplex.py)
# ---------------------------------------------------------------------------

_multiplexed_model_id: contextvars.ContextVar = contextvars.ContextVar(
    "multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    return _multiplexed_model_id.get()


def multiplexed(fn=None, *, max_num_models_per_replica: int = 3):
    """Decorate an async model-loader method; an LRU of loaded models is
    kept per replica (reference ``serve/multiplex.py``)."""

    def wrap(load_fn):
        caches: Dict[int, OrderedDict] = {}

        @functools.wraps(load_fn)
        async def wrapper(self, model_id: str):
            cache = caches.setdefault(id(self), OrderedDict())
            if model_id in cache:
                cache.move_to_end(model_id)
                return cache[model_id]
            model = load_fn(self, model_id)
            import inspect

            if inspect.iscoroutine(model):
                model = await model
            cache[model_id] = model
            if len(cache) > max_num_models_per_replica:
                cache.popitem(last=False)
            return model

        return wrapper

    if fn is None:
        return wrap
    return wrap(fn)
