"""Deployment: declarative unit of serving.

Role analog: ``python/ray/serve/deployment.py`` — the ``@serve.deployment``
decorator produces a Deployment (user class/function + replica/autoscaling
config); ``.bind(*args)`` produces an Application node; ``serve.run`` hands
the app to the controller.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 10
    target_ongoing_requests: float = 2.0
    upscale_factor: float = 1.5
    downscale_factor: float = 0.7
    # KV-occupancy target (LLM deployments): scale up when the average
    # reported used-block fraction exceeds this; None = ongoing-requests
    # policy only
    target_kv_utilization: Optional[float] = None


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    autoscaling_config: Optional[AutoscalingConfig] = None
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    user_config: Optional[Dict[str, Any]] = None
    health_check_period_s: float = 10.0
    # compiled execution plane: steady-state requests route through a
    # compiled DAG per replica (shm channels, no per-call task
    # submission); replicas get a second concurrency slot so control
    # calls (health checks, reconfigure) stay reachable while the DAG
    # exec loop occupies the first
    compiled: bool = False


class Deployment:
    def __init__(self, func_or_class, name: str,
                 config: Optional[DeploymentConfig] = None):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config or DeploymentConfig()

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[int] = None,
                max_ongoing_requests: Optional[int] = None,
                autoscaling_config=None,
                ray_actor_options: Optional[Dict[str, Any]] = None,
                user_config: Optional[Dict[str, Any]] = None,
                compiled: Optional[bool] = None) -> "Deployment":
        import copy

        cfg = copy.deepcopy(self.config)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if autoscaling_config is not None:
            cfg.autoscaling_config = (
                AutoscalingConfig(**autoscaling_config)
                if isinstance(autoscaling_config, dict) else autoscaling_config)
        if ray_actor_options is not None:
            cfg.ray_actor_options = ray_actor_options
        if user_config is not None:
            cfg.user_config = user_config
        if compiled is not None:
            cfg.compiled = bool(compiled)
        return Deployment(self.func_or_class, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __repr__(self):
        return f"Deployment({self.name!r}, {self.config.num_replicas} replicas)"


@dataclass
class Application:
    """A bound deployment (possibly with other Applications as init args —
    model composition, reference ``deployment_graph_build.py``)."""

    deployment: Deployment
    init_args: Tuple = ()
    init_kwargs: Dict[str, Any] = field(default_factory=dict)

    def flatten(self) -> Dict[str, "Application"]:
        """All applications in the graph keyed by deployment name."""
        out = {self.deployment.name: self}
        for a in list(self.init_args) + list(self.init_kwargs.values()):
            if isinstance(a, Application):
                out.update(a.flatten())
        return out


def deployment(func_or_class=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_ongoing_requests: int = 8,
               autoscaling_config=None, ray_actor_options=None,
               user_config=None, compiled: bool = False):
    """``@serve.deployment`` decorator (reference ``serve/api.py``)."""

    def wrap(fc):
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=(AutoscalingConfig(**autoscaling_config)
                                if isinstance(autoscaling_config, dict)
                                else autoscaling_config),
            ray_actor_options=ray_actor_options or {},
            user_config=user_config,
            compiled=compiled,
        )
        return Deployment(fc, name or fc.__name__, cfg)

    if func_or_class is None:
        return wrap
    return wrap(func_or_class)
