"""ReplicaActor: wraps the user's deployment callable.

Role analog: ``python/ray/serve/_private/replica.py:231`` (``ReplicaActor``
+ ``UserCallableWrapper :737``). A replica is an actor; requests arrive as
ordinary actor calls. TPU angle: a replica that owns TPU chips loads a
jitted model once in ``__init__`` and every request hits the compiled
function — batched inference composes with ``@serve.batch``.
"""

from __future__ import annotations

import inspect
import time
from typing import Any, Dict, Optional


def _resolve_refs(args, kwargs):
    """``bind(..., params=ray_tpu_torch.put(params))``: an ObjectRef given
    as a top-level constructor argument reaches the deployment as its value,
    read from the object store in this process (tensors arrive as views of
    the store), as a task's top-level ref arguments do."""
    from ray_tpu_torch.core.object_ref import ObjectRef

    refs = [a for a in (*args, *kwargs.values()) if isinstance(a, ObjectRef)]
    if not refs:
        return args, kwargs
    import ray_tpu_torch

    values = dict(zip(map(id, refs), ray_tpu_torch.get(refs)))
    return (tuple(values.get(id(a), a) for a in args),
            {k: values.get(id(v), v) for k, v in kwargs.items()})


class ReplicaActor:
    def __init__(self, cls_or_fn, init_args, init_kwargs,
                 user_config: Optional[Dict[str, Any]] = None,
                 handle_args: Optional[Dict[str, Any]] = None,
                 deployment_name: Optional[str] = None):
        # handle_args: deployment-name -> handle for composed models
        self._is_function = inspect.isfunction(cls_or_fn) or \
            inspect.isbuiltin(cls_or_fn)
        if self._is_function:
            self._callable = cls_or_fn
        else:
            init_args, init_kwargs = _resolve_refs(init_args, init_kwargs)
            self._callable = cls_or_fn(*init_args, **init_kwargs)
        self._user_config = user_config
        if user_config is not None and hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)
        self._num_requests = 0
        self._start_time = time.time()
        self._deployment_name = deployment_name
        # load-report push loop (ISSUE 12 routing signal): deployments
        # exposing load_state() advertise {inflight, kv_free, kv_total}
        # to the controller on a fixed cadence — capture our actor id NOW
        # (current_actor_id is task-context-local; the push thread runs
        # outside any task)
        if (deployment_name is not None
                and hasattr(self._callable, "load_state")):
            from ray_tpu_torch import config as _cfg

            interval = float(_cfg.get("serve_load_report_interval_s"))
            if interval > 0:
                import threading

                import ray_tpu_torch

                aid = ray_tpu_torch.get_runtime_context().get_actor_id()
                self._push_thread = threading.Thread(
                    target=self._push_loop,
                    args=(interval, bytes.fromhex(aid) if aid else b""),
                    daemon=True, name="replica-load-report")
                self._push_thread.start()

    def _push_loop(self, interval: float, actor_id: bytes) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        ctrl = None
        # daemon thread: dies with the replica process (kill/scale-down);
        # there is no graceful-stop path to wire it into
        while True:
            time.sleep(interval)
            try:
                if ctrl is None:
                    ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
                load = self._callable.load_state()
                ctrl.report_replica_load.remote(
                    self._deployment_name, actor_id, load)
            except Exception:
                # controller restarted / unreachable: re-resolve next
                # beat — a stale routing signal, never a dead replica
                ctrl = None

    def handle_request(self, method_name: str, args, kwargs):
        self._num_requests += 1
        if self._is_function:
            fn = self._callable
        else:
            fn = getattr(self._callable, method_name or "__call__")
        from ray_tpu_torch.util import tracing

        if not tracing.tracing_enabled():
            out = fn(*args, **kwargs)
        else:
            # nests under the worker's execute span (thread-local), so
            # the serve request trace separates replica user-code time
            # from the actor-call machinery around it
            with tracing.span("serve.replica::execute",
                              {"method": method_name or "__call__"}):
                out = fn(*args, **kwargs)
        if inspect.iscoroutine(out):
            import asyncio

            out = asyncio.get_event_loop().run_until_complete(out)
        return out

    def handle_request_packed(self, request):
        """Compiled-DAG entry point (r13): the DAG edge carries ONE value,
        so the (method, args, kwargs) triple arrives packed."""
        method_name, args, kwargs = request
        return self.handle_request(method_name, args, kwargs)

    def reconfigure(self, user_config: Dict[str, Any]):
        self._user_config = user_config
        if hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)

    def check_health(self) -> bool:
        if hasattr(self._callable, "check_health"):
            self._callable.check_health()
        return True

    def stats(self) -> Dict[str, Any]:
        return {
            "num_requests": self._num_requests,
            "uptime_s": time.time() - self._start_time,
        }
