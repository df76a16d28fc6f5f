"""ActorClass / ActorHandle / ActorMethod.

Role analog: reference ``python/ray/actor.py`` (``ActorClass :566``,
``ActorHandle :1226``, ``ActorMethod :116``). Each actor is a dedicated
worker process; method calls are dispatched in submission order by the
driver (the reference's sequential actor submit queue,
``src/ray/core_worker/transport/sequential_actor_submit_queue.cc``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.core import task_spec as ts
from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.remote_function import _normalize_resources, _pg_options


class ActorMethod:
    def __init__(self, actor_id: ActorID, method_name: str,
                 options: Optional[Dict] = None, tmpl_cache: Optional[Dict] = None):
        self._actor_id = actor_id
        self._method_name = method_name
        self._options = dict(options or {})
        # submit fast-path (r13): the handle-owned template cache —
        # ActorMethod objects are born per attribute access, so the
        # invariant spec parts cache on the HANDLE, keyed by the
        # spec-shaping options (a changed option set is a different key,
        # never a stale template)
        self._tmpl_cache = tmpl_cache if tmpl_cache is not None else {}

    def options(self, **new_options):
        return ActorMethod(self._actor_id, self._method_name,
                           {**self._options, **new_options},
                           self._tmpl_cache)

    def _template(self) -> Dict:
        num_returns = self._options.get("num_returns", 1)
        streaming = num_returns in ("streaming", "dynamic")
        bp = self._options.get("_generator_backpressure_num_objects")
        key = (self._method_name, num_returns, bp)
        tmpl = self._tmpl_cache.get(key)
        if tmpl is None:
            tmpl = ts.make_actor_method_template(
                self._actor_id.binary(),
                self._method_name,
                num_returns=1 if streaming else int(num_returns),
                streaming=streaming,
                stream_backpressure=int(bp) if streaming and bp else 0,
            )
            self._tmpl_cache[key] = tmpl
        return tmpl

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.core.runtime import _get_runtime

        rt = _get_runtime()
        enc_args, enc_kwargs, nested_refs = ts.encode_args(args, kwargs, rt)
        spec = ts.spec_from_template(self._template(), enc_args, enc_kwargs)
        if nested_refs:
            spec["borrowed"] = nested_refs
        if spec.get("streaming"):
            from ray_tpu_torch.core.object_ref import ObjectRefGenerator

            refs = rt.submit_actor_task(spec)
            return ObjectRefGenerator(
                spec["task_id"], refs[0],
                backpressured=bool(spec.get("stream_backpressure")),
                owner=getattr(rt, "cluster_node_id", None))
        refs = rt.submit_actor_task(spec)
        return refs[0] if self._options.get("num_returns", 1) == 1 else refs

    def __call__(self, *a, **kw):
        raise TypeError(
            f"actor method {self._method_name} cannot be called directly; use .remote()"
        )

    def bind(self, *args, **kwargs):
        """Build a lazy DAG node for this method (reference
        ``actor.method.bind``, ``python/ray/dag/class_node.py``)."""
        from ray_tpu_torch.dag.dag_node import ClassMethodNode

        return ClassMethodNode(
            ActorHandle(self._actor_id,
                        {self._method_name: dict(self._options)}),
            self._method_name, args, kwargs)


class ActorHandle:
    def __init__(self, actor_id: ActorID, method_options: Optional[Dict[str, Dict]] = None):
        object.__setattr__(self, "_actor_id", actor_id)
        object.__setattr__(self, "_method_options", method_options or {})
        # per-handle spec-template cache shared by every ActorMethod this
        # handle hands out (r13 submit fast-path)
        object.__setattr__(self, "_tmpl_cache", {})

    def __getattr__(self, name: str):
        if name.startswith("_") and name != "__rtpu_call__":
            raise AttributeError(name)
        return ActorMethod(self._actor_id, name,
                           self._method_options.get(name), self._tmpl_cache)

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_options))

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id


class ActorClass:
    def __init__(self, cls, options: Dict[str, Any]):
        self._cls = cls
        self._options = dict(options or {})
        self._cls_blob = ts.pickle_fn(cls)
        self._cls_hash = ts.fn_digest(self._cls_blob)
        self.__name__ = getattr(cls, "__name__", "Actor")
        # collect @ray_tpu_torch.method options declared on the class
        self._method_options = {
            n: getattr(m, "_rtpu_method_options")
            for n, m in vars(cls).items()
            if callable(m) and hasattr(m, "_rtpu_method_options")
        }

    def __call__(self, *a, **kw):
        raise TypeError(
            f"actor class {self.__name__} cannot be instantiated directly; "
            f"use {self.__name__}.remote()"
        )

    def options(self, **new_options):
        ac = ActorClass.__new__(ActorClass)
        ac._cls = self._cls
        ac._options = {**self._options, **new_options}
        ac._cls_blob = self._cls_blob
        ac._cls_hash = self._cls_hash
        ac.__name__ = self.__name__
        ac._method_options = self._method_options
        return ac

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch.core.runtime import _get_runtime

        rt = _get_runtime()
        rt.ensure_fn(self._cls_hash, self._cls_blob)
        enc_args, enc_kwargs, nested_refs = ts.encode_args(args, kwargs, rt)
        pg, bundle_index = _pg_options(self._options)
        renv = self._options.get("runtime_env")
        if renv:
            # no-ops without py_modules; raises loudly on pip/conda/etc
            from ray_tpu_torch.runtime_env import package_runtime_env

            renv = package_runtime_env(renv, rt)
            self._options = {**self._options, "runtime_env": renv}
        spec = ts.make_actor_create_spec(
            self._cls_hash,
            enc_args,
            enc_kwargs,
            resources=_normalize_resources(self._options, default_cpu=0.0),
            actor_name=self._options.get("name", ""),
            max_restarts=int(self._options.get("max_restarts", 0)),
            max_concurrency=int(self._options.get(
                "max_concurrency", self._default_concurrency())),
            placement_group_id=pg,
            bundle_index=bundle_index,
            runtime_env=self._options.get("runtime_env"),
        )
        if nested_refs:
            spec["borrowed"] = nested_refs
        from ray_tpu_torch.core.remote_function import _strategy_spec

        strat = _strategy_spec(self._options)
        if strat is not None:
            spec["strategy"] = strat
        rt.create_actor(spec)
        return ActorHandle(ActorID(spec["actor_id"]), self._method_options)

    def _default_concurrency(self) -> int:
        """Async actors (any ``async def`` method) default to many
        concurrent calls — they interleave on one event loop, so the limit
        is a queue-depth guard, not a thread count (reference default 1000
        for async actors)."""
        import inspect

        has_async = any(
            inspect.iscoroutinefunction(getattr(self._cls, n, None))
            or inspect.isasyncgenfunction(getattr(self._cls, n, None))
            for n in dir(self._cls) if not n.startswith("_"))
        return 100 if has_async else 1

    def __reduce__(self):
        return (_rebuild_actor_class, (self._cls_blob, self._options))


def _rebuild_actor_class(cls_blob: bytes, options: Dict[str, Any]) -> ActorClass:
    import cloudpickle

    ac = ActorClass.__new__(ActorClass)
    ac._cls = cloudpickle.loads(cls_blob)
    ac._options = options
    ac._cls_blob = cls_blob
    ac._cls_hash = ts.fn_digest(cls_blob)
    ac.__name__ = getattr(ac._cls, "__name__", "Actor")
    ac._method_options = {
        n: getattr(m, "_rtpu_method_options")
        for n, m in vars(ac._cls).items()
        if callable(m) and hasattr(m, "_rtpu_method_options")
    }
    return ac
