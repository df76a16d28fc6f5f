"""RemoteFunction — the object created by ``@ray_tpu_torch.remote`` on a function.

Role analog: reference ``python/ray/remote_function.py`` (``RemoteFunction.
_remote :266`` → submit). The function body is cloudpickled once and cached
in the GCS function table keyed by digest; specs carry only the digest.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.core import task_spec as ts


def _normalize_resources(opts: Dict[str, Any], default_cpu: float = 1.0) -> Dict[str, float]:
    res: Dict[str, float] = {}
    num_cpus = opts.get("num_cpus")
    res["CPU"] = float(default_cpu if num_cpus is None else num_cpus)
    if opts.get("num_gpus"):
        res["GPU"] = float(opts["num_gpus"])
    for k, v in (opts.get("resources") or {}).items():
        res[k] = float(v)
    res = {k: v for k, v in res.items() if v}
    return res


def _pg_options(opts: Dict[str, Any]):
    pg = opts.get("placement_group")
    strategy = opts.get("scheduling_strategy")
    bundle_index = opts.get("placement_group_bundle_index", -1)
    if strategy is not None and hasattr(strategy, "placement_group"):
        pg = strategy.placement_group
        bundle_index = getattr(strategy, "placement_group_bundle_index", -1)
        if bundle_index is None:
            bundle_index = -1
    if pg is not None and not isinstance(pg, (bytes, bytearray)):
        pg = pg.id.binary()
    return pg, bundle_index


def _strategy_spec(opts: Dict[str, Any]):
    """Encode a scheduling strategy into the task spec (cluster placement
    honors it; single-node ignores it). Reference strategies:
    "SPREAD"/"DEFAULT" strings and NodeAffinitySchedulingStrategy."""
    strategy = opts.get("scheduling_strategy")
    if strategy is None or hasattr(strategy, "placement_group"):
        return None
    if isinstance(strategy, str):
        up = strategy.upper()
        if up == "SPREAD":
            return ("spread",)
        if up == "RANDOM":
            # reference random_scheduling_policy.h: uniform over feasible
            # nodes (useful for load smoke-spreading without the hybrid
            # policy's utilization scoring)
            return ("random",)
        return None
    if hasattr(strategy, "node_id"):
        node_id = strategy.node_id
        if isinstance(node_id, str):
            node_id = bytes.fromhex(node_id)
        return ("node_affinity", node_id, bool(getattr(strategy, "soft",
                                                       False)))
    if hasattr(strategy, "hard") and hasattr(strategy, "soft"):
        def enc(preds):
            return tuple((str(k), getattr(op, "op", "in"),
                          tuple(getattr(op, "values", ())))
                         for k, op in preds.items())

        return ("node_labels", enc(strategy.hard), enc(strategy.soft))
    return None


class RemoteFunction:
    def __init__(self, fn, options: Dict[str, Any]):
        self._function = fn
        self._options = dict(options or {})
        self._fn_blob = ts.pickle_fn(fn)
        self._fn_hash = ts.fn_digest(self._fn_blob)
        # submit fast-path (r13): the spec template + function-table
        # registration are cached per (function, option-set) — this
        # instance IS that key (``options()`` returns a fresh instance,
        # so a changed option set can never reuse a stale template)
        self._tmpl = None
        self._tmpl_rt = None
        self.__name__ = getattr(fn, "__name__", "remote_fn")
        self.__doc__ = getattr(fn, "__doc__", None)

    def __call__(self, *a, **kw):
        raise TypeError(
            f"remote function {self.__name__} cannot be called directly; "
            f"use {self.__name__}.remote()"
        )

    def bind(self, *args, **kwargs):
        """Build a lazy DAG node for this function (reference ``fn.bind``)."""
        from ray_tpu_torch.dag.dag_node import FunctionNode

        return FunctionNode(self, args, kwargs)

    def options(self, **new_options):
        merged = {**self._options, **new_options}
        rf = RemoteFunction.__new__(RemoteFunction)
        rf._function = self._function
        rf._options = merged
        rf._fn_blob = self._fn_blob
        rf._fn_hash = self._fn_hash
        rf._tmpl = None       # fresh option set -> fresh template
        rf._tmpl_rt = None
        rf.__name__ = self.__name__
        rf.__doc__ = self.__doc__
        return rf

    def _template(self, rt) -> Dict[str, Any]:
        """The cached invariant spec parts for this (function, option-set)
        against ``rt`` — resources/pg/strategy/retry normalization and
        runtime_env packaging run ONCE, not per submission. Keyed on the
        runtime identity so an init/shutdown cycle (or a worker-side
        clone) rebuilds and re-registers."""
        if self._tmpl is not None and self._tmpl_rt is rt:
            return self._tmpl
        rt.ensure_fn(self._fn_hash, self._fn_blob)
        pg, bundle_index = _pg_options(self._options)
        renv = self._options.get("runtime_env")
        if renv:
            # no-ops without py_modules; raises loudly on pip/conda/etc
            from ray_tpu_torch.runtime_env import package_runtime_env

            renv = package_runtime_env(renv, rt)
            self._options = {**self._options, "runtime_env": renv}
        num_returns = self._options.get("num_returns", 1)
        streaming = num_returns in ("streaming", "dynamic")
        # retry_exceptions shares the max_retries budget (reference
        # semantics) — opting in without an explicit max_retries gets the
        # reference default of 3 instead of the fail-fast 0, so
        # @remote(retry_exceptions=True) is never silently inert
        max_retries = self._options.get("max_retries")
        if max_retries is None:
            max_retries = 3 if self._options.get("retry_exceptions") else 0
        bp = self._options.get("_generator_backpressure_num_objects")
        self._tmpl = ts.make_task_template(
            self._fn_hash,
            num_returns=1 if streaming else int(num_returns),
            resources=_normalize_resources(self._options),
            name=self._options.get("name", self.__name__),
            max_retries=int(max_retries),
            placement_group_id=pg,
            bundle_index=bundle_index,
            runtime_env=self._options.get("runtime_env"),
            # True = retry any application error; a list/tuple of exception
            # types retries only those (reference retry_exceptions forms)
            retry_exceptions=self._options.get("retry_exceptions", False),
            streaming=streaming,
            # producer pauses when this many yields are unconsumed
            # (reference generator_waiter.cc)
            stream_backpressure=int(bp) if streaming and bp else 0,
            strategy=_strategy_spec(self._options),
        )
        self._tmpl_rt = rt
        return self._tmpl

    def remote(self, *args, **kwargs):
        from ray_tpu_torch.core.runtime import _get_runtime

        rt = _get_runtime()
        tmpl = self._template(rt)
        enc_args, enc_kwargs, nested_refs = ts.encode_args(args, kwargs, rt)
        spec = ts.spec_from_template(tmpl, enc_args, enc_kwargs)
        if nested_refs:
            spec["borrowed"] = nested_refs
        if spec.get("streaming"):
            # the declared return becomes the end sentinel; yields surface
            # as they are produced (reference ObjectRefGenerator,
            # _raylet.pyx:273)
            from ray_tpu_torch.core.object_ref import ObjectRefGenerator

            refs = rt.submit(spec)
            return ObjectRefGenerator(
                spec["task_id"], refs[0],
                backpressured=bool(spec.get("stream_backpressure")),
                owner=getattr(rt, "cluster_node_id", None))
        refs = rt.submit(spec)
        if self._options.get("num_returns", 1) == 1:
            return refs[0]
        return refs

    def __reduce__(self):
        return (_rebuild_remote_function, (self._fn_blob, self._options))


def _rebuild_remote_function(fn_blob: bytes, options: Dict[str, Any]) -> RemoteFunction:
    import cloudpickle

    rf = RemoteFunction.__new__(RemoteFunction)
    rf._function = cloudpickle.loads(fn_blob)
    rf._options = options
    rf._fn_blob = fn_blob
    rf._fn_hash = ts.fn_digest(fn_blob)
    rf._tmpl = None
    rf._tmpl_rt = None
    rf.__name__ = getattr(rf._function, "__name__", "remote_fn")
    rf.__doc__ = getattr(rf._function, "__doc__", None)
    return rf
