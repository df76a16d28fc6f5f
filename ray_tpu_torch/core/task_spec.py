"""Task/actor specs and argument encoding.

Role analog: reference ``src/ray/common/task/task_spec.h`` +
``python/ray/remote_function.py`` arg handling. Specs are plain dicts so
they pickle fast over control-channel pipes.

Argument encodings:
  ("v", blob)            — inline serialized value
  ("r", id_bytes)        — ObjectRef; resolved via the store at exec time
  ("ri", id_bytes, blob) — ObjectRef whose value was inline in the directory;
                           the scheduler attaches the blob at dispatch
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.ids import ObjectID, TaskID, ActorID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.object_store import INLINE_THRESHOLD

TASK = "task"
ACTOR_CREATE = "actor_create"
ACTOR_METHOD = "actor_method"


def fn_digest(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()[:24]


def streaming_return_id(task_id: bytes, index: int) -> bytes:
    """Deterministic ObjectID for the ``index``-th yield of a streaming
    task — producer and consumers derive it independently (reference:
    ``ObjectID::ForDynamicReturn`` role, ``_raylet.pyx:273``)."""
    return hashlib.sha256(task_id + b":stream:" +
                          index.to_bytes(8, "little")).digest()[:16]


def pickle_fn(fn) -> bytes:
    return cloudpickle.dumps(fn)


def encode_args(args, kwargs, runtime) -> Tuple[list, dict, list]:
    """Encode call args. Oversized inline values are promoted to store
    objects (mirrors the reference: large args are implicitly ``ray.put``).
    Each value is serialized exactly once. The third element lists refs
    NESTED inside inline values (e.g. ``f.remote([ref])``) — the submitter
    pins those until the task completes, closing the window between the
    caller dropping its ObjectRef and the worker deserializing its borrow
    (reference: borrowed references in serialized arguments)."""
    from ray_tpu_torch.core.object_ref import collect_serialized_refs

    nested: List[bytes] = []

    def enc(a: Any):
        if isinstance(a, ObjectRef):
            return ("r", a.id.binary())
        with collect_serialized_refs() as got:
            data, buffers = serialization.serialize(a)
        nested.extend(got)
        size = serialization.serialized_size(data, buffers)
        if size >= INLINE_THRESHOLD:
            ref = runtime.put_parts(data, buffers)
            return ("r", ref.id.binary())
        out = bytearray(size)
        serialization.write_into(memoryview(out), data, buffers)
        return ("v", bytes(out))

    return ([enc(a) for a in args],
            {k: enc(v) for k, v in (kwargs or {}).items()},
            nested)


def arg_refs(enc_args: list, enc_kwargs: dict) -> List[ObjectID]:
    out = []
    for e in list(enc_args) + list(enc_kwargs.values()):
        if e[0] == "r":
            out.append(ObjectID(e[1]))
    return out


def make_task_spec(
    fn_hash: str,
    enc_args: list,
    enc_kwargs: dict,
    num_returns: int,
    resources: Dict[str, float],
    name: str = "",
    max_retries: int = 0,
    placement_group_id: Optional[bytes] = None,
    bundle_index: int = -1,
    scheduling_strategy: Any = None,
    runtime_env: Optional[dict] = None,
    retry_exceptions: Any = False,
) -> dict:
    task_id = TaskID.from_random()
    if isinstance(retry_exceptions, (list, tuple)):
        # list form (retry only these exception types): cloudpickle the
        # tuple so the spec stays plain-pickle-safe on every transport
        # (control pipe, cluster RPC) even for __main__-defined types;
        # an empty list means "never retry" and must stay falsy
        retry_exceptions = (cloudpickle.dumps(tuple(retry_exceptions))
                            if retry_exceptions else False)
    return {
        "type": TASK,
        "retry_exceptions": retry_exceptions,
        "runtime_env": runtime_env,
        "task_id": task_id.binary(),
        "fn_hash": fn_hash,
        "name": name,
        "args": enc_args,
        "kwargs": enc_kwargs,
        "return_ids": [ObjectID.from_random().binary() for _ in range(num_returns)],
        "resources": resources,
        "max_retries": max_retries,
        "pg": placement_group_id,
        "bundle_index": bundle_index,
        "retries_left": max_retries,
    }


def make_actor_create_spec(
    cls_hash: str,
    enc_args: list,
    enc_kwargs: dict,
    resources: Dict[str, float],
    actor_name: str = "",
    max_restarts: int = 0,
    max_concurrency: int = 1,
    placement_group_id: Optional[bytes] = None,
    bundle_index: int = -1,
    runtime_env: Optional[dict] = None,
) -> dict:
    actor_id = ActorID.from_random()
    return {
        "type": ACTOR_CREATE,
        "runtime_env": runtime_env,
        "task_id": TaskID.from_random().binary(),
        "actor_id": actor_id.binary(),
        "fn_hash": cls_hash,
        "name": actor_name,
        "args": enc_args,
        "kwargs": enc_kwargs,
        "return_ids": [ObjectID.from_random().binary()],
        "resources": resources,
        "max_restarts": max_restarts,
        "max_concurrency": max_concurrency,
        "pg": placement_group_id,
        "bundle_index": bundle_index,
    }


def make_task_template(
    fn_hash: str,
    num_returns: int,
    resources: Dict[str, float],
    name: str = "",
    max_retries: int = 0,
    placement_group_id: Optional[bytes] = None,
    bundle_index: int = -1,
    runtime_env: Optional[dict] = None,
    retry_exceptions: Any = False,
    streaming: bool = False,
    stream_backpressure: int = 0,
    strategy: Any = None,
) -> dict:
    """Submit fast-path (r13): the per-(function, option-set) INVARIANT
    part of a task spec, computed once and shallow-copied per call —
    repeated submissions pay only arg encoding + fresh ids. The
    ``retry_exceptions`` list form is cloudpickled here, once, instead of
    per submission."""
    if isinstance(retry_exceptions, (list, tuple)):
        retry_exceptions = (cloudpickle.dumps(tuple(retry_exceptions))
                            if retry_exceptions else False)
    tmpl = {
        "type": TASK,
        "retry_exceptions": retry_exceptions,
        "runtime_env": runtime_env,
        "fn_hash": fn_hash,
        "name": name,
        "resources": resources,
        "max_retries": max_retries,
        "pg": placement_group_id,
        "bundle_index": bundle_index,
        "_num_returns": 1 if streaming else int(num_returns),
    }
    if streaming:
        tmpl["streaming"] = True
        if stream_backpressure:
            tmpl["stream_backpressure"] = int(stream_backpressure)
    if strategy is not None:
        tmpl["strategy"] = strategy
    return tmpl


def spec_from_template(tmpl: dict, enc_args: list, enc_kwargs: dict) -> dict:
    """Instantiate one submission from a cached template: fresh ids +
    this call's encoded args on a shallow copy."""
    spec = dict(tmpl)
    n = spec.pop("_num_returns")
    spec["task_id"] = TaskID.from_random().binary()
    spec["args"] = enc_args
    spec["kwargs"] = enc_kwargs
    spec["return_ids"] = [ObjectID.from_random().binary()
                          for _ in range(n)]
    spec["retries_left"] = spec.get("max_retries", 0)
    return spec


def make_actor_method_template(
    actor_id: bytes,
    method_name: str,
    num_returns: int = 1,
    streaming: bool = False,
    stream_backpressure: int = 0,
) -> dict:
    """Actor-call twin of :func:`make_task_template`."""
    tmpl = {
        "type": ACTOR_METHOD,
        "actor_id": actor_id,
        "method": method_name,
        "resources": {},
        "_num_returns": 1 if streaming else int(num_returns),
    }
    if streaming:
        tmpl["streaming"] = True
        if stream_backpressure:
            tmpl["stream_backpressure"] = int(stream_backpressure)
    return tmpl


def make_actor_method_spec(
    actor_id: bytes,
    method_name: str,
    enc_args: list,
    enc_kwargs: dict,
    num_returns: int = 1,
) -> dict:
    return {
        "type": ACTOR_METHOD,
        "task_id": TaskID.from_random().binary(),
        "actor_id": actor_id,
        "method": method_name,
        "args": enc_args,
        "kwargs": enc_kwargs,
        "return_ids": [ObjectID.from_random().binary() for _ in range(num_returns)],
        "resources": {},
    }
