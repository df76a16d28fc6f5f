"""The checked-in wire-protocol catalog (ISSUE 15).

Every message vocabulary the runtime speaks across a process boundary,
in one place. This module is pure data — stdlib-only, importable from
anywhere (including the jax-free graftlint engine, which *parses* it
rather than importing it so a lint run never triggers the ray_tpu_torch
package import).

graftlint's ``protocol`` rule family extracts the actual vocabulary from
the senders and dispatch arms in the tree and fails on any drift from
this catalog — a send without a handler, a handler without a sender, or
an op missing here. The catalog is therefore the review surface for
wire-protocol changes: a new cast/RPC/topic lands as a diff hunk in THIS
file alongside its sender and handler, the same way a new failpoint
lands in util/failpoints.py's Sites block.

Framing note: the vocabularies below ride the framed pickle pipe
(``native/pipe.cc``: raw-pickle | ``RTB1`` batch | ``RTP1`` packed
refpin frames) between driver and workers, and the length-prefixed
RPC plane (``cluster/rpc.py``) for GCS and peer traffic. The binary
frame magics are part of the native plane's contract, tested by
``native/pipe_stress.cc`` and tests/test_native_pipe.py.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# worker <-> driver pipe (core/worker.py <-> core/runtime.py)
# ---------------------------------------------------------------------------

#: top-level frame kinds a worker ships to the driver
#: (``Runtime._reader_loop`` / ``_native_reader_loop`` / ``_handle_msg``
#: dispatch; ``hello`` is consumed by ``_accept_loop`` before the reader
#: starts; ``batch`` wraps a coalesced list of the others)
PIPE_WORKER_MSGS = frozenset({
    "hello", "ready", "done", "cast", "req", "batch",
})

#: top-level message kinds the driver ships to a worker
#: (``Worker._dispatch_recv`` arms)
PIPE_DRIVER_MSGS = frozenset({
    "exec", "cancel", "reply", "fp", "trace", "prof", "events",
    "stackdump", "shutdown",
})

#: fire-and-forget worker->driver casts: ``("cast", op, args)``
#: (``Worker.cast`` senders -> ``Runtime._handle_cast`` arms)
PIPE_CASTS = frozenset({
    "put", "submit", "actor_call", "fn_put", "blocked", "unblocked",
    "kill_actor", "cancel", "stream_consumed", "refpins", "metrics",
    "spans", "prof", "stacks", "free", "events", "device",
})

#: request/reply worker->driver ops: ``("req", req_id, op, args)``
#: (``Worker.request`` senders -> ``Runtime._handle_req`` arms)
PIPE_REQS = frozenset({
    "get", "wait", "stream_permit", "reconstruct", "fn_get",
    "actor_create", "name_lookup", "kv", "actor_depths", "resources",
    "nodes", "pg_create", "pg_remove",
})

# ---------------------------------------------------------------------------
# GCS RPC (cluster/gcs_server.py ``rpc_*`` methods)
# ---------------------------------------------------------------------------

GCS_RPC = frozenset({
    # node lifecycle
    "node_register", "node_heartbeat", "node_list", "node_drain",
    # object directory
    "obj_ready", "obj_error", "obj_pin", "obj_unpin", "obj_info",
    "obj_state", "obj_list", "obj_drop", "obj_forget_location",
    # observability planes
    "task_events", "task_events_get", "trace_events", "trace_events_get",
    "profile_events", "profile_events_get", "stack_request",
    "stack_reply", "stack_collect", "metrics_get",
    "lifecycle_events", "lifecycle_events_get", "log_request",
    "log_reply", "log_collect", "device_report", "device_report_get",
    # kv + function store
    "kv_put", "kv_get", "kv_del", "kv_keys", "fn_put", "fn_get",
    # actors
    "actor_register", "actor_update", "actor_get", "actor_lookup",
    "actor_list",
    # placement groups
    "pg_register", "pg_get", "pg_update_assignment", "pg_remove",
    "pg_list",
    # pubsub + chaos + liveness
    "subscribe", "publish", "ping", "fp_arm", "fp_disarm",
})

#: dynamic dispatch prefixes: ``gcs.call("kv_" + op, ...)`` in
#: cluster/adapter.py reaches every ``kv_*`` method without a literal
#: sender per method — catalog entries matching a prefix here are exempt
#: from the literal-sender completeness check
GCS_RPC_DYNAMIC_PREFIXES = ("kv_",)

# ---------------------------------------------------------------------------
# peer (node-daemon <-> node-daemon) RPC (cluster/adapter.py
# ``_serve_peer`` arms)
# ---------------------------------------------------------------------------

PEER_RPC = frozenset({
    "submit_spec", "submit_actor_spec", "pull_object", "pull_chunk",
    "bcast_fetch", "stream_consumed", "kill_actor", "cancel_task",
    "pg_prepare", "pg_commit", "pg_abort", "pg_release", "ping",
})

# ---------------------------------------------------------------------------
# pubsub topics (published via ``GcsServer._publish`` / the ``publish``
# RPC; subscribed in cluster/adapter.py)
# ---------------------------------------------------------------------------

PUBSUB_CHANNELS = frozenset({
    "nodes", "objects", "pgs", "failpoints", "tracing", "profiling",
    "events",
})
