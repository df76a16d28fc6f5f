"""Built-in core-runtime metric definitions — ONE central registry.

Role analog: ``src/ray/stats/metric_defs.cc`` (the reference's ~90
built-in gauges/counters/histograms for scheduler, object store, GCS,
pull/push managers, worker pools). Every metric the runtime itself
records is DEFINED here and instantiated via :func:`get`; core modules
never call ``Counter(...)``/``Gauge(...)``/``Histogram(...)`` directly
(``tests/test_invariants.py`` greps for violations). That single-source
rule is what keeps the invariants testable: every built-in has help
text, the ``rtpu_`` prefix, and exactly one definition — and the README
"Built-in metrics reference" table is GENERATED from this module
(``python -m ray_tpu_torch.util.metric_defs --markdown``), so it cannot
drift.

Conventions (Prometheus):
- counters end in ``_total`` (or ``_bytes_total``);
- histograms/gauges carry a unit suffix (``_seconds``, ``_bytes``);
- every name starts with ``rtpu_`` so one scrape config covers the
  whole runtime.

Which process records what: scheduler/pipe/refcount metrics live in the
driver (and each node daemon — a daemon IS a DriverRuntime); store
metrics in whichever process touches the store (driver, workers,
daemons); GCS metrics in the GCS server process; RPC metrics in every
process that speaks cluster RPC. Federation (util/metrics.py) merges
them all onto the head ``/metrics`` with origin labels.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple


class MetricDef(NamedTuple):
    name: str
    kind: str                       # "counter" | "gauge" | "histogram"
    help: str
    tag_keys: Tuple[str, ...]
    boundaries: Optional[Tuple[float, ...]]
    component: str                  # subsystem, for docs/grouping


_DEFS: "OrderedDict[str, MetricDef]" = OrderedDict()


def _def(name: str, kind: str, help: str, *,
         tag_keys: Sequence[str] = (),
         boundaries: Optional[Sequence[float]] = None,
         component: str = "") -> None:
    assert name.startswith("rtpu_"), f"built-in metric {name} lacks rtpu_"
    assert help.strip(), f"built-in metric {name} has no help text"
    assert name not in _DEFS, f"duplicate metric definition {name}"
    assert kind in ("counter", "gauge", "histogram"), kind
    if kind == "counter":
        assert name.endswith("_total"), f"counter {name} must end _total"
    _DEFS[name] = MetricDef(name, kind, help, tuple(tag_keys),
                            tuple(boundaries) if boundaries else None,
                            component)


# latency boundary presets (seconds)
_LAT_FAST = (1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5,
             1.0, 5.0)                      # locks, RPC handlers, store ops
_LAT_TASK = (1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60)
_LAT_SPAWN = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10, 30)

# ---------------------------------------------------------------------------
# scheduler / driver runtime (core/runtime.py)
# ---------------------------------------------------------------------------

_def("rtpu_scheduler_tasks_submitted_total", "counter",
     "task specs submitted to this node's scheduler",
     tag_keys=("type",), component="scheduler")
_def("rtpu_scheduler_tasks_dispatched_total", "counter",
     "tasks leased to a worker (lease grants)", component="scheduler")
_def("rtpu_tasks_finished_total", "counter",
     "tasks finished on this node's scheduler",
     tag_keys=("status",), component="scheduler")
_def("rtpu_task_phase_seconds", "histogram",
     "task lifecycle phase latency (submit->queue->lease->arg_fetch->"
     "deserialize->execute->store_result)",
     tag_keys=("phase",), boundaries=_LAT_TASK, component="scheduler")
_def("rtpu_scheduler_ready_queue_depth", "gauge",
     "tasks ready to run but not yet leased to a worker (sampled)",
     component="scheduler")
_def("rtpu_scheduler_inflight_tasks", "gauge",
     "tasks currently executing on this node's workers (sampled)",
     component="scheduler")
_def("rtpu_scheduler_actor_pending_calls", "gauge",
     "actor method calls queued behind busy actors (sampled)",
     component="scheduler")
_def("rtpu_refcount_entries", "gauge",
     "objects with a nonzero local pin count in the driver's reference "
     "table (sampled)", component="scheduler")
_def("rtpu_refcount_arg_pin_entries", "gauge",
     "submitted-task argument pin sets held until first return is "
     "terminal (sampled)", component="scheduler")
_def("rtpu_lineage_entries", "gauge",
     "task specs retained for object reconstruction (sampled)",
     component="scheduler")
_def("rtpu_lineage_bytes", "gauge",
     "approximate bytes retained by the lineage table (sampled)",
     component="scheduler")

# worker control pipe (driver side of every worker connection)
_def("rtpu_pipe_sent_bytes_total", "counter",
     "bytes the driver sent over worker control pipes (framed message "
     "payloads)", component="scheduler")
_def("rtpu_pipe_recv_bytes_total", "counter",
     "bytes the driver received over worker control pipes",
     component="scheduler")
_def("rtpu_pipe_messages_total", "counter",
     "control-pipe messages by direction (sent/recv, driver side)",
     tag_keys=("direction",), component="scheduler")
_def("rtpu_pipe_batch_messages", "histogram",
     "control messages per coalesced pipe frame (worker-side Nagle "
     "window RTPU_PIPE_COALESCE_US + piggybacked urgent sends; observed "
     "at driver receive)",
     boundaries=(2, 3, 5, 8, 13, 21, 34, 55, 89), component="scheduler")

# native pipe engine (driver side; see native/pipe.cc + _native.NativePipe)
_def("rtpu_pipe_native_send_seconds", "histogram",
     "driver-side enqueue latency per control message handed to the "
     "GIL-free pipe engine (framing + write happen on its sender thread)",
     boundaries=_LAT_FAST, component="scheduler")
_def("rtpu_pipe_native_drain_messages", "histogram",
     "records per native-engine drain wake on a driver reader thread "
     "(one GIL acquisition services this many worker messages)",
     boundaries=(1, 2, 3, 5, 8, 13, 21, 34, 55, 89),
     component="scheduler")
_def("rtpu_pipe_native_frames", "gauge",
     "frames the native pipe engines wrote/read across live worker "
     "connections, by direction (monotonic, sampled)",
     tag_keys=("direction",), component="scheduler")
_def("rtpu_pipe_native_messages", "gauge",
     "messages packed into / split out of native pipe frames, by "
     "direction (monotonic, sampled; messages/frames = the coalescing "
     "factor)", tag_keys=("direction",), component="scheduler")
_def("rtpu_pipe_native_refpin_transitions", "gauge",
     "net 0<->1 borrow transitions the native refcount tables surfaced "
     "to Python (deltas beyond these never touched the interpreter; "
     "monotonic, sampled)", component="scheduler")

# compiled execution plane (dag/compiled_dag.py + experimental/channel.py)
_def("rtpu_dag_executions_total", "counter",
     "compiled-DAG invocations admitted (execute/execute_async)",
     component="dag")
_def("rtpu_dag_inflight", "gauge",
     "compiled-DAG invocations admitted but not yet resolved to their "
     "future (delta-updated; aggregates across every DAG in the "
     "process)", component="dag")
_def("rtpu_channel_read_wait_seconds", "histogram",
     "time a compiled-DAG channel read waited past its spin budget for "
     "the next ring slot (recorded only when a wait backed off)",
     boundaries=_LAT_FAST, component="dag")
_def("rtpu_channel_write_wait_seconds", "histogram",
     "time a compiled-DAG channel write waited for ring backpressure "
     "(slowest reader cursor) to clear",
     boundaries=_LAT_FAST, component="dag")

# worker pool / zygote (spawn path)
_def("rtpu_worker_pool_size", "gauge",
     "worker processes attached to this node's pool by state (sampled)",
     tag_keys=("state",), component="worker_pool")
_def("rtpu_worker_spawns_total", "counter",
     "worker processes spawned, by mode (zygote fork vs interpreter "
     "exec)", tag_keys=("mode",), component="worker_pool")
_def("rtpu_worker_spawn_seconds", "histogram",
     "worker launch latency: spawn decision to the worker's ready "
     "message", tag_keys=("mode",), boundaries=_LAT_SPAWN,
     component="worker_pool")
_def("rtpu_worker_deaths_total", "counter",
     "worker processes that died (crash, kill, or shutdown race)",
     component="worker_pool")
_def("rtpu_zygote_restarts_total", "counter",
     "fork-server (zygote) restarts after death", component="worker_pool")

# worker-process built-ins (recorded inside each worker, federated up)
_def("rtpu_worker_tasks_total", "counter",
     "tasks executed by this worker process", component="worker")
_def("rtpu_worker_task_exec_seconds", "histogram",
     "user-code execution time in this worker",
     boundaries=(0.001, 0.01, 0.1, 1, 10, 60, 600), component="worker")

# ---------------------------------------------------------------------------
# object store (core/object_store.py)
# ---------------------------------------------------------------------------

_def("rtpu_object_store_put_seconds", "histogram",
     "store write latency (serialize excluded; segment/arena/inline "
     "write + seal)", boundaries=_LAT_FAST, component="object_store")
_def("rtpu_object_store_get_seconds", "histogram",
     "store read latency (map + deserialize)", boundaries=_LAT_FAST,
     component="object_store")
_def("rtpu_object_store_puts_total", "counter",
     "store writes by landing path (inline/arena/file/spill)",
     tag_keys=("path",), component="object_store")
_def("rtpu_object_store_put_bytes_total", "counter",
     "serialized bytes written to the store (all paths)",
     component="object_store")
_def("rtpu_object_store_bytes_used", "gauge",
     "bytes this process accounts in shm (arena used + its file "
     "segments; sampled)", component="object_store")
_def("rtpu_object_store_capacity_bytes", "gauge",
     "configured arena capacity (sampled)", component="object_store")
_def("rtpu_object_store_pins", "gauge",
     "segments pinned by live deserialized views in this process "
     "(sampled)", component="object_store")
_def("rtpu_object_store_prefault_bytes", "gauge",
     "arena bytes pre-faulted by the background populate thread",
     component="object_store")
_def("rtpu_object_store_spilled_bytes_total", "counter",
     "bytes written to the disk spill directory", component="object_store")
_def("rtpu_object_store_spilled_objects_total", "counter",
     "objects written to the disk spill directory",
     component="object_store")
_def("rtpu_object_store_restored_bytes_total", "counter",
     "spilled bytes promoted back into shared memory",
     component="object_store")
_def("rtpu_object_store_restored_objects_total", "counter",
     "spilled objects promoted back into shared memory",
     component="object_store")
_def("rtpu_object_store_spill_read_bytes_total", "counter",
     "bytes served directly from spill files (reads + remote pulls that "
     "did not restore first)", component="object_store")
_def("rtpu_object_store_spill_compressed_bytes_total", "counter",
     "physical (compressed) bytes written to spill files — compare with "
     "rtpu_object_store_spilled_bytes_total (logical) for the overall "
     "spill compression factor", component="object_store")
_def("rtpu_object_store_spill_compression_ratio", "histogram",
     "logical/physical size ratio per compressed spill write (1.0 = "
     "stored raw: incompressible or codec off)",
     boundaries=(1.0, 1.1, 1.25, 1.5, 2, 3, 5, 10, 25),
     component="object_store")
_def("rtpu_object_store_parallel_copy_bytes_total", "counter",
     "payload bytes moved by the native multi-threaded memcpy path "
     "(large put/get slices past RTPU_STORE_PARALLEL_COPY_BYTES)",
     component="object_store")
_def("rtpu_object_store_parallel_copy_seconds", "histogram",
     "wall time of native multi-threaded copies (bytes/seconds = "
     "achieved aggregate memcpy bandwidth)",
     boundaries=_LAT_FAST, component="object_store")
_def("rtpu_object_store_spill_dir_bytes", "gauge",
     "bytes currently spilled to disk on this node (sampled)",
     component="object_store")

# ---------------------------------------------------------------------------
# GCS server (cluster/gcs_server.py — recorded in the GCS process,
# exported to the head /metrics via rpc_metrics_get with component=gcs)
# ---------------------------------------------------------------------------

_def("rtpu_gcs_rpc_total", "counter",
     "GCS RPCs handled, by method", tag_keys=("method",), component="gcs")
_def("rtpu_gcs_rpc_seconds", "histogram",
     "GCS RPC handler latency, by method", tag_keys=("method",),
     boundaries=_LAT_FAST, component="gcs")
_def("rtpu_gcs_pubsub_messages_total", "counter",
     "pubsub deliveries pushed to subscribers (fanout: one per "
     "subscriber per publish)", tag_keys=("channel",), component="gcs")
_def("rtpu_gcs_table_size", "gauge",
     "GCS table entry counts (objects/nodes/actors/kv/functions/pgs/"
     "task_events/trace_events/profile_events/free_candidates/"
     "tombstones; sampled)",
     tag_keys=("table",), component="gcs")
_def("rtpu_gcs_nodes_alive", "gauge",
     "cluster nodes currently alive (sampled)", component="gcs")
_def("rtpu_gcs_heartbeat_gap_seconds", "histogram",
     "observed gap between consecutive heartbeats of a node (nominal "
     "0.5s; tail growth = control-plane or sender contention)",
     boundaries=(0.25, 0.5, 0.75, 1, 1.5, 2, 3, 5, 8, 15, 30),
     component="gcs")

# ---------------------------------------------------------------------------
# cluster RPC transport (cluster/rpc.py)
# ---------------------------------------------------------------------------

_def("rtpu_rpc_sent_bytes_total", "counter",
     "framed bytes sent over cluster RPC connections (client calls/casts "
     "+ server replies/pushes)", component="rpc")
_def("rtpu_rpc_recv_bytes_total", "counter",
     "framed bytes received over cluster RPC connections", component="rpc")
_def("rtpu_rpc_server_requests_total", "counter",
     "requests accepted by RPC servers in this process, by kind "
     "(req/cast)", tag_keys=("kind",), component="rpc")
_def("rtpu_rpc_server_queue_wait_seconds", "histogram",
     "time a request waited between socket read and handler start (the "
     "server thread-pool queue — the GCS accept-loop contention signal)",
     boundaries=_LAT_FAST, component="rpc")
_def("rtpu_rpc_client_reconnects_total", "counter",
     "successful RPC client reconnects after a connection drop",
     component="rpc")
_def("rtpu_rpc_client_reconnect_attempts_total", "counter",
     "RPC client reconnect attempts (including failed retries)",
     component="rpc")
_def("rtpu_rpc_client_timeouts_total", "counter",
     "RPC calls that hit their caller-side timeout", component="rpc")

# ---------------------------------------------------------------------------
# cluster adapter / node daemon (cluster/adapter.py, node_daemon.py)
# ---------------------------------------------------------------------------

_def("rtpu_cluster_tasks_forwarded_total", "counter",
     "task/actor specs forwarded to a peer node, by spillback reason "
     "(resources/locality/strategy/pg/actor_route)",
     tag_keys=("reason",), component="cluster")
_def("rtpu_cluster_object_pull_bytes_total", "counter",
     "object bytes pulled from peer nodes", component="cluster")
_def("rtpu_cluster_object_serve_bytes_total", "counter",
     "object bytes served to peer nodes", component="cluster")
_def("rtpu_cluster_heartbeats_total", "counter",
     "heartbeats this node sent to the GCS", component="cluster")
_def("rtpu_cluster_heartbeat_rtt_seconds", "histogram",
     "round-trip of the node_heartbeat RPC as seen by the sender",
     boundaries=_LAT_FAST, component="cluster")
_def("rtpu_daemon_uptime_seconds", "gauge",
     "node daemon uptime (sampled)", component="cluster")

# ---------------------------------------------------------------------------
# failpoints (util/failpoints.py)
# ---------------------------------------------------------------------------

_def("rtpu_failpoints_fired_total", "counter",
     "chaos failpoints that fired in this process (test/chaos plane; "
     "always 0 in production unless RTPU_FAILPOINTS arms a site)",
     tag_keys=("site",), component="failpoints")

# ---------------------------------------------------------------------------
# trace plane (util/tracing.py -> util/trace_store.py)
# ---------------------------------------------------------------------------

_def("rtpu_trace_spans_total", "counter",
     "spans recorded into this process's trace ring (0 unless "
     "RTPU_TRACING armed)", component="tracing")
_def("rtpu_trace_spans_dropped_total", "counter",
     "spans evicted from the bounded trace ring before collection "
     "(raise RTPU_TRACE_RING or shorten the push interval)",
     component="tracing")
_def("rtpu_trace_push_batches_total", "counter",
     "span batches shipped toward the head (worker control-pipe pushes "
     "+ node heartbeat rides)", component="tracing")

# ---------------------------------------------------------------------------
# profiling plane (util/profiling.py)
# ---------------------------------------------------------------------------

_def("rtpu_profile_samples_total", "counter",
     "stack samples aggregated into this process's profile table "
     "(busy + idle; 0 unless RTPU_PROFILING armed)",
     component="profiling")
_def("rtpu_profile_samples_dropped_total", "counter",
     "samples dropped because the bounded profile table was full of "
     "unique stacks (raise RTPU_PROFILE_TABLE_MAX or shorten the push "
     "interval)", component="profiling")
_def("rtpu_profile_push_batches_total", "counter",
     "profile batches shipped toward the head (worker control-pipe "
     "pushes + node heartbeat rides)", component="profiling")

# ---------------------------------------------------------------------------
# event plane (util/events.py -> util/event_store.py)
# ---------------------------------------------------------------------------

_def("rtpu_lifecycle_events_total", "counter",
     "lifecycle events recorded into this process's event ring "
     "(worker/actor/node deaths, spills, serve re-routes, alerts; "
     "0 when RTPU_EVENTS=0)", component="events")
_def("rtpu_lifecycle_events_dropped_total", "counter",
     "events evicted from the bounded event ring before collection "
     "(raise RTPU_EVENT_RING or shorten the push interval)",
     component="events")
_def("rtpu_event_push_batches_total", "counter",
     "lifecycle-event batches shipped toward the head (worker "
     "control-pipe pushes + node heartbeat rides)", component="events")

# ---------------------------------------------------------------------------
# alerting watchdog (util/alerts.py)
# ---------------------------------------------------------------------------

_def("rtpu_alerts_active", "gauge",
     "alert rules currently raised by the head watchdog, by severity "
     "(0 everywhere = healthy; RTPU_ALERTS=0 disables evaluation)",
     tag_keys=("severity",), component="alerts")

# ---------------------------------------------------------------------------
# log federation (util/events.py log fetch rendezvous)
# ---------------------------------------------------------------------------

_def("rtpu_log_fetches_total", "counter",
     "cluster-wide log fetches served by this process (`rtpu logs` / "
     "/api/logs rendezvous replies, including /proc fd fallbacks)",
     component="logs")
_def("rtpu_log_fetch_bytes_total", "counter",
     "log bytes shipped in fetch replies (bounded per fetch by "
     "RTPU_LOG_TAIL_BYTES)", component="logs")

# ---------------------------------------------------------------------------
# lock contention profiler (util/contention.py)
# ---------------------------------------------------------------------------

_def("rtpu_lock_wait_seconds", "histogram",
     "time spent waiting to acquire an instrumented runtime lock "
     "(contended acquisitions only; uncontended fast path records "
     "nothing here)", tag_keys=("lock",), boundaries=_LAT_FAST,
     component="contention")
_def("rtpu_lock_acquisitions", "gauge",
     "total acquisitions of an instrumented lock (monotonic, sampled "
     "from unlocked accumulators)", tag_keys=("lock",),
     component="contention")
_def("rtpu_lock_contended", "gauge",
     "acquisitions that had to wait (monotonic, sampled)",
     tag_keys=("lock",), component="contention")
_def("rtpu_lock_wait_seconds_sum", "gauge",
     "cumulative seconds spent waiting on an instrumented lock "
     "(monotonic, sampled)", tag_keys=("lock",), component="contention")

# ---------------------------------------------------------------------------
# data streaming exchange (data/streaming.py)
# ---------------------------------------------------------------------------

_def("rtpu_data_exchange_blocks_in_flight", "gauge",
     "partition-output blocks not yet consumed by a reducer",
     component="data")
_def("rtpu_data_exchange_reducer_queue_depth", "gauge",
     "forwarded-but-unacked blocks per reducer actor",
     tag_keys=("reducer",), component="data")
_def("rtpu_data_exchange_bytes_total", "counter",
     "block bytes that crossed the exchange", tag_keys=("kind",),
     component="data")
_def("rtpu_data_exchange_blocks_total", "counter",
     "blocks that crossed the exchange", tag_keys=("kind",),
     component="data")

# ---------------------------------------------------------------------------
# train / TPU telemetry (train/telemetry.py)
# ---------------------------------------------------------------------------

_def("rtpu_train_step_seconds", "histogram",
     "wall time per optimizer step",
     boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60, 600),
     component="train")
_def("rtpu_train_steps_total", "counter", "optimizer steps recorded",
     component="train")
_def("rtpu_train_tokens_per_s", "gauge", "training throughput",
     component="train")
_def("rtpu_train_mfu", "gauge",
     "measured model FLOPs utilization (0..1)", component="train")
_def("rtpu_train_loss", "gauge", "last reported loss", component="train")
_def("rtpu_train_compile_total", "counter", "XLA (re)compilation events",
     component="train")
_def("rtpu_train_compile_seconds", "histogram",
     "wall time of compile events (first call of a fresh program; "
     "includes its first execution)",
     boundaries=(0.1, 1, 5, 10, 30, 60, 300, 1200), component="train")
_def("rtpu_tpu_hbm_used_bytes", "gauge",
     "HBM bytes in use (local devices)", component="train")
_def("rtpu_tpu_hbm_limit_bytes", "gauge",
     "HBM capacity (local devices)", component="train")

# ---------------------------------------------------------------------------
# device plane (util/device_plane.py — the compiled-program registry)
# ---------------------------------------------------------------------------

_def("rtpu_jit_compiles_total", "counter",
     "XLA compiles of registered programs (a fresh abstract signature "
     "or a fresh jit instance); the jit_compile_storm alert watches "
     "retraces, not this warmup-inclusive count", tag_keys=("program",),
     component="device")
_def("rtpu_jit_retraces_total", "counter",
     "recompiles past a program's FIRST signature (each also emits one "
     "jit_recompile lifecycle event carrying the signature diff)",
     tag_keys=("program",), component="device")
_def("rtpu_jit_compile_seconds", "histogram",
     "wall time of registered-program compile calls (dispatch + first "
     "execution, the record_compile convention)",
     tag_keys=("program",),
     boundaries=(0.01, 0.1, 1, 5, 10, 30, 60, 300, 1200),
     component="device")
_def("rtpu_device_programs", "gauge",
     "registered compiled programs in this process's registry "
     "(sampled per device-plane snapshot)", component="device")
_def("rtpu_device_live_buffers", "gauge",
     "live device arrays in this process (jax.live_arrays census, "
     "sampled per snapshot)", component="device")
_def("rtpu_device_live_buffer_bytes", "gauge",
     "bytes held by live device arrays in this process (census "
     "sample)", component="device")
_def("rtpu_device_achieved_flops_per_s", "gauge",
     "achieved FLOP/s attributed from registry cost-analysis flops "
     "and caller-measured step time (cost-model flops count every "
     "executed flop, remat recompute included)",
     tag_keys=("program",), component="device")


# ---------------------------------------------------------------------------
# LLM serving tier (serve/llm.py — recorded in each replica's process,
# federated to the head /metrics like every worker-side metric)
# ---------------------------------------------------------------------------

_def("rtpu_serve_kv_blocks_free", "gauge",
     "paged-KV blocks on this replica's free list (sampled per engine "
     "step). Drained-replica invariant: free + prefix-cache blocks == "
     "total — the prefix trie legitimately retains finished prompts, "
     "so free alone does NOT return to total on a warm idle replica",
     component="serve")
_def("rtpu_serve_kv_blocks_used", "gauge",
     "paged-KV blocks held by live requests and the prefix cache "
     "(sampled per engine step)", component="serve")
_def("rtpu_serve_prefix_cache_hits_total", "counter",
     "prompt lookups that reused at least one cached prefix block",
     component="serve")
_def("rtpu_serve_prefix_cache_misses_total", "counter",
     "prompt lookups that found no cached prefix", component="serve")
_def("rtpu_serve_prefix_hit_tokens_total", "counter",
     "prompt tokens served from the prefix cache instead of prefill "
     "compute (the tokens/s win of prefix reuse)", component="serve")
_def("rtpu_serve_admission_sheds_total", "counter",
     "requests shed by the SLO admission controller, by gate "
     "(ttft/tpot/queue/deadline)", tag_keys=("reason",),
     component="serve")
_def("rtpu_serve_ttft_seconds", "histogram",
     "time from request submission to its first generated token "
     "(admission queue + prefill — the latency the TTFT SLO declares)",
     boundaries=_LAT_TASK, component="serve")
_def("rtpu_serve_tpot_seconds", "histogram",
     "time between consecutive generated tokens of one stream (decode "
     "cadence — the latency the TPOT SLO declares)",
     boundaries=_LAT_FAST, component="serve")

# disaggregated prefill/decode (ISSUE 13): per-pool occupancy + the
# KV-block transfer plane between the pools
_def("rtpu_serve_pool_inflight", "gauge",
     "requests occupying engine slots, by pool role "
     "(prefill/decode/colocated; sampled per engine step)",
     tag_keys=("role",), component="serve")
_def("rtpu_serve_pool_queued", "gauge",
     "admitted requests waiting for an engine slot, by pool role "
     "(sampled per engine step)", tag_keys=("role",), component="serve")
_def("rtpu_serve_pool_kv_used_fraction", "gauge",
     "fraction of this replica's paged-KV blocks in use, by pool role "
     "(sampled per engine step)", tag_keys=("role",), component="serve")
_def("rtpu_serve_kv_transfer_bytes_total", "counter",
     "KV-block payload bytes shipped prefill -> decode, by path "
     "(channel = same-host DeviceChannel ring slot; store = cross-node "
     "object-store chunked pull)", tag_keys=("path",), component="serve")
_def("rtpu_serve_kv_transfers_total", "counter",
     "KV-block batches shipped prefill -> decode, by path",
     tag_keys=("path",), component="serve")
_def("rtpu_serve_kv_transfer_seconds", "histogram",
     "wall time of one KV-block batch transfer (prefill-side ship for "
     "send, decode-side fetch for recv), by path",
     tag_keys=("path",), boundaries=_LAT_FAST, component="serve")

# multi-model serving plane (ISSUE 16): arena-paged model multiplexing
# + speculative decoding
_def("rtpu_serve_model_swaps_total", "counter",
     "model weight-set page events on this replica's ModelRegistry, by "
     "direction (in = materialized from the arena store; out = LRU-"
     "evicted under the resident-byte budget) — the lazy-paging proof "
     "the multiplexing A/B asserts on", tag_keys=("direction",),
     component="serve")
_def("rtpu_serve_model_resident", "gauge",
     "registered models on this replica by residency tier (hbm = "
     "materialized params; host = cold weights in the arena store; "
     "spilled = aged to the store's on-disk tier; sampled per registry "
     "snapshot)", tag_keys=("state",), component="serve")
_def("rtpu_serve_model_resident_bytes", "gauge",
     "bytes of materialized model params counted against this "
     "replica's serve_model_budget_bytes (delta variants charge only "
     "their unique leaves)", component="serve")
_def("rtpu_spec_rounds_total", "counter",
     "speculative-decoding verify rounds that carried at least one "
     "draft token (one batched verify_step_paged call per round)",
     component="serve")
_def("rtpu_spec_proposed_tokens_total", "counter",
     "draft tokens proposed to the target verifier", component="serve")
_def("rtpu_spec_accepted_tokens_total", "counter",
     "draft tokens accepted (equal to the target's own greedy chain); "
     "each round also emits one free target token, so tokens/round = "
     "accepted/rounds + 1", component="serve")
_def("rtpu_spec_fallbacks_total", "counter",
     "requests whose draft-acceptance EWMA collapsed below "
     "spec_accept_floor and fell back to plain decode permanently",
     component="serve")


# ---------------------------------------------------------------------------
# instantiation
# ---------------------------------------------------------------------------

_instances_lock = threading.Lock()
_instances: Dict[str, object] = {}


def get(name: str):
    """The live metric instance for a built-in definition.

    Instances are cached per process; if the registry was cleared since
    (tests), a fresh instance is created and re-registered — the merge
    semantics in util/metrics make concurrent creators share storage.
    Hot paths should cache the returned object (and pre-sorted tag keys)
    themselves; this lookup is for wiring, not per-event use.
    """
    from ray_tpu_torch.util import metrics

    d = _DEFS[name]
    inst = _instances.get(name)
    if inst is not None and metrics.registered(name) is inst:
        return inst
    with _instances_lock:
        inst = _instances.get(name)
        if inst is not None and metrics.registered(name) is inst:
            return inst
        if d.kind == "counter":
            inst = metrics.Counter(name, d.help, tag_keys=d.tag_keys)
        elif d.kind == "gauge":
            inst = metrics.Gauge(name, d.help, tag_keys=d.tag_keys)
        else:
            inst = metrics.Histogram(name, d.help,
                                     boundaries=list(d.boundaries or ()),
                                     tag_keys=d.tag_keys)
        _instances[name] = inst
        return inst


def all_defs() -> List[MetricDef]:
    return list(_DEFS.values())


def lookup(name: str) -> Optional[MetricDef]:
    return _DEFS.get(name)


# ---------------------------------------------------------------------------
# docs generation (README "Built-in metrics reference")
# ---------------------------------------------------------------------------

MD_BEGIN = "<!-- metric-defs:begin (generated; do not edit by hand) -->"
MD_END = "<!-- metric-defs:end -->"


def markdown_table() -> str:
    """The generated metrics reference, fenced by markers so a test can
    assert the README copy matches this registry exactly."""
    lines = [MD_BEGIN,
             f"{len(_DEFS)} built-in metrics "
             "(generated by `python -m ray_tpu_torch.util.metric_defs "
             "--markdown`):", "",
             "| Metric | Type | Labels | Help |",
             "|---|---|---|---|"]
    for d in _DEFS.values():
        labels = ", ".join(d.tag_keys) if d.tag_keys else "—"
        lines.append(f"| `{d.name}` | {d.kind} | {labels} | "
                     f"{d.help} |")
    lines.append(MD_END)
    return "\n".join(lines)


def _main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="built-in metric registry tools")
    p.add_argument("--markdown", action="store_true",
                   help="print the generated metrics reference table")
    p.add_argument("--check", metavar="README",
                   help="verify README's fenced table matches the "
                        "registry (exit 1 on drift)")
    p.add_argument("--update", metavar="README",
                   help="rewrite README's fenced table in place")
    args = p.parse_args(argv)
    table = markdown_table()
    if args.markdown:
        print(table)
        return 0
    if args.check or args.update:
        path = args.check or args.update
        with open(path) as f:
            text = f.read()
        start, end = text.find(MD_BEGIN), text.find(MD_END)
        if start == -1 or end == -1:
            print(f"{path}: no generated-table markers found")
            return 1
        current = text[start:end + len(MD_END)]
        if args.check:
            if current != table:
                print(f"{path}: metrics reference table is stale — run "
                      f"python -m ray_tpu_torch.util.metric_defs --update "
                      f"{path}")
                return 1
            print(f"{path}: metrics reference table is up to date")
            return 0
        with open(path, "w") as f:
            f.write(text[:start] + table + text[end + len(MD_END):])
        print(f"{path}: metrics reference table rewritten "
              f"({len(_DEFS)} metrics)")
        return 0
    p.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(_main())
