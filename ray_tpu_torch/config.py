"""Central configuration registry — every runtime knob the port reads, in
one table, under the same ``RTPU_<NAME>`` environment variables as the JAX
package's ``config.py`` (the same names, types and defaults).

Role analog: reference ``src/ray/common/ray_config_def.h`` (217
``RAY_CONFIG(type, name, default)`` entries, each overridable via a
``RAY_<name>`` env var, parsed in ``ray_config.h``). Here every knob is
registered with its type, default, and doc; the value is resolved from the
``RTPU_<NAME>`` environment variable LAZILY on each access, so tests that
``monkeypatch.setenv`` before booting a subsystem keep working and
subprocess workers inherit overrides through the environment — the same
property the reference gets from parsing env vars at RayConfig init in
every process.

Usage::

    from ray_tpu_torch import config
    cap = config.get("store_capacity")          # int, env-overridable
    rows  = config.describe()                    # table for docs
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, NamedTuple


class Knob(NamedTuple):
    name: str           # registry key; env var is RTPU_<NAME.upper()>
    type: Callable      # parser applied to the env string
    default: Any
    doc: str
    where: str          # module that consumes it


def _bool(s: str) -> bool:
    return s.strip().lower() not in ("0", "false", "no", "off", "")


_REGISTRY: Dict[str, Knob] = {}


def _knob(name: str, type_: Callable, default: Any, doc: str,
          where: str) -> None:
    assert name not in _REGISTRY, f"duplicate knob {name}"
    _REGISTRY[name] = Knob(name, type_, default, doc, where)


# -- core runtime -----------------------------------------------------------
_knob("worker_start_timeout", float, 120.0,
      "seconds to wait for a spawned worker to dial back before declaring "
      "it failed", "train/backend_executor.py")
_knob("log_to_driver", _bool, True,
      "stream worker stdout/stderr lines to the driver's console",
      "core/runtime.py")
_knob("memory_monitor", _bool, True,
      "enable the host-RAM OOM monitor (kills retriable tasks first; "
      "reference MemoryMonitor + worker-killing policies)",
      "core/runtime.py")
_knob("memory_usage_threshold", float, 0.95,
      "host memory fraction above which the OOM policy starts killing",
      "core/runtime.py")
_knob("lineage_max", int, 100_000,
      "max task specs retained for object reconstruction (reference "
      "lineage cap role)", "core/runtime.py")
_knob("lineage_max_bytes", int, 512 << 20,
      "byte bound on retained lineage (inlined args dominate; reference "
      "RAY_max_lineage_bytes)", "core/runtime.py")

_knob("worker_zygote", _bool, True,
      "spawn workers by forking a pre-warmed single-threaded fork-server "
      "(~5ms) instead of exec'ing a fresh interpreter (~0.15s); the "
      "fork-server never imports jax or user code", "core/runtime.py")
_knob("pipe_coalesce_us", int, 200,
      "Nagle-style flush window (microseconds) for worker->driver cast "
      "coalescing: fire-and-forget casts (submit, refpin, put, metric "
      "pushes) buffer up to this long and ship as ONE framed batch, and "
      "every latency-sensitive send (done/req) piggybacks the pending "
      "casts in its own frame; 0 disables buffering (casts still "
      "piggyback)", "core/worker.py")
_knob("dag_max_in_flight", int, 8,
      "default overlapping invocations a compiled DAG admits "
      "(ring-channel slots = max_in_flight + 1)", "dag/compiled_dag.py")
_knob("native_pipe", _bool, True,
      "drive each worker control pipe through the GIL-free C++ engine "
      "(framing, batch pack/unpack, send coalescing and refpin "
      "bookkeeping run in native threads; falls back to the Python "
      "reader/sender when the .so is missing or stale)",
      "core/runtime.py")
_knob("pipe_native_coalesce_us", int, 0,
      "optional Nagle window for the NATIVE driver->worker sender; 0 "
      "(default) relies on natural coalescing — everything enqueued "
      "while the previous write was in flight ships as one batch frame",
      "core/runtime.py")

# -- object store -----------------------------------------------------------
_knob("native_store", _bool, True,
      "use the C++ shm arena (falls back to file-per-object segments)",
      "core/object_store.py")
_knob("store_capacity", int, 1 << 30,
      "shm arena capacity in bytes per node", "core/object_store.py")
_knob("spill_threshold", int, 4 << 30,
      "total shm bytes after which big objects spill to disk",
      "core/object_store.py")
_knob("spill_restore", _bool, True,
      "promote spilled objects back into shm on access when headroom "
      "allows (reference LocalObjectManager restore role)",
      "core/object_store.py")
_knob("store_prefault_bytes", str, str(512 << 20),
      "arena head bytes prefaulted in the background at boot (first-touch "
      "page faults cap cold tmpfs writes at ~2 GB/s on this class of box "
      "vs ~7.5 GB/s warm); '0' disables, 'all' populates the whole arena",
      "_native/__init__.py")
_knob("store_parallel_copy_bytes", int, 4 << 20,
      "payload size at or above which store writes/reads use the native "
      "multi-threaded memcpy (N slicing threads, GIL released); 0 "
      "disables the parallel path", "core/serialization.py")
_knob("store_copy_threads", int, 0,
      "threads for the parallel memcpy path (0 = auto: hardware "
      "concurrency, capped at 8)", "core/serialization.py")
_knob("spill_compression", str, "auto",
      "codec for the disk spill path: auto (native lz4, zlib when the "
      ".so is unavailable) | lz4 | zlib | off. Files carry a "
      "self-describing header; readers handle every codec plus legacy "
      "raw files", "core/spill_codec.py")
_knob("spill_compress_max_bytes", int, 512 << 20,
      "objects larger than this spill RAW (mmap-servable): a compressed "
      "spill read with no shm headroom must inflate to heap, so the cap "
      "bounds that worst case; 0 = compress everything",
      "core/spill_codec.py")

# -- data (streaming exchange) ----------------------------------------------
_knob("data_exchange_reducers", int, 4,
      "max reducer actors per streaming exchange (logical partitions are "
      "multiplexed over them)", "data/streaming.py")
_knob("data_exchange_inflight", int, 32,
      "max exchange blocks in flight (partition outputs not yet consumed "
      "by a reducer) — the engine's backpressure bound",
      "data/streaming.py")
_knob("data_exchange_run_bytes", int, 32 << 20,
      "reducer buffer bytes before a sorted run is flushed to the object "
      "store (external-sort run size)", "data/streaming.py")
_knob("data_exchange_target_rows", int, 250_000,
      "rows per output block emitted by a streaming reducer",
      "data/streaming.py")
_knob("data_exchange_retries", int, 2,
      "times a Dataset plan re-executes from lineage (sources are never "
      "freed) when a streaming-exchange reducer actor dies before any "
      "output was consumed; 0 = surface ActorDiedError", "data/dataset.py")

# -- ops / models -----------------------------------------------------------
_knob("attn_impl", str, "",
      "attention on CPU tensors: blockwise | naive (empty = auto); CUDA "
      "tensors always run the kernel",
      "ops/attention.py")

# -- observability ----------------------------------------------------------
_knob("metrics_federation", _bool, True,
      "federate per-process metric registries to the head /metrics "
      "endpoint (workers push deltas over the control pipe; nodes ride "
      "the GCS heartbeat)", "util/metrics.py")
_knob("metrics_push_interval_s", float, 2.0,
      "min seconds between a worker's batched metric-delta pushes over "
      "the control pipe (<= 0 disables the push)", "core/worker.py")
_knob("contention_profiler", _bool, True,
      "instrument the runtime's hot locks (driver dispatch/ref locks, "
      "GCS state lock) with wait-time accounting: rtpu_lock_wait_seconds "
      "histograms + state.summarize_contention(); off = raw locks, zero "
      "overhead", "util/contention.py")
_knob("flight_recorder", _bool, True,
      "record per-task lifecycle phases (worker-side timing, driver "
      "histograms/ring, nested timeline slices); off = zero per-task "
      "telemetry cost", "core/runtime.py")
_knob("task_ring", int, 2048,
      "recent task lifecycle records kept in the driver's flight-recorder "
      "ring (feeds state.summarize_tasks per-phase percentiles)",
      "core/runtime.py")
_knob("trace_ring", int, 8192,
      "per-process span ring capacity (trace plane recording side); "
      "overflow before collection drops the oldest span and counts "
      "rtpu_trace_spans_dropped_total", "util/tracing.py")
_knob("trace_push_interval_s", float, 1.0,
      "min seconds between a worker's batched span pushes over the "
      "control pipe (the trace twin of metrics_push_interval_s)",
      "core/worker.py")
_knob("trace_store_max", int, 65536,
      "spans retained by a runtime's TraceStore (head query surface; "
      "daemons buffer here between heartbeats)", "util/trace_store.py")
_knob("profile_hz", float, 67.0,
      "sampling-profiler frequency per process when armed "
      "(RTPU_PROFILING); the sampler walks sys._current_frames at this "
      "rate", "util/profiling.py")
_knob("profile_table_max", int, 4096,
      "max unique (thread, stack) keys aggregated per process between "
      "collection drains; overflow drops new stacks and counts "
      "rtpu_profile_samples_dropped_total", "util/profiling.py")
_knob("profile_push_interval_s", float, 1.0,
      "min seconds between a worker's batched profile pushes over the "
      "control pipe (the profile twin of trace_push_interval_s)",
      "core/worker.py")
_knob("profile_store_max", int, 2048,
      "profile batches retained by a runtime's ProfileStore (head query "
      "surface; daemons buffer here between heartbeats)",
      "util/profiling.py")
_knob("event_ring", int, 2048,
      "per-process lifecycle-event ring capacity (event plane recording "
      "side); overflow before collection drops the oldest event and "
      "counts rtpu_lifecycle_events_dropped_total", "util/events.py")
_knob("event_push_interval_s", float, 1.0,
      "min seconds between a worker's batched lifecycle-event pushes "
      "over the control pipe (the event twin of trace_push_interval_s)",
      "core/worker.py")
_knob("event_store_max", int, 16384,
      "lifecycle events retained by a runtime's EventStore (head query "
      "surface; daemons buffer here between heartbeats)",
      "util/event_store.py")
_knob("device_push_interval_s", float, 2.0,
      "min seconds between a worker's compiled-program-registry "
      "snapshot pushes over the control pipe (version-gated: nothing "
      "ships unless a compile bumped the registry)", "core/worker.py")
_knob("alerts_interval_s", float, 5.0,
      "watchdog evaluation period for the declarative alert rules at "
      "the head (RTPU_ALERTS=0 kills the watchdog outright)",
      "util/alerts.py")
_knob("log_tail_bytes", int, 16384,
      "max bytes of one log file shipped per cluster-wide log fetch "
      "(`rtpu logs` / /api/logs); postmortem stderr tails use a smaller "
      "fixed bound", "util/events.py")
_knob("obj_meta_max", int, 100_000,
      "object creation-metadata entries (owner/age/call-site) kept by "
      "the driver for `ray_tpu_torch memory` forensics", "core/runtime.py")

# -- device plane -----------------------------------------------------------
_knob("device_plane", str, "1",
      "0 turns off the device plane's accounting (the registry rows); "
      "programs are captured and replayed either way",
      "util/device_plane.py")

# -- serve ------------------------------------------------------------------
_knob("serve_max_body", int, 64 << 20,
      "max HTTP request body bytes accepted by the serve proxy",
      "serve/proxy.py")
_knob("serve_request_retries", int, 3,
      "times a DeploymentHandle re-routes one request after the replica "
      "it was sent to died (each retry reports the death so the "
      "controller replaces the replica); 0 = surface ActorDiedError",
      "serve/handle.py")
_knob("serve_routing", str, "p2c",
      "replica picker: p2c (power-of-two-choices over queue depth + "
      "advertised free KV blocks) | rr (round-robin; the bench A/B "
      "baseline)", "serve/handle.py")
_knob("serve_kv_route_weight", float, 4.0,
      "routing-score weight of KV occupancy: score = queue_depth + "
      "weight * kv_used_fraction for replicas that advertise KV state; "
      "0 ignores KV pressure", "serve/handle.py")
_knob("serve_load_report_interval_s", float, 0.5,
      "cadence of a replica's load-state push to the controller (KV "
      "blocks free/total, in-flight requests) when its deployment "
      "exposes load_state(); <= 0 disables the push loop",
      "serve/replica.py")
_knob("serve_model_budget_bytes", int, 0,
      "per-replica resident-weight budget for model multiplexing: the "
      "ModelRegistry LRU-evicts unpinned models past this many bytes of "
      "materialized params (in-flight requests pin their model); 0 = "
      "unbounded", "serve/multiplex.py")
_knob("serve_model_route_weight", float, 4.0,
      "routing-score penalty a DeploymentHandle adds to replicas that "
      "do NOT advertise the request's model_id as resident (a swap-in "
      "costs a weight page-in; 0 ignores residency)", "serve/handle.py")
_knob("serve_prefix_affinity", _bool, True,
      "route requests whose first prompt block matches a replica's "
      "published prefix digest to THAT replica (cluster-wide prefix "
      "affinity); off = plain p2c", "serve/handle.py")
_knob("serve_prefix_affinity_margin", float, 6.0,
      "max routing-score gap by which the prefix-affine replica may "
      "LOSE to the p2c winner and still be picked (beyond it the "
      "replica is overloaded and affinity yields to load)",
      "serve/handle.py")
_knob("serve_prefix_digest_top", int, 8,
      "top-N hottest prefix-trie roots (by reused tokens) a replica "
      "publishes in its load report for affinity routing",
      "serve/llm.py")
_knob("spec_k", int, 4,
      "draft tokens proposed per speculative-decoding round (the "
      "target verifies k+1 positions in one batched step)",
      "serve/multiplex.py")
_knob("spec_accept_floor", float, 0.2,
      "per-request acceptance-EWMA floor: a request whose draft "
      "acceptance collapses below this after the warmup rounds falls "
      "back to plain decode permanently (speculation only pays when "
      "drafts are accepted)", "serve/multiplex.py")
_knob("serve_disagg_cross_node_penalty", float, 2.0,
      "routing-score penalty for picking a decode replica on a "
      "DIFFERENT host than the chosen prefill replica (a same-host "
      "DeviceChannel KV transfer beats a cross-node store pull); 0 "
      "ignores host locality", "serve/disagg.py")
_knob("llm_stall_timeout_s", float, 120.0,
      "seconds a caller waits for the NEXT token from the LLM decode "
      "loop before declaring the stream stalled (per-request deadline_s "
      "caps it further)", "serve/llm.py")
_knob("llm_block_size", int, 16,
      "tokens per paged-KV block (prefix sharing granularity; smaller = "
      "finer reuse, more table entries)", "serve/llm.py")
_knob("llm_prefill_chunk", int, 8,
      "prompt tokens consumed per engine step during chunked prefill "
      "(1 = token-at-a-time like decode; larger drains long prompts in "
      "fewer steps without stalling in-flight decodes)", "serve/llm.py")

# -- worker pool prestart, attention tiles ---------------------------------
_knob("pool_prestart", int, 4,
      "warm pool workers kept prestarted (reference worker_pool prestart "
      "role): actor creation and task bursts claim these instead of "
      "cold-spawning", "core/runtime.py")
_knob("attn_block_q", int, 512,
      "query tile of the blockwise attention", "ops/attention.py")
_knob("attn_block_k", int, 512,
      "key/value tile of the blockwise attention", "ops/attention.py")

# Internal coordination values (not tuning knobs, listed for completeness;
# set by the runtime itself): RTPU_WORKER (set in worker processes),
# RTPU_NODE_ID, RTPU_NODE_LABELS.


def env_name(name: str) -> str:
    return "RTPU_" + name.upper()


def get(name: str) -> Any:
    """Resolve a knob: env override if set (parsed to the knob's type,
    falling back to the default on a parse error), else the default."""
    k = _REGISTRY[name]
    raw = os.environ.get(env_name(name))
    if raw is None:
        return k.default
    try:
        return k.type(raw)
    except (ValueError, TypeError):
        return k.default


def describe() -> List[dict]:
    """Table rows for the CLI/docs: name, env, type, default, current,
    overridden, doc."""
    rows = []
    for k in _REGISTRY.values():
        cur = get(k.name)
        rows.append({
            "name": k.name,
            "env": env_name(k.name),
            "type": getattr(k.type, "__name__", str(k.type)),
            "default": k.default,
            "current": cur,
            "overridden": cur != k.default,
            "where": k.where,
            "doc": k.doc,
        })
    return rows
