"""State API: list/summarize cluster entities.

Role analog: ``python/ray/util/state/api.py`` (``StateApiClient :110``,
``list_actors :788``, ``summarize_tasks :1382``) — backed here by the
driver's control plane (GCS analog) instead of a REST head.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


def _gcs():
    from ray_tpu_torch.core.runtime import _get_runtime

    rt = _get_runtime()
    if rt is None:
        raise RuntimeError("ray_tpu_torch is not initialized")
    return rt


def list_nodes() -> List[Dict[str, Any]]:
    import ray_tpu_torch

    return ray_tpu_torch.nodes()


def actor_queue_depths(actor_ids: List[bytes]) -> List[int]:
    """Pending-call depth per actor (same order as ``actor_ids``) — the
    public surface serve's load-aware routing reads; libraries must not
    reach into the runtime for this (layering seam)."""
    return _gcs().actor_queue_depths(actor_ids)


def list_actors(filters: Optional[List] = None) -> List[Dict[str, Any]]:
    rt = _gcs()
    out = []
    for info in rt.gcs.all_actors():
        rec = {
            "actor_id": info.actor_id.hex(),
            "state": info.state,
            "name": getattr(info, "name", "") or None,
            "restarts": getattr(info, "restarts", 0),
        }
        out.append(rec)
    return _apply_filters(out, filters)


def _all_task_events(rt) -> List[Dict[str, Any]]:
    """Cluster-wide task events when a GCS is attached (nodes flush their
    buffers there — reference TaskEventBuffer -> GcsTaskManager pipeline),
    else this driver's local buffer."""
    if rt.cluster is not None:
        try:
            evs = rt.cluster.gcs.call("task_events_get", 50000, timeout=10)
            if evs:
                return evs
        except Exception:
            pass
    return rt.timeline()


def list_tasks(filters: Optional[List] = None) -> List[Dict[str, Any]]:
    """Finished-task records — cluster-wide in cluster mode (every node
    ships its events to the GCS), driver-local otherwise."""
    rt = _gcs()
    out = []
    for ev in _all_task_events(rt):
        out.append({
            "name": ev.get("name"),
            "state": "FINISHED",
            "duration_ms": ev.get("dur", 0) / 1e3,
            "worker": ev.get("tid"),
            "node": ev.get("node"),
        })
    return _apply_filters(out, filters)


def list_objects(filters: Optional[List] = None) -> List[Dict[str, Any]]:
    rt = _gcs()
    out = []
    for oid, st in rt.gcs.all_objects():
        out.append({
            "object_id": oid.hex(),
            "status": st.status,
            "size": st.size,
            "in_plasma": st.inline is None,
        })
    return _apply_filters(out, filters)


def list_placement_groups() -> List[Dict[str, Any]]:
    rt = _gcs()
    with rt.lock:
        return [
            {"placement_group_id": pgid.hex(),
             "bundles": {i: dict(b) for i, b in pg["bundles"].items()},
             "strategy": pg["strategy"]}
            for pgid, pg in rt.pgs.items()
        ]


def list_workers() -> List[Dict[str, Any]]:
    rt = _gcs()
    with rt.lock:
        workers = list(rt.workers.values())
    out = []
    for ws in workers:
        out.append({
            "worker_id": ws.worker_id.hex(),
            "pid": ws.proc.pid if ws.proc else None,
            "kind": ws.kind,
            "status": ws.status,
        })
    return out


def list_task_events(limit: int = 1000) -> List[Dict[str, Any]]:
    """Recent task-lifecycle flight-recorder records (newest last): one
    dict per finished task with per-phase durations in seconds
    (queue/lease/arg_fetch/deserialize/execute/store_result/total)."""
    rt = _gcs()
    ring = list(getattr(rt, "task_ring", ()) or ())
    out = []
    for ev in ring[-int(limit):]:
        ev = dict(ev)
        # the hot path stores raw ids; render them here, per query
        ev["task_id"] = ev["task_id"].hex()[:16]
        ev["worker_id"] = ev["worker_id"].hex()[:8]
        out.append(ev)
    return out


def list_spans(limit: int = 10000,
               filters: Optional[List] = None) -> List[Dict[str, Any]]:
    """Collected trace spans — cluster-wide in cluster mode (every node
    ships its TraceStore deltas on the heartbeat; reference
    tracing-plane/GcsTaskManager role), head-local otherwise. Each span
    carries trace/span/parent ids, epoch-nano timestamps, attributes, and
    origin labels (node_id / worker_id / component). Empty unless tracing
    is armed (``enable_tracing()`` / ``RTPU_TRACING=1``)."""
    rt = _gcs()
    try:
        rt.collect_trace_spans()
    except Exception:
        pass
    if rt.cluster is not None:
        try:
            evs = rt.cluster.gcs.call("trace_events_get", int(limit),
                                      timeout=10)
            if evs:
                return _apply_filters(evs, filters)
        except Exception:
            pass
    return _apply_filters(rt.trace_store.snapshot(int(limit)), filters)


def list_events(limit: int = 1000,
                filters: Optional[List] = None) -> List[Dict[str, Any]]:
    """Collected lifecycle events — cluster-wide in cluster mode (every
    node ships its EventStore deltas on the heartbeat; the GCS appends
    its own node register/death events), head-local otherwise. Each
    event carries a ``name`` from the catalog in
    :mod:`ray_tpu_torch.util.events`, a timestamp, severity, structured
    fields, and origin labels; DEATH events carry a ``postmortem``
    (exit cause, stderr tail, error lines). On by default;
    ``RTPU_EVENTS=0`` empties the plane."""
    rt = _gcs()
    try:
        rt.collect_lifecycle_events()
    except Exception:
        pass
    if rt.cluster is not None:
        try:
            evs = rt.cluster.gcs.call("lifecycle_events_get", int(limit),
                                      timeout=10)
            if evs:
                return _apply_filters(evs, filters)
        except Exception:
            pass
    return _apply_filters(rt.event_store.snapshot(int(limit)), filters)


def subscribe_node_events(callback) -> bool:
    """Register ``callback(payload)`` for node lifecycle pubsub events
    (``{"event": "down"|"up", "node_id": ..., "cause": ...}``),
    delivered AFTER the cluster adapter's own failure handling has run
    for the node. Returns False off-cluster (single-node runtimes have
    no membership to watch). This is the public seam the train layer's
    elastic membership machinery (r20) subscribes through — callbacks
    run on the adapter's io pool, so keep them non-blocking."""
    rt = _gcs()
    if rt.cluster is None:
        return False
    rt.cluster.subscribe_node_events(callback)
    return True


def unsubscribe_node_events(callback) -> None:
    """Remove a :func:`subscribe_node_events` callback (idempotent)."""
    rt = _gcs()
    if rt.cluster is not None:
        rt.cluster.unsubscribe_node_events(callback)


def device_report() -> Dict[str, Any]:
    """Cluster-wide device plane: every process's compiled-program
    registry (compiles, retraces, signatures, cost/memory analysis),
    HBM watermarks, and live-buffer census, merged across nodes. Local
    entries come from this process's registry plus its workers' pushed
    snapshots (DeviceStore); remote nodes' entries ride heartbeats into
    the GCS as idempotent per-node payloads. On by default;
    ``RTPU_DEVICE_PLANE=0`` empties the plane."""
    from ray_tpu_torch.util import device_plane

    rt = _gcs()
    comp = "driver"
    if rt.cluster is not None and not rt.cluster.is_scheduler:
        comp = "raylet"
    entries = device_plane.node_processes(rt, component=comp)
    me = rt.node_id.hex()[:8]
    for ent in entries:
        ent.setdefault("node_id", me)
    if rt.cluster is not None:
        try:
            remote = rt.cluster.gcs.call("device_report_get", rt.node_id,
                                         timeout=10)
            entries.extend(remote or ())
        except Exception:
            pass
    return device_plane.merge_report(entries)


def _resolve_log_target(rt, target: Dict[str, Any]) -> Dict[str, Any]:
    """Map a task/actor id onto the worker that ran it so the log fetch
    can rendezvous on worker_id: death events carry both ids (the usual
    reason someone fetches a log is that the worker died), and the
    head's flight-recorder ring covers tasks that finished alive."""
    want_task = (target.get("task_id") or "").lower()
    want_actor = (target.get("actor_id") or "").lower()
    if not want_task and not want_actor:
        return target
    for ev in reversed(list_events(limit=10000)):
        if want_task and (ev.get("task_id") or "").startswith(
                want_task[:16]) and ev.get("worker_id"):
            return {"worker_id": ev["worker_id"]}
        if want_actor and (ev.get("actor_id") or "").startswith(
                want_actor) and ev.get("worker_id"):
            return {"worker_id": ev["worker_id"]}
    if want_task:
        for ev in reversed(list(getattr(rt, "task_ring", ()) or ())):
            tid = ev.get("task_id")
            if tid is not None and tid.hex().startswith(want_task[:16]):
                return {"worker_id": ev["worker_id"].hex()[:8]}
    return target


def fetch_logs(target: Dict[str, Any], timeout: float = 5.0,
               tail_bytes: Optional[int] = None) -> List[Dict[str, Any]]:
    """Cluster-wide log fetch (the ``rtpu logs`` backend): resolve
    ``target`` — ``{"task_id"}``, ``{"actor_id"}``, ``{"worker_id"}``,
    ``{"node_id"}`` (all hex prefixes; node fetches also need
    ``"node": True``) or ``{"node": True}`` — to log files wherever
    they live, and return bounded tails with extracted error lines.
    Task/actor ids resolve through death events (cross-node) or the
    flight recorder; in cluster mode the fetch rides a GCS ``events``-
    channel rendezvous and only nodes that resolved the target reply.
    Falls back to ``/proc/<pid>/fd`` reads for live processes whose log
    file was deleted under them."""
    import time as _time

    rt = _gcs()
    target = _resolve_log_target(rt, dict(target or {}))
    if target.get("node_id") and "worker_id" not in target:
        target.setdefault("node", True)
    rows = rt.fetch_local_logs(target, tail_bytes=tail_bytes)
    if rt.cluster is None or rows:
        return rows
    try:
        req = rt.cluster.gcs.call("log_request", target, tail_bytes,
                                  timeout=10)
    except Exception:
        return rows
    deadline = _time.monotonic() + timeout
    replies: Dict[str, Any] = {}
    while _time.monotonic() < deadline:
        try:
            replies = rt.cluster.gcs.call("log_collect", req,
                                          timeout=10) or {}
        except Exception:
            replies = {}
        if replies:
            # one more collect round: give slower nodes of a broadcast
            # fetch a beat to land before returning
            _time.sleep(0.3)
            try:
                replies = rt.cluster.gcs.call("log_collect", req,
                                              timeout=10) or replies
            except Exception:
                pass
            break
        _time.sleep(0.2)
    out: List[Dict[str, Any]] = []
    for _node, node_rows in sorted(replies.items()):
        out.extend(node_rows)
    return out


def list_alerts() -> List[Dict[str, Any]]:
    """Currently-raised watchdog alerts at this head (see
    :mod:`ray_tpu_torch.util.alerts`): rule name, severity, observed value vs
    threshold, and since-when. Empty when all rules are healthy or the
    plane is killed (``RTPU_ALERTS=0``)."""
    from ray_tpu_torch.util import alerts

    return alerts.active_alerts()


def _collect_profile_batches(rt) -> List[Dict[str, Any]]:
    """Every collected profile batch visible from this head: the local
    ProfileStore (this process's sampler + its workers' pushes) plus —
    in cluster mode — the GCS buffer (every node's heartbeat-shipped
    deltas; the local store is the superset of what this node shipped,
    so GCS batches from OUR node id are dropped to avoid double counts)."""
    try:
        rt.collect_profile_batches()
    except Exception:
        pass
    local = rt.profile_store.snapshot()
    if rt.cluster is None:
        return local
    me = rt.node_id.hex()[:8]
    out = list(local)
    try:
        evs = rt.cluster.gcs.call("profile_events_get", 4096, timeout=10)
        for b in evs or ():
            if b.get("node_id") != me:
                out.append(b)
    except Exception:
        pass
    return out


def _sample_window(rt, seconds: Optional[float]) -> Dict[str, Any]:
    """THE shared arm→sample→disarm→collect sequence behind profile(),
    profile_collapsed() and export_speedscope().

    With ``seconds``: arm cluster-wide if not already armed (disarming
    again after — the disarm tail-flushes worker tables over the pipe),
    idle-sleep the window, then poll collection until the merged
    PROCESS SET stops growing (two stable polls after a minimum settle)
    — breaking on the first busy sample would return just the head's
    own instantly-available batch while worker casts and daemon
    heartbeat rides are still in flight. All waits are idle-typed so
    the query never profiles itself."""
    import time as _time

    from ray_tpu_torch.util import profiling

    if seconds is None:
        return profiling.merge_batches(_collect_profile_batches(rt))
    since = _time.time()
    armed_here = not profiling.profiling_enabled()
    if armed_here:
        profiling.enable_profiling()
    profiling.idle_sleep(float(seconds))
    if armed_here:
        profiling.disable_profiling()
    deadline = _time.monotonic() + 8.0
    # minimum settle: one worker push interval + one heartbeat, so the
    # window's tail batches have a chance to land before stability can
    # possibly be declared
    min_wait = _time.monotonic() + 1.5
    prev_keys = None
    merged = profiling.merge_batches([])
    while _time.monotonic() < deadline:
        merged = profiling.merge_batches(
            _collect_profile_batches(rt), since=since)
        keys = frozenset(merged["processes"])
        if keys and keys == prev_keys and _time.monotonic() >= min_wait:
            break
        prev_keys = keys
        profiling.idle_sleep(0.4)
    return merged


def profile(seconds: Optional[float] = None,
            component: Optional[str] = None,
            top_n: int = 20) -> Dict[str, Any]:
    """Cluster-wide merged CPU profile (the profiling plane's query
    surface; ``GET /api/profile``).

    With ``seconds``: sample for that window — arming the profiler
    cluster-wide for the duration if it isn't already armed
    (``enable_profiling()`` semantics; disarmed again after) — then
    merge every process's batches whose window overlaps it. Without:
    merge everything collected since arming.

    Returns per-(node, pid, component) sample totals plus ``top_self``
    rankings (leaf-frame self-time — "which functions burn the CPU"),
    overall and per component. The ``driver`` component's ranking is the
    direct input to ROADMAP item 1 (the GIL-serialized control plane)."""
    from ray_tpu_torch.util import profiling

    rt = _gcs()
    merged = _sample_window(rt, seconds)
    components = sorted({p["component"]
                         for p in merged["processes"].values()})
    out: Dict[str, Any] = {
        "seconds": seconds,
        "total_samples": merged["total"],
        "idle_samples": merged["idle_total"],
        "dropped_samples": merged["dropped"],
        "processes": {
            k: {"component": p["component"], "node_id": p["node_id"],
                "pid": p["pid"], "samples": p["total"],
                "idle_samples": p["idle_total"],
                "threads": sorted(p["threads"])}
            for k, p in sorted(merged["processes"].items())},
        "top_self": profiling.top_self(merged, component=component,
                                       n=top_n),
        "top_self_by_component": {
            c: profiling.top_self(merged, component=c, n=top_n)
            for c in components},
    }
    return out


def profile_collapsed(seconds: Optional[float] = None,
                      include_idle: bool = False) -> str:
    """Collapsed-stack text (``proc;thread;frames... N``) for
    flamegraph.pl or a speedscope paste — the raw export twin of
    :func:`profile`."""
    from ray_tpu_torch.util import profiling

    merged = _sample_window(_gcs(), seconds)
    return profiling.collapsed_text(merged, include_idle=include_idle)


def export_speedscope(filename: Optional[str] = None,
                      seconds: Optional[float] = None) -> Dict[str, Any]:
    """Speedscope JSON document of the merged cluster profile (one
    sampled profile per thread, weights summing to its sample count).
    Write to ``filename`` and open it at https://speedscope.app."""
    from ray_tpu_torch.util import profiling

    merged = _sample_window(_gcs(), seconds)
    doc = profiling.speedscope_doc(merged)
    if filename:
        import json

        with open(filename, "w") as f:
            json.dump(doc, f)
    return doc


def stack(timeout: float = 3.0) -> Dict[str, Any]:
    """LIVE python stacks of every process in the cluster (the
    ``ray_tpu_torch stack`` / ``ray stack`` py-spy role): this head and its
    workers over the control pipes; in cluster mode every daemon (and
    ITS workers) via a GCS ``profiling``-channel stack request. Needs no
    arming. Returns ``{node: {proc: {thread: "root;...;leaf"}}}``."""
    import time as _time

    rt = _gcs()
    me = rt.node_id.hex()[:8]
    out: Dict[str, Any] = {}
    if rt.cluster is not None:
        try:
            req = rt.cluster.gcs.call("stack_request", timeout=10)
            deadline = _time.monotonic() + timeout
            want = max(1, len([n for n in rt.cluster.node_info()
                               if n.get("alive", n.get("Alive"))]))
            replies: Dict[str, Any] = {}
            while _time.monotonic() < deadline:
                replies = rt.cluster.gcs.call("stack_collect", req,
                                              timeout=10) or {}
                if len(replies) >= want:
                    break
                from ray_tpu_torch.util import profiling as _prof

                _prof.idle_sleep(0.2)
            out.update(replies)
        except Exception:
            pass
    if me not in out:
        # single-node mode, or the head's own pubsub reply lost the race
        out[me] = rt.dump_stacks(timeout=min(2.0, timeout))
    return out


def summarize_critical_path(trace_id: Optional[str] = None,
                            limit: int = 5000) -> Dict[str, Any]:
    """Attribute end-to-end wall time to per-process segments.

    With ``trace_id``: sweep that trace's spans (serve request chain,
    task graph) into segments that sum exactly to the end-to-end time.
    Without: aggregate the flight-recorder ring per task — driver submit
    CPU (from submit spans, when tracing is armed), queue, lease, worker
    phases, and transit — the printed form of the multi-client
    control-plane ceiling (r8 root cause)."""
    from ray_tpu_torch.util import trace_store as _ts

    rt = _gcs()
    spans = list_spans(limit=100_000)
    if trace_id is not None:
        sel = [s for s in spans if s.get("trace_id") == trace_id]
        return _ts.critical_path_for_trace(sel)
    ring = list(getattr(rt, "task_ring", ()) or ())[-int(limit):]
    return _ts.critical_path_for_tasks(ring, spans)


def export_perfetto(filename: Optional[str] = None) -> Dict[str, Any]:
    """Unified Perfetto/Chrome-trace document: collected spans (incl.
    lock-contention waits and train-step telemetry) merged with the
    flight recorder's task-phase slices, one process row per node and one
    thread track per worker. Write to ``filename`` and load it in
    ui.perfetto.dev / chrome://tracing. Supersedes the driver-only
    ``ray_tpu_torch.timeline()`` export."""
    from ray_tpu_torch.util import trace_store as _ts

    rt = _gcs()
    spans = list_spans(limit=200_000)
    events = _all_task_events(rt)
    doc = _ts.build_perfetto(spans, events)
    if filename:
        import json

        with open(filename, "w") as f:
            json.dump(doc, f)
    return doc


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list."""
    import math

    n = len(sorted_vals)
    if n == 0:
        return 0.0
    return sorted_vals[min(n - 1, max(0, int(math.ceil(q * n)) - 1))]


def summarize_tasks() -> Dict[str, Dict[str, Any]]:
    """Counts by (name, state) — reference ``summarize_tasks`` — plus a
    ``"phases"`` entry per task name with per-phase latency percentiles
    (p50/p99, milliseconds) over the driver's flight-recorder ring."""
    summary: Dict[str, Dict[str, Any]] = {}
    for t in list_tasks():
        name = t.get("name", "unknown")
        state = t.get("state", "unknown")
        summary.setdefault(name, {}).setdefault(state, 0)
        summary[name][state] += 1
    by_phase: Dict[str, Dict[str, List[float]]] = {}
    for ev in list_task_events(limit=100_000):
        phases = by_phase.setdefault(ev.get("name") or "task", {})
        for ph, v in (ev.get("phases") or {}).items():
            phases.setdefault(ph, []).append(v)
    for name, phases in by_phase.items():
        ent = summary.setdefault(name, {})
        ent["phases"] = {}
        for ph, vals in phases.items():
            vals.sort()
            ent["phases"][ph] = {
                "count": len(vals),
                "mean_ms": round(sum(vals) / len(vals) * 1e3, 3),
                "p50_ms": round(_percentile(vals, 0.5) * 1e3, 3),
                "p99_ms": round(_percentile(vals, 0.99) * 1e3, 3),
            }
    return summary


def summarize_contention() -> Dict[str, Any]:
    """Per-lock contention totals for THIS process (see
    :mod:`ray_tpu_torch.util.contention`): acquisitions, contended count/%,
    cumulative and max wait. Worst lock first — the first row answers
    "which lock is the bottleneck?". Remote processes' accumulators are
    on the head ``/metrics`` as ``rtpu_lock_*`` series with origin
    labels."""
    from ray_tpu_torch.util import contention

    return {"locks": contention.summarize(),
            "enabled": contention.enabled()}


def summarize_actors() -> Dict[str, int]:
    summary: Dict[str, int] = {}
    for a in list_actors():
        summary.setdefault(a["state"], 0)
        summary[a["state"]] += 1
    return summary


def summarize_objects() -> Dict[str, Any]:
    objs = list_objects()
    return {
        "total": len(objs),
        "in_plasma": sum(1 for o in objs if o["in_plasma"]),
        "inline": sum(1 for o in objs if not o["in_plasma"]),
    }


# ---------------------------------------------------------------------------
# object-memory forensics (`ray_tpu_torch memory` — reference `ray memory` role)
# ---------------------------------------------------------------------------


def _pin_indexes(rt):
    """One pass over the driver's reference machinery: (pin counts,
    arg-pinned set, nested-pinned set) snapshotted under the ref lock so
    the per-object reason lookup below is O(1)."""
    with rt._ref_lock:
        pins = dict(rt._pin_total)
        arg_pinned = {b for deps in rt._arg_pins.values() for b in deps}
        nested_pinned = {b for nested in rt._result_ref_pins.values()
                         for b in nested}
    return pins, arg_pinned, nested_pinned


def _pin_reasons(rt, oid_b: bytes, pins, arg_pinned,
                 nested_pinned) -> List[str]:
    """Why an object is alive: ``create-ref`` (live ObjectRef pins —
    driver-local or worker borrows), ``arg-pin`` (argument of an
    in-flight task), ``nested-pin`` (referenced inside another stored
    object), ``lineage`` (reconstructable: its producing task spec is
    retained), ``spilled`` (bytes on disk, not shm)."""
    reasons = []
    if pins.get(oid_b, 0) > 0:
        reasons.append("create-ref")
    if oid_b in arg_pinned:
        reasons.append("arg-pin")
    if oid_b in nested_pinned:
        reasons.append("nested-pin")
    if oid_b in rt._lineage:
        reasons.append("lineage")
    try:
        from ray_tpu_torch.core.ids import ObjectID as _OID

        if rt.store.contains_spilled(_OID(oid_b)):
            reasons.append("spilled")
    except Exception:
        pass
    return reasons


def memory_summary(limit: int = 10000,
                   min_size: int = 0) -> List[Dict[str, Any]]:
    """Per-object forensic rows (the ``ray memory`` analog): id, status,
    size, inline-vs-shm, owner process, pin count + reasons, age, and —
    when the profiler was armed at creation — the creating call-site.
    Largest first."""
    import time as _time

    rt = _gcs()
    now = _time.time()
    pins, arg_pinned, nested_pinned = _pin_indexes(rt)
    rows = []
    for oid, st in rt.gcs.all_objects():
        size = st.size or 0
        if size < min_size:
            continue
        b = oid.binary()
        meta = rt._obj_meta.get(b) or {}
        rows.append({
            "object_id": oid.hex(),
            "status": st.status,
            "size": size,
            "in_plasma": st.inline is None,
            "owner_node": rt.node_id.hex()[:8],
            "owner": meta.get("owner") or "?",
            "pins": pins.get(b, 0),
            "reasons": _pin_reasons(rt, b, pins, arg_pinned,
                                    nested_pinned),
            "age_s": (round(now - meta["ts"], 1)
                      if meta.get("ts") else None),
            "call_site": meta.get("site"),
        })
    rows.sort(key=lambda r: -r["size"])
    return rows[:limit]


#: last snapshot taken by snapshot_objects()/diff_objects() (the leak-
#: detector baseline)
_obj_snapshot: Optional[Dict[str, Dict[str, Any]]] = None


def snapshot_objects() -> Dict[str, Dict[str, Any]]:
    """Record (and return) the current object population as the baseline
    for :func:`diff_objects` — call before the workload under suspicion."""
    global _obj_snapshot
    _obj_snapshot = {r["object_id"]: r for r in memory_summary()}
    return _obj_snapshot


def diff_objects(prev: Optional[Dict[str, Dict[str, Any]]] = None
                 ) -> Dict[str, Any]:
    """Leak detector: diff the live object population against ``prev``
    (default: the last :func:`snapshot_objects` baseline). Objects that
    appeared and are still pinned are the leak suspects — each row
    carries its pin reasons and creation call-site (when the profiler
    was armed), which is what names the leaker."""
    global _obj_snapshot
    if prev is None:
        prev = _obj_snapshot or {}
    cur = {r["object_id"]: r for r in memory_summary()}
    _obj_snapshot = cur
    added = [r for oid, r in cur.items() if oid not in prev]
    removed = [r for oid, r in prev.items() if oid not in cur]
    leaked = [r for r in added if r["pins"] > 0 or r["reasons"]]
    return {
        "added": added,
        "removed": removed,
        "leak_suspects": sorted(leaked, key=lambda r: -r["size"]),
        "net_bytes": (sum(r["size"] for r in added)
                      - sum(r["size"] for r in removed)),
    }


def store_report() -> Dict[str, Any]:
    """This node's object-store occupancy/fragmentation report (native
    arena free-list walk + file segments + spill dir)."""
    return _gcs().store.report()


def object_store_tier(ref) -> str:
    """Storage tier of one object: ``"shm"`` (arena/segment resident),
    ``"spilled"`` (cold on-disk tier), ``"unknown"`` (no runtime, or the
    object is inline/absent). The PUBLIC residency probe the serving
    tier's model registry reports through ``/api/models`` — libraries
    must not reach into the store client for this (layering seam)."""
    try:
        from ray_tpu_torch.core.runtime import _get_runtime

        rt = _get_runtime()
        if rt is None:
            return "unknown"
        oid = ref.id if hasattr(ref, "id") else ref
        if rt.store.contains_spilled(oid):
            return "spilled"
        if rt.store.contains(oid):
            return "shm"
    except Exception:
        pass
    return "unknown"


def _apply_filters(records: List[Dict[str, Any]],
                   filters: Optional[List]) -> List[Dict[str, Any]]:
    """filters: [(key, op, value)] with op in {'=', '!='} (reference
    state-API filter tuples)."""
    if not filters:
        return records
    out = []
    for r in records:
        keep = True
        for key, op, value in filters:
            got = r.get(key)
            if op == "=" and got != value:
                keep = False
            elif op == "!=" and got == value:
                keep = False
        if keep:
            out.append(r)
    return out
