"""Head-side trace store + cross-process analyzers (timeline, critical path).

The receiver half of the trace plane (``util/tracing.py`` is the
recording half): every collected span lands here with origin labels
(``node_id`` / ``worker_id`` / ``component``), the exact shape the
metrics :class:`~ray_tpu_torch.util.metrics.FederationStore` gives samples.
Reference role: the GcsTaskManager/timeline pipeline plus the Ray
paper's end-to-end task timeline (arxiv 1712.05889) — one queryable
store that can answer "where did this request's wall time go?" across
process boundaries.

Three consumers:

- ``state.list_spans()`` / ``/api/traces`` — raw span query;
- :func:`build_perfetto` — the unified Chrome-trace/Perfetto document
  (spans + flight-recorder task slices + lock-contention waits + TPU
  step telemetry, one track per node/worker) for ``ray_tpu_torch timeline
  --perfetto``;
- :func:`critical_path_for_trace` / :func:`critical_path_for_tasks` —
  ``state.summarize_critical_path()`` / ``/api/critical_path``:
  attribute end-to-end wall time to per-process segments so the
  multi-client control-plane cost prints as a breakdown instead of a
  bench inference.
"""

from __future__ import annotations

import threading
from collections import deque
from itertools import islice
from typing import Any, Dict, List, Optional, Tuple


class TraceStore:
    """Bounded store of collected spans with origin labels.

    Appends carry an absolute sequence number so the cluster adapter can
    ship deltas over the heartbeat with an acked cursor (the same
    cursor+dedup contract the task-event pipeline uses); eviction past
    the cap silently advances the readable window."""

    def __init__(self, cap: Optional[int] = None):
        if cap is None:
            try:
                from ray_tpu_torch import config

                cap = int(config.get("trace_store_max"))
            except Exception:
                cap = 65536
        self._lock = threading.Lock()
        self._dq: "deque[Dict[str, Any]]" = deque(maxlen=max(64, cap))
        self._total = 0  # spans ever appended (absolute sequence)

    def ingest(self, spans: List[Dict[str, Any]],
               labels: Optional[Dict[str, str]] = None) -> None:
        if not spans:
            return
        with self._lock:
            for s in spans:
                if labels:
                    s = dict(s)
                    for k, v in labels.items():
                        s.setdefault(k, v)
                self._dq.append(s)
                self._total += 1

    def snapshot(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._dq)
        return out[-limit:] if limit else out

    def since(self, cursor: int, max_n: int = 1000
              ) -> Tuple[List[Dict[str, Any]], int]:
        """(batch, start) where ``start`` is the absolute index of
        batch[0] (>= cursor when eviction skipped spans). Advance the
        cursor to ``start + len(batch)`` only after the receiver acked."""
        with self._lock:
            start_abs = self._total - len(self._dq)
            i = max(0, cursor - start_abs)
            batch = list(islice(self._dq, i, i + max_n))
            return batch, start_abs + i

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    def clear(self) -> None:
        with self._lock:
            self._dq.clear()


# ---------------------------------------------------------------------------
# critical-path analysis
# ---------------------------------------------------------------------------


def _span_proc(s: Dict[str, Any]) -> str:
    """Stable per-process label for a span's origin."""
    wid = s.get("worker_id")
    if wid:
        return f"worker:{wid}"
    nid = s.get("node_id")
    comp = s.get("component") or "driver"
    if nid:
        return f"{comp}:{nid}"
    pid = (s.get("attributes") or {}).get("process.pid")
    return f"pid:{pid}" if pid else comp


def critical_path_for_trace(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Attribute one trace's end-to-end wall time to per-process segments.

    Sweep over the union of span boundaries; each elementary interval is
    charged to the DEEPEST (latest-starting) span covering it, labeled
    ``<name>@<process>``; intervals no span covers are transit/queue gaps,
    labeled after the spans they sit between. Segment times sum EXACTLY to
    the end-to-end time, so a serve request's route->queue->execute->stream
    chain reconciles against its measured latency."""
    spans = [s for s in spans
             if s.get("start_time_unix_nano") is not None
             and s.get("end_time_unix_nano") is not None]
    if not spans:
        return {"spans": 0, "end_to_end_ms": 0.0, "segments": {},
                "dominant": None}
    spans.sort(key=lambda s: s["start_time_unix_nano"])
    t0 = min(s["start_time_unix_nano"] for s in spans)
    t1 = max(s["end_time_unix_nano"] for s in spans)
    bounds = sorted({b for s in spans
                     for b in (s["start_time_unix_nano"],
                               s["end_time_unix_nano"])})
    segments: Dict[str, float] = {}
    last_named = None
    for a, b in zip(bounds, bounds[1:]):
        if b <= a:
            continue
        covering = [s for s in spans
                    if s["start_time_unix_nano"] <= a
                    and s["end_time_unix_nano"] >= b]
        if covering:
            # deepest = latest start, then shortest extent
            s = max(covering, key=lambda s: (s["start_time_unix_nano"],
                                             -s["end_time_unix_nano"]))
            label = f"{s['name']}@{_span_proc(s)}"
            last_named = s["name"]
        else:
            nxt = next((s["name"] for s in spans
                        if s["start_time_unix_nano"] >= b), None)
            label = f"gap:{last_named or 'start'}->{nxt or 'end'}"
        segments[label] = segments.get(label, 0.0) + (b - a) / 1e6
    total_ms = (t1 - t0) / 1e6
    ordered = dict(sorted(segments.items(), key=lambda kv: -kv[1]))
    out = {
        "trace_id": spans[0].get("trace_id"),
        "spans": len(spans),
        "end_to_end_ms": round(total_ms, 3),
        "segments": {k: {"ms": round(v, 3),
                         "pct": round(100.0 * v / total_ms, 1)
                         if total_ms else 0.0}
                     for k, v in ordered.items()},
        "dominant": next(iter(ordered), None),
    }
    return out


#: flight-recorder phases in lifecycle order (transit is the residual)
_TASK_PHASES = ("queue", "lease", "arg_fetch", "deserialize", "execute",
                "store_result")


def critical_path_for_tasks(ring_events: List[Dict[str, Any]],
                            spans: Optional[List[Dict[str, Any]]] = None
                            ) -> Dict[str, Any]:
    """Aggregate per-task critical path over the flight-recorder ring,
    augmented with driver-side control-plane CPU from submit spans when
    tracing was armed.

    Segments per task: ``driver_submit`` (submit::/driver.submit:: span
    self-time — the GIL-serialized driver CPU the multi-client inversion
    pays), the recorder's queue/lease/worker phases, and ``transit``
    (total minus everything attributed: pipe transit + driver done-path
    CPU). Means are per task; pct is of mean end-to-end."""
    if not ring_events:
        return {"mode": "tasks", "tasks": 0, "segments": {},
                "dominant": None}
    submit_ms: Dict[str, float] = {}
    for s in spans or ():
        name = s.get("name") or ""
        if not (name.startswith("submit::")
                or name.startswith("driver.submit::")):
            continue
        tid = (s.get("attributes") or {}).get("task_id")
        if not tid:
            continue
        dur = (s.get("end_time_unix_nano", 0)
               - s.get("start_time_unix_nano", 0)) / 1e6
        submit_ms[tid] = submit_ms.get(tid, 0.0) + max(0.0, dur)
    sums: Dict[str, float] = {}
    total_sum = 0.0
    n = 0
    for ev in ring_events:
        ph = ev.get("phases") or {}
        total = ph.get("total")
        if total is None:
            continue
        n += 1
        total_sum += total * 1e3
        attributed = 0.0
        for p in _TASK_PHASES:
            v = (ph.get(p) or 0.0) * 1e3
            sums[p] = sums.get(p, 0.0) + v
            attributed += v
        tid = ev.get("task_id")
        tid_hex = tid.hex() if isinstance(tid, bytes) else str(tid or "")
        drv = 0.0
        for key in (tid_hex, tid_hex[:16]):
            if key in submit_ms:
                drv = submit_ms[key]
                break
        else:
            # span attrs carry the FULL task id; ring may hold raw bytes
            for k, v in submit_ms.items():
                if tid_hex and (k.startswith(tid_hex)
                                or tid_hex.startswith(k)):
                    drv = v
                    break
        if drv:
            sums["driver_submit"] = sums.get("driver_submit", 0.0) + drv
            attributed += drv
        sums["transit"] = sums.get("transit", 0.0) + max(
            0.0, total * 1e3 - attributed)
    if not n:
        return {"mode": "tasks", "tasks": 0, "segments": {},
                "dominant": None}
    mean_total = total_sum / n
    ordered = dict(sorted(sums.items(), key=lambda kv: -kv[1]))
    return {
        "mode": "tasks",
        "tasks": n,
        "end_to_end_ms_mean": round(mean_total, 3),
        "segments": {k: {"mean_ms": round(v / n, 3),
                         "pct": round(100.0 * (v / n) / mean_total, 1)
                         if mean_total else 0.0}
                     for k, v in ordered.items()},
        "dominant": next(iter(ordered), None),
    }


def format_breakdown(result: Dict[str, Any]) -> str:
    """Human-readable table for CLI/experiment printing."""
    lines = []
    if result.get("mode") == "tasks":
        lines.append(f"critical path over {result.get('tasks', 0)} tasks "
                     f"(mean end-to-end "
                     f"{result.get('end_to_end_ms_mean', 0)} ms/task):")
        key = "mean_ms"
    else:
        lines.append(f"trace {result.get('trace_id', '?')}: "
                     f"{result.get('end_to_end_ms', 0)} ms end-to-end, "
                     f"{result.get('spans', 0)} spans:")
        key = "ms"
    for name, seg in (result.get("segments") or {}).items():
        lines.append(f"  {seg.get('pct', 0):6.1f}%  "
                     f"{seg.get(key, 0):10.3f} ms  {name}")
    if result.get("dominant"):
        lines.append(f"  dominant: {result['dominant']}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Perfetto / Chrome-trace export
# ---------------------------------------------------------------------------


def _origin_pid_tid(s: Dict[str, Any], pids: Dict[str, int],
                    names: Dict[int, str]) -> Tuple[int, str]:
    node = s.get("node_id") or "local"
    pid = pids.get(node)
    if pid is None:
        pid = pids[node] = len(pids) + 1
        names[pid] = f"node:{node}"
    attrs = s.get("attributes") or {}
    wid = s.get("worker_id")
    if wid:
        tid = f"worker:{wid}"
    else:
        ppid = attrs.get("process.pid")
        comp = s.get("component") or "proc"
        tid = f"{comp}:{ppid}" if ppid else comp
    if "program" in attrs:
        # device-plane slices (device::compile, serve::step,
        # rllib::update carry a ``program`` attribute): their own track
        # under the owning process row, so compile/step slices read as
        # one device timeline instead of interleaving with control-
        # plane spans
        tid = f"device[{tid}]"
    return pid, tid


def build_perfetto(spans: List[Dict[str, Any]],
                   timeline_events: Optional[List[Dict[str, Any]]] = None
                   ) -> Dict[str, Any]:
    """One Chrome-trace/Perfetto document merging collected spans (task
    submit/execute, serve chain, lock-contention waits, train steps) with
    the driver flight recorder's task-phase slices, on per-node process
    rows with per-worker thread tracks. Loads directly in
    ``ui.perfetto.dev`` / ``chrome://tracing``."""
    events: List[Dict[str, Any]] = []
    pids: Dict[str, int] = {}
    pnames: Dict[int, str] = {}
    for s in spans or ():
        start = s.get("start_time_unix_nano")
        end = s.get("end_time_unix_nano")
        if start is None or end is None:
            continue
        pid, tid = _origin_pid_tid(s, pids, pnames)
        name = s.get("name") or "span"
        cat = name.split("::", 1)[0] if "::" in name else "span"
        args = {k: v for k, v in (s.get("attributes") or {}).items()}
        args["trace_id"] = s.get("trace_id")
        events.append({"name": name, "ph": "X", "ts": start / 1e3,
                       "dur": max(0.001, (end - start) / 1e3),
                       "pid": pid, "tid": tid, "cat": cat, "args": args})
    for ev in timeline_events or ():
        node = ev.get("node") or "local"
        pid = pids.get(node)
        if pid is None:
            pid = pids[node] = len(pids) + 1
            pnames[pid] = f"node:{node}"
        e = dict(ev)
        e["pid"] = pid
        e["tid"] = f"worker:{ev.get('tid')}"
        e.setdefault("cat", "task")
        events.append(e)
    meta: List[Dict[str, Any]] = []
    for node, pid in pids.items():
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "args": {"name": pnames[pid]}})
    tids = {(e["pid"], e["tid"]) for e in events if e.get("ph") == "X"}
    for pid, tid in sorted(tids, key=str):
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "args": {"name": str(tid)}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}
