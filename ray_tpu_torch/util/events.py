"""Lifecycle events: the cluster's "what happened and why" plane.

Role analog: the reference event subsystem (``src/ray/util/event.cc`` +
the dashboard's event head) and the exit-reason forensics the reference
state API attaches to dead workers/actors. Four planes (metrics, flight
recorder, tracing, profiling) answer "what is slow"; this fifth plane
answers "what happened": every interesting lifecycle transition is a
structured event, and every DEATH event carries a postmortem (exit
code/signal, stderr tail, last USR1 stack dump when one landed in the
log) captured at the reaping site — the same forensics that are folded
into the ``WorkerCrashedError``/``ActorDiedError`` users see.

Recording plane (the event twin of the tracing ring): every process
records events into a bounded in-memory RING (``RTPU_EVENT_RING``
entries; overflow increments ``rtpu_lifecycle_events_dropped_total``).
Collection rides the EXISTING channels — workers push over the control
pipe (like span batches), node daemons' events (their own + their
workers') ride the GCS heartbeat with the TraceStore acked-cursor/dedup
contract, and the GCS itself appends its node-lifecycle events (register
/ heartbeat-timeout death) directly to the head store — landing in the
head-side :class:`ray_tpu_torch.util.event_store.EventStore` served at
``/api/events``, ``state.list_events()`` and ``rtpu events``.

Events are ON by default (they are rare and cheap — lifecycle
transitions, not per-task records); ``RTPU_EVENTS=0`` is the kill
switch, and :func:`disable_events`/:func:`enable_events` flip the plane
cluster-wide at runtime over the failpoints-style KV + pubsub push. The
disabled cost of :func:`emit`/:func:`events_enabled` is one dict get —
no lock, no clock.

Event names (flat ``lower_snake`` vocabulary; the graftlint
``event-name-catalog`` rule keeps this catalog and the ``emit()`` call
sites bidirectionally in sync)::

    worker_spawn          a worker process was launched (zygote or exec)
    worker_death          a worker process died; postmortem attached
    actor_restart         a dead actor is being restarted (restart #)
    actor_death           an actor died permanently (no restarts left)
    node_register         a node registered with the GCS
    node_death            the GCS declared a node dead; postmortem
    gcs_restart           a daemon re-registered after GCS state loss
    object_spill          an object landed on disk instead of shm
    object_restore        a spilled object was promoted back into shm
    serve_replica_death   a serve replica died and was dropped
    serve_reroute         serve handles were told to refresh routing
    serve_drain           a serve replica is draining: live sessions
                          migrate to surviving replicas before the stop
    serve_session_migrated  a live decode session's KV blocks shipped to
                          a surviving replica (no re-prefill)
    checkpoint_resume     training resumed from a persisted checkpoint
    train_world_epoch     elastic membership change: the train gang
                          re-formed at a new world size (shrink on
                          preemption / expand on restored capacity)
    alert_raised          the watchdog raised an alert (util/alerts.py)
    alert_cleared         a raised alert condition went away
    jit_recompile         a registered program recompiled past its first
                          trace; payload carries the signature diff
                          (util/device_plane.py)
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

#: cluster-wide arming rides the GCS KV + pubsub (failpoints pattern)
KV_NAMESPACE = "__events__"
KV_KEY = "spec"
CHANNEL = "events"

#: severity attached to death/alert events (everything else is "info")
_SEVERITY = {
    "worker_death": "error",
    "actor_death": "error",
    "node_death": "error",
    "serve_replica_death": "error",
    "actor_restart": "warning",
    "gcs_restart": "warning",
    "serve_drain": "warning",
    "train_world_epoch": "warning",
    "alert_raised": "warning",
    "alert_cleared": "info",
    "jit_recompile": "warning",
}

_lock = threading.Lock()
# _state["enabled"] doubles as the hot-path cache: None = unresolved,
# read WITHOUT the lock on every emit()/events_enabled() call (a dict
# get under the GIL; tests reset it to None to force re-resolution).
_state: Dict[str, Any] = {"enabled": None}

# bounded event ring (the recording side of the plane)
_ring: "deque[Dict[str, Any]]" = deque()
_ring_cap: Optional[int] = None
_dropped = 0
_dropped_counted = 0  # drops already settled into the builtin counter

# lazily-bound builtin counters; never allowed to fail an emit
_m = {"events": None, "dropped": None, "pushes": None}


def _metric(which: str):
    from ray_tpu_torch.util import metric_defs, metrics

    names = {"events": "rtpu_lifecycle_events_total",
             "dropped": "rtpu_lifecycle_events_dropped_total",
             "pushes": "rtpu_event_push_batches_total"}
    inst = _m[which]
    if inst is None or metrics.registered(names[which]) is not inst:
        inst = _m[which] = metric_defs.get(names[which])
    return inst


def _resolve() -> bool:
    with _lock:
        if _state["enabled"] is None:
            # default ON: RTPU_EVENTS=0 is the kill switch
            _state["enabled"] = os.environ.get("RTPU_EVENTS", "1") != "0"
        return _state["enabled"]


def events_enabled() -> bool:
    e = _state["enabled"]
    if e is None:
        return _resolve()
    return e


def _ring_capacity() -> int:
    global _ring_cap
    if _ring_cap is None:
        try:
            from ray_tpu_torch import config

            _ring_cap = max(16, int(config.get("event_ring")))
        except Exception:
            _ring_cap = 2048
    return _ring_cap


def _retire_zygote() -> None:
    """The zygote fork-server's env snapshot predates an arming flip, so
    retire it — the next spawn relaunches it with the current events env
    (same contract as tracing/profiling arming flips)."""
    try:
        from ray_tpu_torch.core import runtime as _rt_mod

        rt = _rt_mod._runtime
        if rt is not None and getattr(rt, "is_driver", False):
            with rt._zygote_lock:
                if rt._zygote_obj is not None:
                    rt._zygote_obj.close()
                    rt._zygote_obj = None
    except Exception:
        pass


def push_spec() -> Dict[str, Any]:
    """The arming payload shipped to workers/daemons (pipe + pubsub/KV)."""
    return {"enabled": bool(events_enabled())}


def apply_remote(payload: Dict[str, Any]) -> None:
    """Apply a driver-pushed arming payload in THIS process (worker pipe
    message / daemon pubsub / KV late-join sync)."""
    enabled = bool(payload.get("enabled"))
    os.environ["RTPU_EVENTS"] = "1" if enabled else "0"
    with _lock:
        _state["enabled"] = enabled


def broadcast_local(rt, payload: Optional[Dict[str, Any]]) -> None:
    """Push an arming payload to every live worker of ``rt`` and remember
    it so workers spawned later receive it on dial-back (mirrors
    tracing.broadcast_local)."""
    if not getattr(rt, "is_driver", False):
        return
    rt._event_push = payload
    for ws in list(getattr(rt, "workers", {}).values()):
        if ws.status == "dead" or ws.conn is None:
            continue
        try:
            ws.send(("events", payload))
        except Exception:
            pass


def _broadcast(payload: Dict[str, Any]) -> None:
    """Local workers + cluster-wide distribution of an arming flip."""
    _retire_zygote()
    try:
        from ray_tpu_torch.core import runtime as _rt_mod

        rt = _rt_mod._runtime
    except Exception:
        rt = None
    if rt is None or not getattr(rt, "is_driver", False):
        return
    broadcast_local(rt, payload)
    cluster = getattr(rt, "cluster", None)
    if cluster is not None:
        try:
            cluster.kv_op("put", KV_KEY, json.dumps(payload).encode(),
                          KV_NAMESPACE, True)
            cluster.gcs.call("publish", CHANNEL, payload, timeout=10)
        except Exception:
            pass


def enable_events() -> None:
    """Turn on event recording in THIS process, its live workers (control
    pipe push), workers spawned after this call (env), and — in cluster
    mode — every daemon and ITS workers (GCS KV + ``events`` pubsub)."""
    os.environ["RTPU_EVENTS"] = "1"
    with _lock:
        _state["enabled"] = True
    _broadcast(push_spec())


def disable_events() -> None:
    """The runtime counterpart of ``RTPU_EVENTS=0``: stop recording in
    this process and everywhere :func:`enable_events` reaches."""
    os.environ["RTPU_EVENTS"] = "0"
    with _lock:
        _state["enabled"] = False
    _broadcast(push_spec())


def sync_from_kv(kv_get) -> None:
    """Pull + apply the cluster-wide arming payload (late joiners /
    re-registration). ``kv_get(key, namespace) -> Optional[bytes]``."""
    try:
        blob = kv_get(KV_KEY, KV_NAMESPACE)
    except Exception:
        return
    if blob:
        try:
            apply_remote(json.loads(blob.decode()))
        except Exception:
            pass


def record(name: str, severity: Optional[str] = None,
           **fields: Any) -> Optional[Dict[str, Any]]:
    """Build one stamped event record WITHOUT the ring hop — for the
    process that already holds the destination store (the GCS appends
    its node-lifecycle events straight to the head deque). ``name`` is
    cataloged exactly like :func:`emit` call sites. None when the plane
    is killed."""
    if not events_enabled():
        return None
    rec: Dict[str, Any] = {
        "name": name,
        "ts": time.time(),
        "severity": severity or _SEVERITY.get(name, "info"),
    }
    rec.update(fields)
    return rec


def emit(name: str, severity: Optional[str] = None,
         **fields: Any) -> None:
    """Record one lifecycle event into this process's ring.

    ``name`` must be a literal from the Event-names catalog in this
    module's docstring (graftlint ``event-name-catalog``); ``fields``
    are the event's structured payload (ids as short hex strings,
    postmortems under a ``"postmortem"`` key). Disabled cost is one
    dict get."""
    rec = record(name, severity, **fields)
    if rec is None:
        return
    global _dropped
    with _lock:
        if len(_ring) >= _ring_capacity():
            _ring.popleft()
            _dropped += 1
        _ring.append(rec)


def drain_ring(max_n: Optional[int] = None) -> List[Dict[str, Any]]:
    """Pop up to ``max_n`` (default: all) events from this process's ring
    — the collection hop (worker pipe push / daemon heartbeat / head
    query). Events leave the ring exactly once. The recorded/dropped
    counters are settled here, in one batch per drain."""
    global _dropped_counted
    out: List[Dict[str, Any]] = []
    with _lock:
        n = len(_ring) if max_n is None else min(max_n, len(_ring))
        for _ in range(n):
            out.append(_ring.popleft())
        dropped_new = _dropped - _dropped_counted
        _dropped_counted = _dropped
    try:
        if out:
            _metric("events")._inc_key((), len(out))
        if dropped_new:
            _metric("dropped")._inc_key((), dropped_new)
            _metric("events")._inc_key((), dropped_new)
    except Exception:
        pass
    return out


def ring_stats() -> Dict[str, int]:
    with _lock:
        return {"len": len(_ring), "dropped": _dropped,
                "capacity": _ring_capacity()}


def note_push() -> None:
    """Count one shipped event batch (worker pipe / heartbeat)."""
    try:
        _metric("pushes")._inc_key(())
    except Exception:
        pass


def _reset_for_tests() -> None:
    """Restore module state so a test can re-resolve from a patched env."""
    global _ring_cap, _dropped, _dropped_counted
    with _lock:
        _state["enabled"] = None
        _ring.clear()
        _ring_cap = None
        _dropped = 0
        _dropped_counted = 0


# ---------------------------------------------------------------------------
# postmortems: death forensics captured at the reaping site
# ---------------------------------------------------------------------------

#: lines that make it into a postmortem's ``error_lines`` extraction
_ERROR_LINE = re.compile(
    r"Traceback \(most recent call last\)|\bFATAL\b|\bCRITICAL\b"
    r"|^\s*\w*(Error|Exception|Interrupt|Exit)\b.*:|Segmentation fault"
    r"|MemoryError|Killed\b", re.IGNORECASE)

#: head line of a faulthandler USR1 dump (worker.py registers it)
_STACK_HEAD = re.compile(r"^(Current thread|Thread) 0x[0-9a-f]+")


def describe_exit(status: Optional[int]) -> str:
    """Human cause class for a waitpid-style exit code: ``clean_exit``,
    ``exit:<code>`` or ``signal:<NAME>`` (negative codes are signals, the
    Popen/waitstatus_to_exitcode convention)."""
    if status is None:
        return "unknown"
    if status == 0:
        return "clean_exit"
    if status < 0:
        try:
            import signal as _signal

            return f"signal:{_signal.Signals(-status).name}"
        except (ValueError, ImportError):
            return f"signal:{-status}"
    return f"exit:{status}"


def _read_log_tail(log_path: Optional[str], pid: Optional[int],
                   max_bytes: int) -> str:
    """Last ``max_bytes`` of the process's log, falling back to
    ``/proc/<pid>/fd/{1,2}`` when the file was deleted under a live
    process (the known failure mode on this box: a 0-byte or missing
    log with output still readable through the fd)."""
    candidates = []
    if log_path:
        candidates.append(log_path)
    if pid:
        candidates.extend([f"/proc/{pid}/fd/2", f"/proc/{pid}/fd/1"])
    for path in candidates:
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - max_bytes))
                data = f.read(max_bytes)
            if data:
                return data.decode("utf-8", errors="replace")
        except OSError:
            continue
    return ""


def extract_error_lines(text: str, max_lines: int = 20) -> List[str]:
    """The log lines worth reading first: tracebacks heads, *Error:
    lines, OOM-killer traces — bounded, newest last."""
    out = [ln for ln in text.splitlines() if _ERROR_LINE.search(ln)]
    return out[-max_lines:]


def extract_last_stack(text: str, max_lines: int = 40) -> Optional[str]:
    """The LAST faulthandler dump in the log (a USR1 stack from
    `rtpu stack` / hung-test debugging), when one landed before death."""
    lines = text.splitlines()
    start = None
    for i, ln in enumerate(lines):
        if _STACK_HEAD.match(ln):
            start = i
    if start is None:
        return None
    return "\n".join(lines[start:start + max_lines])


def build_postmortem(exit_status: Optional[int] = None,
                     log_path: Optional[str] = None,
                     pid: Optional[int] = None,
                     max_tail_bytes: int = 4096,
                     **extra: Any) -> Dict[str, Any]:
    """Assemble a death postmortem at the reaping site: exit cause class
    (code/signal), a bounded stderr tail, extracted error lines, and the
    last USR1 stack when one is in the log. Never raises — forensics
    must not break the death path they explain."""
    pm: Dict[str, Any] = {"cause": describe_exit(exit_status)}
    if exit_status is not None:
        pm["exit_status"] = exit_status
    pm.update(extra)
    try:
        tail = _read_log_tail(log_path, pid, max_tail_bytes)
        if tail:
            pm["stderr_tail"] = tail[-max_tail_bytes:]
            err_lines = extract_error_lines(tail)
            if err_lines:
                pm["error_lines"] = err_lines
            stack = extract_last_stack(tail)
            if stack:
                pm["last_stack"] = stack
    except Exception:
        pass
    return pm


def format_postmortem(pm: Optional[Dict[str, Any]],
                      max_chars: int = 1200) -> str:
    """One readable block for folding a postmortem into an error message
    (cause line + the most useful log excerpt), bounded so a crash-loop
    can't bloat every TaskError with megabytes of log."""
    if not pm:
        return ""
    parts = [f"cause: {pm.get('cause', 'unknown')}"]
    if pm.get("error_lines"):
        parts.append("error lines:\n  " + "\n  ".join(pm["error_lines"]))
    elif pm.get("stderr_tail"):
        parts.append("stderr tail:\n  "
                     + "\n  ".join(pm["stderr_tail"].splitlines()[-8:]))
    out = "\n".join(parts)
    return out[-max_chars:]
