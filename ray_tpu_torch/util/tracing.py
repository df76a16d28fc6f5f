"""Distributed tracing: W3C-propagated spans + the per-process span ring.

Role analog: ``python/ray/util/tracing/tracing_helper.py`` — the reference
wraps task submission/execution in OpenTelemetry spans and propagates the
context inside the task spec (``_DictPropagator``). This image ships only
the ``opentelemetry`` API (no SDK), so spans are recorded natively in the
OTLP-compatible shape (trace_id/span_id/parent hex ids, epoch-nano
timestamps, attributes).

Recording plane (the trace analog of the metrics federation): every
process records finished spans into a bounded in-memory RING
(``RTPU_TRACE_RING`` entries; overflow increments
``rtpu_trace_spans_dropped_total``). Collection drains the ring in
batches that ride the EXISTING channels — workers push over the control
pipe (like the metric delta push), node daemons' spans (their own + their
workers') ride the GCS heartbeat, and the head pulls at query/export time
— landing in the head-side :class:`ray_tpu_torch.util.trace_store.TraceStore`
served at ``/api/traces`` and ``state.list_spans()``. When
``RTPU_TRACE_FILE`` is set explicitly, spans are ALSO appended there as
JSON lines (debug / single-process use); there is no default scattered
``traces.jsonl`` anymore. A configured OTel SDK still receives every span
through ``opentelemetry.trace``.

Enable: ``ray_tpu_torch.util.tracing.enable_tracing()`` on the driver — live
workers learn over their control pipe, daemons/GCS over the cluster
KV + ``tracing`` pubsub channel (failpoints-style push; late joiners pull
the KV at registration) — or the ``RTPU_TRACING=1`` env var before
spawn. ``RTPU_TRACING=0`` is the kill switch. Disabled cost of
``span()``/``tracing_enabled()`` is one dict get — no lock, no clock.

Span names (``<layer>::<what>``; the graftlint ``tracing-span-names``
rule keeps this catalog and the call sites bidirectionally in sync —
``<...>`` marks a dynamic suffix behind a literal prefix)::

    submit::<task>          task/actor-call submission, origin process
    driver.submit::<task>   driver control-plane CPU handling a submit
    execute::<task>         worker-side task/actor-method execution
    dag::execute            compiled-DAG invocation admission (driver)
    dag::stage              one compiled-DAG stage method inside an actor
    serve.handle::request   end-to-end serve request (manual span)
    serve.handle::route     replica selection + dispatch in the handle
    serve.replica::execute  user callable execution inside the replica
    serve.proxy::request    HTTP proxy unary request (manual span)
    serve.proxy::stream     HTTP proxy streaming response (manual span)
    serve.llm::queue        LLM admission wait to first token (manual)
    serve.llm::stream       LLM token-stream lifetime (manual span)
    serve.disagg::request   end-to-end disaggregated request (manual)
    serve.disagg::prefill   prefill-pool call + KV-block ship (manual)
    serve.disagg::decode    decode-pool adopt + token stream (manual)
    data.exchange::map      streaming-exchange partition task body
    data.exchange::reduce   streaming-exchange reducer block ingest
    train::step             one optimizer step (manual span)
    train::compile          one XLA compile event (manual span)
    device::compile         one registered-program XLA compile/retrace
    serve::step             one serve engine decode step (manual span)
    rllib::update           one learner update dispatch (manual span)
    lock::<name>            contended lock wait >= 1 ms (manual span)
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

# Span-id generation + pid stamping WITHOUT per-span syscalls: on this
# class of box (gVisor-style kernel) every syscall costs ~30 µs, so
# secrets.token_hex (urandom) and os.getpid per span would triple the
# span cost all by themselves. Trace ids need uniqueness, not
# cryptographic strength: one urandom seeds a process-local PRNG, the
# pid is cached, and an at-fork hook resets both so forked children
# (zygote workers) can never replay the parent's id stream.
_idgen: Dict[str, Any] = {"rng": None, "pid": 0}


def _idgen_init() -> None:
    import random as _random

    pid = os.getpid()
    seed = (int.from_bytes(os.urandom(16), "big")
            ^ (pid << 64) ^ time.time_ns())
    _idgen["rng"] = _random.Random(seed)
    _idgen["pid"] = pid


if hasattr(os, "register_at_fork"):
    os.register_at_fork(
        after_in_child=lambda: _idgen.update(rng=None, pid=0))


def _rand_hex(nbytes: int) -> str:
    rng = _idgen["rng"]
    if rng is None:
        _idgen_init()
        rng = _idgen["rng"]
    return "%0*x" % (nbytes * 2, rng.getrandbits(nbytes * 8))


def _pid() -> int:
    if _idgen["rng"] is None:
        _idgen_init()
    return _idgen["pid"]

#: cluster-wide arming rides the GCS KV + pubsub (failpoints pattern)
KV_NAMESPACE = "__tracing__"
KV_KEY = "spec"
CHANNEL = "tracing"

_lock = threading.Lock()
# _state["enabled"] doubles as the hot-path cache: None = unresolved,
# read WITHOUT the lock on every span()/tracing_enabled() call (a dict
# get under the GIL; tests reset it to None to force re-resolution).
_state = {"enabled": None, "path": None, "fd": None}
_ctx = threading.local()  # current (trace_id, span_id)

# bounded span ring (the recording side of the trace plane)
_ring: "deque[Dict[str, Any]]" = deque()
_ring_cap: Optional[int] = None
_dropped = 0
_dropped_counted = 0  # drops already settled into the builtin counter

# lazily-bound builtin counters; never allowed to fail a span
_m = {"spans": None, "dropped": None, "pushes": None}


def _metric(which: str):
    from ray_tpu_torch.util import metric_defs, metrics

    names = {"spans": "rtpu_trace_spans_total",
             "dropped": "rtpu_trace_spans_dropped_total",
             "pushes": "rtpu_trace_push_batches_total"}
    inst = _m[which]
    if inst is None or metrics.registered(names[which]) is not inst:
        inst = _m[which] = metric_defs.get(names[which])
    return inst


def _resolve() -> bool:
    with _lock:
        if _state["enabled"] is None:
            _state["enabled"] = os.environ.get("RTPU_TRACING", "0") == "1"
            if _state["enabled"]:
                _state["path"] = os.environ.get("RTPU_TRACE_FILE", "")
        return _state["enabled"]


def tracing_enabled() -> bool:
    e = _state["enabled"]
    if e is None:
        return _resolve()
    return e


def _ring_capacity() -> int:
    global _ring_cap
    if _ring_cap is None:
        try:
            from ray_tpu_torch import config

            _ring_cap = max(16, int(config.get("trace_ring")))
        except Exception:
            _ring_cap = 8192
    return _ring_cap


def _retire_zygote() -> None:
    """The zygote fork-server's env snapshot predates an arming flip, so
    retire it — the next spawn relaunches it with the current tracing env
    (otherwise forked workers would silently never record / keep
    recording)."""
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
    return {"enabled": bool(tracing_enabled()),
            "file": os.environ.get("RTPU_TRACE_FILE", "")}


def apply_remote(payload: Dict[str, Any]) -> None:
    """Apply a driver-pushed arming payload in THIS process (worker pipe
    message / daemon pubsub / KV late-join sync)."""
    enabled = bool(payload.get("enabled"))
    os.environ["RTPU_TRACING"] = "1" if enabled else "0"
    f = payload.get("file") or ""
    if f:
        os.environ["RTPU_TRACE_FILE"] = f
    with _lock:
        _state["enabled"] = enabled
        _state["path"] = f or os.environ.get("RTPU_TRACE_FILE", "")
        _state["fd"] = None


def broadcast_local(rt, payload: Optional[Dict[str, Any]]) -> None:
    """Push an arming payload to every live worker of ``rt`` and remember
    it so workers spawned later receive it on dial-back (mirrors
    failpoints._broadcast_local)."""
    if not getattr(rt, "is_driver", False):
        return
    rt._trace_push = payload
    for ws in list(getattr(rt, "workers", {}).values()):
        if ws.status == "dead" or ws.conn is None:
            continue
        try:
            ws.send(("trace", payload))
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


def enable_tracing(trace_file: Optional[str] = None) -> None:
    """Turn on span recording in THIS process, its live workers (control
    pipe push), workers spawned after this call (env), and — in cluster
    mode — every daemon and ITS workers (GCS KV + ``tracing`` pubsub;
    late joiners pull the KV at registration)."""
    os.environ["RTPU_TRACING"] = "1"
    if trace_file:
        os.environ["RTPU_TRACE_FILE"] = trace_file
    with _lock:
        _state["enabled"] = True
        _state["path"] = os.environ.get("RTPU_TRACE_FILE", "")
        _state["fd"] = None
    _broadcast(push_spec())


def disable_tracing() -> None:
    """The runtime counterpart of ``RTPU_TRACING=0``: stop recording in
    this process and everywhere :func:`enable_tracing` reaches."""
    os.environ["RTPU_TRACING"] = "0"
    with _lock:
        _state["enabled"] = False
        _state["fd"] = None
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


def _trace_path() -> str:
    return _state["path"] or ""


def _record(rec: Dict[str, Any]) -> None:
    """Land one finished span: ring (always), explicit trace file (when
    configured), OTel mirror (when an SDK is installed). The builtin
    counters are batched into :func:`drain_ring` — a per-span metric-lock
    hop would double the span cost for a number nobody reads per-span."""
    global _dropped
    with _lock:
        if len(_ring) >= _ring_capacity():
            _ring.popleft()
            _dropped += 1
        _ring.append(rec)
    if _state["path"]:
        _emit_file(rec)
    _mirror_to_otel(rec["name"], rec)


def _emit_file(rec: Dict[str, Any]) -> None:
    line = json.dumps(rec) + "\n"
    try:
        with _lock:
            fd = _state["fd"]
            if fd is None:
                fd = os.open(_trace_path(),
                             os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
                _state["fd"] = fd
        os.write(fd, line.encode())  # O_APPEND: atomic for short lines
    except Exception:
        pass


def drain_ring(max_n: Optional[int] = None) -> List[Dict[str, Any]]:
    """Pop up to ``max_n`` (default: all) spans from this process's ring —
    the collection hop (worker pipe push / daemon heartbeat / head query).
    Spans leave the ring exactly once. The recorded/dropped counters are
    settled here, in one batch per drain."""
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
            _metric("spans")._inc_key((), len(out))
        if dropped_new:
            _metric("dropped")._inc_key((), dropped_new)
            _metric("spans")._inc_key((), dropped_new)
    except Exception:
        pass
    return out


def ring_stats() -> Dict[str, int]:
    with _lock:
        return {"len": len(_ring), "dropped": _dropped,
                "capacity": _ring_capacity()}


def note_push() -> None:
    """Count one shipped span batch (worker pipe / heartbeat)."""
    try:
        _metric("pushes")._inc_key(())
    except Exception:
        pass


def _reset_for_tests() -> None:
    """Restore module state so a test can re-resolve from a patched env."""
    global _ring_cap, _dropped, _dropped_counted
    with _lock:
        _state["enabled"] = None
        _state["path"] = None
        _state["fd"] = None
        _ring.clear()
        _ring_cap = None
        _dropped = 0
        _dropped_counted = 0
    _ctx.ids = None


def current_traceparent() -> Optional[str]:
    """W3C traceparent for the active span ('00-<trace>-<span>-01')."""
    cur = getattr(_ctx, "ids", None)
    if not cur:
        return None
    return f"00-{cur[0]}-{cur[1]}-01"


def _parse_traceparent(tp: Optional[str]):
    if not tp:
        return None, None
    parts = tp.split("-")
    if len(parts) != 4:
        return None, None
    return parts[1], parts[2]


def _resolve_parent(parent: Optional[str]):
    """(trace_id, parent_span_id) from an explicit traceparent or this
    thread's active span; fresh trace when neither exists."""
    if parent is not None:
        trace_id, parent_span = _parse_traceparent(parent)
    else:
        cur = getattr(_ctx, "ids", None)
        trace_id, parent_span = (cur if cur else (None, None))
    if trace_id is None:
        trace_id = _rand_hex(16)
    return trace_id, parent_span


@contextmanager
def span(name: str, attributes: Optional[Dict[str, Any]] = None,
         parent: Optional[str] = None):
    """Record one span. ``parent``: a traceparent string from another
    process (task spec propagation); defaults to this thread's active
    span. Yields the span's traceparent for manual propagation.

    The span context is THREAD-LOCAL: never hold this context manager
    open across a ``yield`` or hand its body to another thread — use
    :func:`manual_span` / :func:`record_span` there (the graftlint
    ``tracing-context-capture`` rule enforces this)."""
    if not tracing_enabled():
        yield None
        return
    trace_id, parent_span = _resolve_parent(parent)
    span_id = _rand_hex(8)
    prev = getattr(_ctx, "ids", None)
    _ctx.ids = (trace_id, span_id)
    start = time.time_ns()
    err = None
    try:
        yield f"00-{trace_id}-{span_id}-01"
    except BaseException as e:
        err = repr(e)
        raise
    finally:
        _ctx.ids = prev
        rec = {
            "name": name,
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_span_id": parent_span,
            "start_time_unix_nano": start,
            "end_time_unix_nano": time.time_ns(),
            "attributes": {**(attributes or {}),
                           "process.pid": _pid()},
        }
        if err:
            rec["status"] = {"code": "ERROR", "message": err[:300]}
        _record(rec)


class ManualSpan:
    """A long-lived span finished explicitly — for request lifetimes that
    cross threads/yields where the thread-local ``span()`` context cannot
    be held open (serve request end-to-end, LLM token streams)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_span_id",
                 "start", "attributes", "_done")

    def __init__(self, name: str, attributes: Optional[Dict[str, Any]],
                 parent: Optional[str]):
        self.name = name
        self.trace_id, self.parent_span_id = _resolve_parent(parent)
        self.span_id = _rand_hex(8)
        self.start = time.time_ns()
        self.attributes = dict(attributes or {})
        self._done = False

    @property
    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def finish(self, attributes: Optional[Dict[str, Any]] = None,
               error: Optional[str] = None) -> None:
        if self._done:
            return
        self._done = True
        rec = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "start_time_unix_nano": self.start,
            "end_time_unix_nano": time.time_ns(),
            "attributes": {**self.attributes, **(attributes or {}),
                           "process.pid": _pid()},
        }
        if error:
            rec["status"] = {"code": "ERROR", "message": error[:300]}
        _record(rec)


@contextmanager
def context(parent: Optional[str]):
    """Adopt an existing traceparent as this thread's active span context
    WITHOUT recording a new span — the blessed re-entry point for work
    continued on another thread or after a manual span (a serve proxy
    parenting the handle's request span under its own, a generator
    resuming inside its stream's trace)."""
    if parent is None or not tracing_enabled():
        yield
        return
    trace_id, span_id = _parse_traceparent(parent)
    if trace_id is None:
        yield
        return
    prev = getattr(_ctx, "ids", None)
    _ctx.ids = (trace_id, span_id)
    try:
        yield
    finally:
        _ctx.ids = prev


def manual_span(name: str, attributes: Optional[Dict[str, Any]] = None,
                parent: Optional[str] = None) -> Optional[ManualSpan]:
    """Start a :class:`ManualSpan` (None when tracing is disabled — the
    disabled path stays one dict get)."""
    if not tracing_enabled():
        return None
    return ManualSpan(name, attributes, parent)


def record_span(name: str, start_ns: int, end_ns: int,
                attributes: Optional[Dict[str, Any]] = None,
                parent: Optional[str] = None) -> None:
    """One-shot span with caller-supplied timestamps (train telemetry,
    lock-contention slices — places that know the duration after the
    fact)."""
    if not tracing_enabled():
        return
    trace_id, parent_span = _resolve_parent(parent)
    rec = {
        "name": name,
        "trace_id": trace_id,
        "span_id": _rand_hex(8),
        "parent_span_id": parent_span,
        "start_time_unix_nano": int(start_ns),
        "end_time_unix_nano": int(end_ns),
        "attributes": {**(attributes or {}), "process.pid": _pid()},
    }
    _record(rec)


_otel_tracer: Any = None  # None = unresolved; False = unavailable/no-op


def _mirror_to_otel(name: str, rec: Dict[str, Any]) -> None:
    """If a real OTel SDK is configured in this process, replay the span
    (with the REAL timestamps) so external exporters see the same data.
    The tracer is resolved once — a failed import must not tax every span."""
    global _otel_tracer
    if _otel_tracer is False:
        return
    if _otel_tracer is None:
        try:
            from opentelemetry import trace as ot

            tracer = ot.get_tracer("ray_tpu_torch")
            # API-without-SDK yields NonRecording spans: disable the mirror
            probe = tracer.start_span("rtpu-probe")
            recording = probe.is_recording()
            probe.end()
            _otel_tracer = tracer if recording else False
        except Exception:
            _otel_tracer = False
        if _otel_tracer is False:
            return
    try:
        s = _otel_tracer.start_span(
            name, start_time=rec["start_time_unix_nano"])
        for k, v in rec["attributes"].items():
            s.set_attribute(k, v)
        s.end(end_time=rec["end_time_unix_nano"])
    except Exception:
        pass


def read_trace_file(path: Optional[str] = None) -> list:
    out = []
    try:
        with open(path or _trace_path()) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        pass
    return out
