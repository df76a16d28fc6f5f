"""The profiling plane: cluster-wide sampling profiler + head-side store.

Role analog: ``ray stack`` / ``ray timeline``'s py-spy integration
(reference ``python/ray/scripts/scripts.py:1830``) — the forensic tool
the Ray paper leans on to find control-plane bottlenecks. r8 proved the
task-throughput ceiling is ~1-2 ms of GIL-serialized driver CPU per
task; this module is what turns that bench inference into named Python
functions: a pure-stdlib sampling profiler whose merged, per-process
flamegraphs answer "which functions is the driver burning that
millisecond in?".

Recording side (every process): a daemon SAMPLER thread walks
``sys._current_frames()`` at ``RTPU_PROFILE_HZ`` (default ~67 Hz) and
aggregates each thread's stack into a bounded per-process table keyed by
(thread name, collapsed stack at function granularity). Threads whose
leaf frame is a known waiter (``threading.Event.wait``, pipe
``recv_bytes``, ``queue.get``...) are classified IDLE and land in a
separate table so wait-dominated threads (the driver has one receiver
thread per worker) don't drown the on-CPU signal. The sampler is
observer-only: its loop takes no instrumented (TimedLock/TimedRLock)
locks, hits no failpoints, and records no spans — enforced by the
graftlint ``profiler-sampler-discipline`` rule — so it can never
deadlock against or recurse into the paths it measures.

Arming mirrors ``tracing.enable_tracing()`` exactly: live workers learn
over their control pipe (``prof`` message, replayed to workers that
dial back later), daemons over the GCS KV + ``profiling`` pubsub
channel, later spawns via the environment, and the zygote fork-server
is retired on a flip so forked workers see the current env.
``RTPU_PROFILING=0`` is the kill switch; the disarmed cost of
``profiling_enabled()`` is one dict get — no lock, no clock.

Collection rides the existing transports (the trace-plane contract):
workers drain their table into batches pushed over the control pipe,
node daemons ship their :class:`ProfileStore` deltas on the GCS
heartbeat with the acked-cursor/dedup contract from ``trace_store``,
and the head merges per-(node, pid, component) at
``state.profile(seconds=...)`` / ``GET /api/profile`` — exported as
collapsed-stack text (flamegraph.pl / speedscope paste) and speedscope
JSON (one sampled profile per thread, weights summing to the sample
count).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from itertools import islice
from typing import Any, Dict, List, Optional, Tuple

#: cluster-wide arming rides the GCS KV + pubsub (tracing pattern)
KV_NAMESPACE = "__profiling__"
KV_KEY = "spec"
CHANNEL = "profiling"

DEFAULT_HZ = 67.0

_lock = threading.Lock()
# _state["enabled"] doubles as the hot-path cache: None = unresolved,
# read WITHOUT the lock on every profiling_enabled() call (one dict get
# under the GIL; tests reset it to None to force re-resolution).
_state: Dict[str, Any] = {"enabled": None, "hz": None}

# lazily-bound builtin counters; never allowed to fail the plane
_m = {"samples": None, "dropped": None, "pushes": None}


def _metric(which: str):
    from ray_tpu_torch.util import metric_defs, metrics

    names = {"samples": "rtpu_profile_samples_total",
             "dropped": "rtpu_profile_samples_dropped_total",
             "pushes": "rtpu_profile_push_batches_total"}
    inst = _m[which]
    if inst is None or metrics.registered(names[which]) is not inst:
        inst = _m[which] = metric_defs.get(names[which])
    return inst


# ---------------------------------------------------------------------------
# idle-frame classification
# ---------------------------------------------------------------------------

#: leaf frames in these stdlib files with these function names are
#: blocked waiters, not CPU burners (heuristic: Python cannot see
#: C-level blocking, so the deepest *Python* frame of a parked thread is
#: its stdlib wait wrapper). ``send``-side functions are deliberately
#: NOT here — a thread stuck in a pipe send is paying real backpressure.
_IDLE_FILES = ("threading.py", "queue.py", "selectors.py", "socket.py",
               "connection.py", "ssl.py", "subprocess.py", "socketserver.py")
_IDLE_FUNCS = ("wait", "wait_for", "select", "poll", "accept", "get",
               "join", "recv", "recv_bytes", "recv_bytes_into", "_recv",
               "_recv_bytes", "recv_into", "read", "readinto", "sleep",
               "_try_wait", "poll_once", "_wait_for_tstate_lock")


def _is_idle_leaf(filename: str, funcname: str) -> bool:
    return (funcname in _IDLE_FUNCS
            and filename.endswith(_IDLE_FILES))


# ---------------------------------------------------------------------------
# frame naming (function granularity, bounded cardinality)
# ---------------------------------------------------------------------------

#: code object id -> (weakref-to-code, rendered frame string).
#: Function-granularity frames (co_firstlineno, not f_lineno) keep the
#: table cardinality bounded by the number of live functions, not by
#: lines executed. The weakref VALIDATES each hit: a GC'd code object's
#: address can be reused by a new one (cloudpickled task fns churn in
#: long-lived workers), and returning the dead function's label would
#: corrupt exactly the attribution this plane exists to produce.
_frame_cache: Dict[int, tuple] = {}
_FRAME_CACHE_MAX = 8192


def _frame_name(code) -> str:
    import weakref

    key = id(code)
    hit = _frame_cache.get(key)
    if hit is not None and hit[0]() is code:
        return hit[1]
    fn = code.co_filename
    # keep the last two path components: enough to disambiguate
    # ("runtime.py" alone collides; "core/runtime.py" does not)
    parts = fn.rsplit(os.sep, 2)
    short = os.sep.join(parts[-2:]) if len(parts) > 1 else fn
    name = f"{code.co_name} ({short}:{code.co_firstlineno})"
    if len(_frame_cache) >= _FRAME_CACHE_MAX:
        _frame_cache.clear()  # rare: code churn (reloads); start over
    _frame_cache[key] = (weakref.ref(code), name)
    return name


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------


class _Sampler:
    """Daemon thread aggregating stack samples into bounded tables.

    OBSERVER-ONLY discipline (graftlint ``profiler-sampler-discipline``):
    the loop body may not acquire TimedLock/TimedRLock-wrapped locks,
    hit failpoints, or record spans/metrics — it runs concurrently with
    every instrumented path it observes. The table lock below is a plain
    ``threading.Lock`` shared only with :meth:`drain`.
    """

    def __init__(self, hz: float, table_max: int, start: bool = True):
        self.hz = max(1.0, float(hz))
        self.table_max = max(64, int(table_max))
        self._table_lock = threading.Lock()  # plain lock, never timed
        # (thread_name, frames_tuple) -> count
        self._busy: Dict[Tuple[str, Tuple[str, ...]], int] = {}
        self._idle: Dict[Tuple[str, Tuple[str, ...]], int] = {}
        self._dropped = 0
        self._total = 0
        self._idle_total = 0
        self._t0 = time.time()
        # per-thread walk cache: a PARKED thread's top frame (object id +
        # instruction offset) is unchanged between ticks, so its stack
        # key can be reused without re-walking — this is what keeps the
        # sampler's cost per tick proportional to RUNNING threads, not
        # to the driver's one-receiver-thread-per-worker population
        self._walk_cache: Dict[int, tuple] = {}
        # thread-name map refresh is amortized (threading.enumerate takes
        # the interpreter's thread-registry lock; ~1/s is plenty)
        self._names: Dict[int, str] = {}
        self._names_at = 0.0
        self._stop = threading.Event()
        self._thread = None
        if start:
            self._thread = threading.Thread(
                target=self._sample_loop, daemon=True,
                name="rtpu_profiler")
            self._thread.start()

    def _sample_once(self) -> None:
        frames = sys._current_frames()
        now = time.monotonic()
        if (now - self._names_at > 1.0
                or any(i not in self._names for i in frames)):
            # refresh amortized, AND whenever a thread this map has
            # never seen appears — a freshly started thread must be
            # attributed by name from its first sample
            self._names = {t.ident: t.name for t in threading.enumerate()}
            for i in frames:
                # non-registry threads (C-spawned) get a stable fallback
                # so they never re-trigger the refresh
                self._names.setdefault(i, f"tid-{i}")
            self._names_at = now
        names = self._names
        me = threading.get_ident()
        cache = self._walk_cache
        for ident, frame in frames.items():
            if ident == me:
                continue  # never sample the sampler
            sig = (id(frame), frame.f_lasti)
            hit = cache.get(ident)
            if hit is not None and hit[0] == sig:
                key, idle = hit[1], hit[2]
            else:
                stack: List[str] = []
                leaf_code = frame.f_code
                f = frame
                depth = 0
                while f is not None and depth < 128:
                    stack.append(_frame_name(f.f_code))
                    f = f.f_back
                    depth += 1
                stack.reverse()  # root -> leaf (collapsed-stack order)
                tname = names.get(ident) or f"tid-{ident}"
                idle = _is_idle_leaf(leaf_code.co_filename,
                                     leaf_code.co_name)
                key = (tname, tuple(stack))
                cache[ident] = (sig, key, idle)
            with self._table_lock:
                table = self._idle if idle else self._busy
                n = table.get(key)
                if n is None and (len(self._busy) + len(self._idle)
                                  >= self.table_max):
                    self._dropped += 1
                    continue
                table[key] = (n or 0) + 1
                if idle:
                    self._idle_total += 1
                else:
                    self._total += 1
        if len(cache) > 4 * max(8, len(frames)):
            # dead threads leave stale idents behind; prune occasionally
            cache_keys = set(frames)
            for k in list(cache):
                if k not in cache_keys:
                    del cache[k]

    def _sample_loop(self) -> None:
        period = 1.0 / self.hz
        next_t = time.monotonic()
        while not self._stop.is_set():
            self._sample_once()
            next_t += period
            delay = next_t - time.monotonic()
            if delay <= 0:
                # fell behind (GIL-starved under load): resynchronize
                # instead of bursting to catch up
                next_t = time.monotonic() + period
                delay = period
            if self._stop.wait(delay):
                return

    def record_for_tests(self, thread: str, frames: List[str],
                         idle: bool = False) -> None:
        """Inject one synthetic sample (deterministic bound/shape tests)."""
        key = (thread, tuple(frames))
        with self._table_lock:
            table = self._idle if idle else self._busy
            n = table.get(key)
            if n is None and (len(self._busy) + len(self._idle)
                              >= self.table_max):
                self._dropped += 1
                return
            table[key] = (n or 0) + 1
            if idle:
                self._idle_total += 1
            else:
                self._total += 1

    def drain(self) -> Optional[Dict[str, Any]]:
        """Swap the tables out and return one batch dict (None when no
        samples landed). Samples leave exactly once; the builtin
        counters are settled here in one batch, never per sample."""
        with self._table_lock:
            if not self._busy and not self._idle and not self._dropped:
                return None
            busy, self._busy = self._busy, {}
            idle, self._idle = self._idle, {}
            dropped, self._dropped = self._dropped, 0
            total, self._total = self._total, 0
            idle_total, self._idle_total = self._idle_total, 0
            t0, self._t0 = self._t0, time.time()
        batch = {
            "pid": os.getpid(),
            "t0": t0,
            "t1": time.time(),
            "hz": self.hz,
            "samples": [[t, list(s), n] for (t, s), n in busy.items()],
            "idle": [[t, list(s), n] for (t, s), n in idle.items()],
            "total": total,
            "idle_total": idle_total,
            "dropped": dropped,
        }
        try:
            if total or idle_total:
                _metric("samples")._inc_key((), total + idle_total)
            if dropped:
                _metric("dropped")._inc_key((), dropped)
        except Exception:
            pass
        return batch

    def stats(self) -> Dict[str, int]:
        with self._table_lock:
            return {"busy_keys": len(self._busy),
                    "idle_keys": len(self._idle),
                    "total": self._total, "idle_total": self._idle_total,
                    "dropped": self._dropped}

    def stop(self) -> None:
        self._stop.set()


_sampler: Optional[_Sampler] = None
#: final windows of stopped samplers (disarm flip): drained batches wait
#: here until the next collection hop ships them — without this, the
#: tail of a `state.profile(seconds=...)` window would vanish on disarm
_pending_batches: List[Dict[str, Any]] = []


def _fork_reset() -> None:
    # the sampler thread does not survive fork; the child (a zygote
    # worker) restarts it lazily from its own main loop when armed
    global _sampler
    _sampler = None
    _pending_batches.clear()
    _state["enabled"] = None
    _frame_cache.clear()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_fork_reset)


def _hz() -> float:
    hz = _state["hz"]
    if hz is None:
        try:
            from ray_tpu_torch import config

            hz = float(config.get("profile_hz"))
        except Exception:
            hz = DEFAULT_HZ
        _state["hz"] = hz
    return hz


def _table_max() -> int:
    try:
        from ray_tpu_torch import config

        return int(config.get("profile_table_max"))
    except Exception:
        return 4096


def ensure_sampler() -> Optional[_Sampler]:
    """Start (or return) this process's sampler when profiling is armed.
    Called from arming paths and the worker main loop — never from the
    disarmed fast path."""
    global _sampler
    if not profiling_enabled():
        return None
    with _lock:
        if _sampler is None and _state["enabled"]:
            _sampler = _Sampler(_hz(), _table_max())
        return _sampler


def _stop_sampler() -> None:
    global _sampler
    with _lock:
        s, _sampler = _sampler, None
    if s is not None:
        s.stop()
        tail = s.drain()
        if tail:
            _pending_batches.append(tail)


# ---------------------------------------------------------------------------
# arming (the enable_tracing() contract)
# ---------------------------------------------------------------------------


def _resolve() -> bool:
    with _lock:
        if _state["enabled"] is None:
            _state["enabled"] = os.environ.get("RTPU_PROFILING", "0") == "1"
    if _state["enabled"]:
        ensure_sampler()
    return _state["enabled"]


def profiling_enabled() -> bool:
    e = _state["enabled"]
    if e is None:
        return _resolve()
    return e


def push_spec() -> Dict[str, Any]:
    """The arming payload shipped to workers/daemons (pipe + pubsub/KV)."""
    return {"enabled": bool(profiling_enabled()), "hz": _hz()}


def apply_remote(payload: Dict[str, Any]) -> None:
    """Apply a driver-pushed arming payload in THIS process (worker pipe
    message / daemon pubsub / KV late-join sync)."""
    enabled = bool(payload.get("enabled"))
    os.environ["RTPU_PROFILING"] = "1" if enabled else "0"
    hz = payload.get("hz")
    with _lock:
        _state["enabled"] = enabled
        if hz:
            _state["hz"] = float(hz)
            os.environ["RTPU_PROFILE_HZ"] = str(hz)
    if enabled:
        ensure_sampler()
    else:
        _stop_sampler()


def broadcast_local(rt, payload: Optional[Dict[str, Any]]) -> None:
    """Push an arming payload to every live worker of ``rt`` and remember
    it so workers spawned later receive it on dial-back (mirrors
    tracing.broadcast_local)."""
    if not getattr(rt, "is_driver", False):
        return
    rt._profile_push = payload
    for ws in list(getattr(rt, "workers", {}).values()):
        if ws.status == "dead" or ws.conn is None:
            continue
        try:
            ws.send(("prof", payload))
        except Exception:
            pass


def _retire_zygote() -> None:
    # the fork-server's env snapshot predates the flip (tracing pattern);
    # retire it so the next spawn sees the current RTPU_PROFILING
    from ray_tpu_torch.util import tracing

    tracing._retire_zygote()


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


def enable_profiling(hz: Optional[float] = None) -> None:
    """Arm the sampling profiler in THIS process, its live workers
    (control pipe push), workers spawned after this call (env), and — in
    cluster mode — every daemon and ITS workers (GCS KV + ``profiling``
    pubsub; late joiners pull the KV at registration)."""
    os.environ["RTPU_PROFILING"] = "1"
    with _lock:
        _state["enabled"] = True
        if hz:
            _state["hz"] = float(hz)
            os.environ["RTPU_PROFILE_HZ"] = str(hz)
    ensure_sampler()
    _broadcast(push_spec())


def disable_profiling() -> None:
    """The runtime counterpart of ``RTPU_PROFILING=0``: stop sampling in
    this process and everywhere :func:`enable_profiling` reaches. Workers
    flush their table tails on receipt (the trace-plane disarm flush)."""
    os.environ["RTPU_PROFILING"] = "0"
    with _lock:
        _state["enabled"] = False
    _stop_sampler()
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


def drain_batches() -> List[Dict[str, Any]]:
    """Pop this process's aggregated window(s) as a batch list — the
    collection hop (worker pipe push / daemon heartbeat / head query).
    Samples leave exactly once; includes the stashed final window of a
    just-stopped sampler (disarm tail)."""
    out: List[Dict[str, Any]] = []
    while _pending_batches:
        try:
            out.append(_pending_batches.pop(0))
        except IndexError:
            break
    s = _sampler
    if s is not None:
        batch = s.drain()
        if batch:
            out.append(batch)
    return out


def idle_sleep(seconds: float) -> None:
    """Sleep that the sampler classifies IDLE: the profiler cannot see
    C-level ``time.sleep`` (the leaf Python frame is the caller, which
    reads as busy), but an ``Event.wait`` parks in ``threading.py
    wait`` — use this for waits inside profiling/query paths so the
    profiler never attributes its own window to itself."""
    threading.Event().wait(max(0.0, seconds))


def note_push() -> None:
    """Count one shipped batch (worker pipe / heartbeat ride)."""
    try:
        _metric("pushes")._inc_key(())
    except Exception:
        pass


def sampler_stats() -> Dict[str, int]:
    s = _sampler
    return s.stats() if s is not None else {}


def _reset_for_tests() -> None:
    _stop_sampler()
    _pending_batches.clear()  # a stopped sampler's tail must not leak
    with _lock:                # into the next test's drain
        _state["enabled"] = None
        _state["hz"] = None
    _frame_cache.clear()


# ---------------------------------------------------------------------------
# one-shot live stacks (`ray_tpu_torch stack`'s py-spy role)
# ---------------------------------------------------------------------------


def current_stacks() -> Dict[str, str]:
    """One live sample of every thread in THIS process:
    ``{thread_name: "root;...;leaf"}`` at function granularity. Needs no
    arming — it is a read of ``sys._current_frames()``."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    me = threading.get_ident()
    out: Dict[str, str] = {}
    for ident, frame in frames.items():
        if ident == me:
            continue
        stack: List[str] = []
        f = frame
        depth = 0
        while f is not None and depth < 128:
            stack.append(_frame_name(f.f_code))
            f = f.f_back
            depth += 1
        out[names.get(ident) or f"tid-{ident}"] = ";".join(
            reversed(stack))
    return out


def caller_site(skip_prefixes: Tuple[str, ...] = ("ray_tpu_torch",)) -> str:
    """Nearest non-runtime caller frame as ``file:line func`` — the
    creation call-site recorded for object-memory forensics when the
    profiler is armed."""
    f = sys._getframe(1)
    depth = 0
    while f is not None and depth < 32:
        fn = f.f_code.co_filename
        norm = fn.replace(os.sep, "/")
        if not any(f"/{p}/" in norm or norm.startswith(p + "/")
                   for p in skip_prefixes):
            parts = fn.rsplit(os.sep, 2)
            short = os.sep.join(parts[-2:]) if len(parts) > 1 else fn
            return f"{short}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
        depth += 1
    return ""


# ---------------------------------------------------------------------------
# head-side store (the trace_store cursor/dedup contract)
# ---------------------------------------------------------------------------


class ProfileStore:
    """Bounded store of collected profile batches with origin labels.

    Appends carry an absolute sequence number so the cluster adapter can
    ship deltas over the heartbeat with an acked cursor (same contract
    as :class:`ray_tpu_torch.util.trace_store.TraceStore`); eviction past the
    cap silently advances the readable window."""

    def __init__(self, cap: Optional[int] = None):
        if cap is None:
            try:
                from ray_tpu_torch import config

                cap = int(config.get("profile_store_max"))
            except Exception:
                cap = 2048
        self._lock = threading.Lock()
        self._dq: "deque[Dict[str, Any]]" = deque(maxlen=max(16, cap))
        self._total = 0

    def ingest(self, batches: List[Dict[str, Any]],
               labels: Optional[Dict[str, str]] = None) -> None:
        if not batches:
            return
        rx = time.time()
        with self._lock:
            for b in batches:
                if labels:
                    b = dict(b)
                    for k, v in labels.items():
                        b.setdefault(k, v)
                # receiver-side arrival stamp: the window filter in
                # merge_batches uses THIS clock as a fallback, so a
                # remote node's skewed wall clock cannot silently drop
                # its batches from a state.profile(seconds=...) window
                b.setdefault("_rx", rx)
                self._dq.append(b)
                self._total += 1

    def snapshot(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._dq)
        return out[-limit:] if limit else out

    def since(self, cursor: int, max_n: int = 200
              ) -> Tuple[List[Dict[str, Any]], int]:
        """(batch, start): ``start`` is the absolute index of batch[0]
        (>= cursor when eviction skipped entries). Advance the cursor to
        ``start + len(batch)`` only after the receiver acked."""
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
# merge + export (collapsed text, speedscope JSON)
# ---------------------------------------------------------------------------


def _proc_key(b: Dict[str, Any]) -> str:
    comp = b.get("component") or "proc"
    node = b.get("node_id") or "local"
    return f"{comp}@{node}/{b.get('pid')}"


def merge_batches(batches: List[Dict[str, Any]],
                  since: Optional[float] = None) -> Dict[str, Any]:
    """Merge collected batches per (node, pid, component) process, each
    holding per-thread stack counts. ``since`` keeps only batches whose
    window ended after that wall-clock time OR that ARRIVED at a store
    after it (the ``state.profile(seconds=...)`` window filter; the
    arrival stamp makes the filter robust to remote clock skew — a
    batch received after the window opened necessarily overlaps it, up
    to one push interval of slop)."""
    procs: Dict[str, Dict[str, Any]] = {}
    for b in batches:
        if since is not None and (b.get("t1") or 0) < since \
                and (b.get("_rx") or 0) < since:
            continue
        key = _proc_key(b)
        p = procs.get(key)
        if p is None:
            p = procs[key] = {
                "component": b.get("component") or "proc",
                "node_id": b.get("node_id") or "local",
                "worker_id": b.get("worker_id"),
                "pid": b.get("pid"),
                "threads": {},
                "idle_threads": {},
                "total": 0, "idle_total": 0, "dropped": 0,
                "t0": b.get("t0"), "t1": b.get("t1"),
            }
        p["t0"] = min(p["t0"], b.get("t0") or p["t0"])
        p["t1"] = max(p["t1"], b.get("t1") or p["t1"])
        p["total"] += int(b.get("total") or 0)
        p["idle_total"] += int(b.get("idle_total") or 0)
        p["dropped"] += int(b.get("dropped") or 0)
        for field, dest in (("samples", "threads"),
                            ("idle", "idle_threads")):
            for thread, stack, n in b.get(field) or ():
                tt = p[dest].setdefault(thread, {})
                sk = tuple(stack)
                tt[sk] = tt.get(sk, 0) + int(n)
    return {"processes": procs,
            "total": sum(p["total"] for p in procs.values()),
            "idle_total": sum(p["idle_total"] for p in procs.values()),
            "dropped": sum(p["dropped"] for p in procs.values())}


def top_self(merged: Dict[str, Any], component: Optional[str] = None,
             n: int = 20) -> List[Dict[str, Any]]:
    """On-CPU functions ranked by SELF samples (leaf-frame attribution)
    across the merged profile, optionally restricted to one component
    (``"driver"`` = the control plane). The direct input to "which
    functions is the driver burning that millisecond in?"."""
    counts: Dict[str, int] = {}
    total = 0
    for p in merged["processes"].values():
        if component is not None and p["component"] != component:
            continue
        for stacks in p["threads"].values():
            for stack, c in stacks.items():
                if not stack:
                    continue
                leaf = stack[-1]
                counts[leaf] = counts.get(leaf, 0) + c
                total += c
    ranked = sorted(counts.items(), key=lambda kv: -kv[1])[:n]
    return [{"function": fn, "self_samples": c,
             "self_pct": round(100.0 * c / total, 1) if total else 0.0}
            for fn, c in ranked]


def collapsed_text(merged: Dict[str, Any],
                   include_idle: bool = False) -> str:
    """Collapsed-stack lines (``proc;thread;frame;...;leaf N``) — paste
    into speedscope or feed flamegraph.pl."""
    lines: List[str] = []
    for key, p in sorted(merged["processes"].items()):
        sources = [p["threads"]]
        if include_idle:
            sources.append(p["idle_threads"])
        for src in sources:
            for thread, stacks in sorted(src.items()):
                for stack, c in sorted(stacks.items(), key=str):
                    lines.append(
                        ";".join([key, thread, *stack]) + f" {c}")
    return "\n".join(lines)


def speedscope_doc(merged: Dict[str, Any],
                   name: str = "ray_tpu_torch profile") -> Dict[str, Any]:
    """Speedscope file-format document: ONE sampled profile per sampled
    (process, thread), a shared frame table, and per-profile weights
    that sum exactly to that thread's sample count (each sample weighs
    1). Open at https://speedscope.app."""
    frames: List[Dict[str, Any]] = []
    index: Dict[str, int] = {}

    def fidx(fname: str) -> int:
        i = index.get(fname)
        if i is None:
            i = index[fname] = len(frames)
            frames.append({"name": fname})
        return i

    profiles = []
    for key, p in sorted(merged["processes"].items()):
        for thread, stacks in sorted(p["threads"].items()):
            samples, weights = [], []
            for stack, c in sorted(stacks.items(), key=str):
                # one entry per UNIQUE stack weighted by its count: the
                # weights of a profile sum exactly to that thread's
                # sample count while staying compact for hot stacks
                samples.append([fidx(f) for f in stack])
                weights.append(c)
            end = sum(weights)
            profiles.append({
                "type": "sampled",
                "name": f"{key} {thread}",
                "unit": "none",
                "startValue": 0,
                "endValue": end,
                "samples": samples,
                "weights": weights,
            })
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": profiles,
        "name": name,
        "exporter": "ray_tpu_torch",
        "activeProfileIndex": 0,
    }
