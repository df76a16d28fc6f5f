"""Lightweight lock-contention profiler for the runtime's hot locks.

Green-field relative to the reference (Ray profiles contention with
external tools — py-spy, perf); on a 2-vCPU box the driver's single
dispatch lock IS the scalability story (BENCH multi-client inversion),
so the runtime carries its own instrumentation:

- :func:`timed_lock` / :func:`timed_rlock` wrap ``threading`` locks.
  The uncontended path costs ONE extra non-blocking acquire attempt and
  two unlocked integer adds — no clock read, no metric lock. Only a
  CONTENDED acquisition (the fast try failed) pays two clock reads and
  a histogram observe (``rtpu_lock_wait_seconds{lock=...}``).
- queue-wait sampling for thread-pool-style handoffs lives with the
  pools themselves (cluster/rpc.py observes
  ``rtpu_rpc_server_queue_wait_seconds``); this module only covers
  locks.
- :func:`summarize` feeds ``state.summarize_contention()`` and the
  dashboard's ``/api/contention``; a metrics collector exports the
  accumulators as ``rtpu_lock_{acquisitions,contended,wait_seconds_sum}``
  gauges so federation ships them like everything else.

Stats are PER NAME, not per instance: the driver's many worker send
locks share one "driver.worker_send" row. Accumulator updates are
unlocked plain-int adds — the GIL makes torn reads impossible and a
lost increment under a race costs accuracy a profiler doesn't need;
taking a lock to measure locks would add the very contention being
measured. Disable with ``RTPU_CONTENTION_PROFILER=0`` (wrappers then
return raw ``threading`` locks with zero overhead).
"""

from __future__ import annotations

import threading
import time
from time import perf_counter
from typing import Dict, Optional

#: contended waits shorter than this skip the histogram (they would only
#: bounce the histogram's own lock); the unlocked accumulators still see
#: them.
HISTOGRAM_MIN_WAIT_S = 5e-5

#: contended waits at least this long also become ``lock::<name>`` spans
#: when tracing is armed (contention slices on the Perfetto timeline)
TRACE_MIN_WAIT_S = 1e-3


class _LockStats:
    __slots__ = ("name", "acquisitions", "contended", "wait_total",
                 "wait_max")

    def __init__(self, name: str):
        self.name = name
        self.acquisitions = 0
        self.contended = 0
        self.wait_total = 0.0
        self.wait_max = 0.0


_stats_lock = threading.Lock()
_stats: Dict[str, _LockStats] = {}
_hist = None
_collector_registered = False


def _get_stats(name: str) -> _LockStats:
    with _stats_lock:
        st = _stats.get(name)
        if st is None:
            st = _stats[name] = _LockStats(name)
        _ensure_collector()
    return st


def _wait_hist():
    global _hist
    from ray_tpu_torch.util import metric_defs, metrics

    if _hist is None or metrics.registered("rtpu_lock_wait_seconds") \
            is not _hist:
        _hist = metric_defs.get("rtpu_lock_wait_seconds")
    return _hist


def _ensure_collector() -> None:
    """Export the accumulators as gauges at every registry snapshot."""
    global _collector_registered
    if _collector_registered:
        return
    _collector_registered = True
    from ray_tpu_torch.util import metric_defs, metrics

    def collect():
        acq = metric_defs.get("rtpu_lock_acquisitions")
        con = metric_defs.get("rtpu_lock_contended")
        tot = metric_defs.get("rtpu_lock_wait_seconds_sum")
        with _stats_lock:
            rows = list(_stats.values())
        for st in rows:
            tags = {"lock": st.name}
            acq.set(st.acquisitions, tags=tags)
            con.set(st.contended, tags=tags)
            tot.set(st.wait_total, tags=tags)

    metrics.register_collector(collect)


class _TimedLockBase:
    """Shared acquire/release timing over an inner threading lock.

    Duck-types the stdlib lock surface including the private Condition
    protocol (``_release_save``/``_acquire_restore``/``_is_owned``), so
    ``threading.Condition(timed_rlock(...))`` works — Condition's
    wait-path re-acquire bypasses the timing on purpose (parked waiters
    are not contention)."""

    __slots__ = ("_inner", "_stats", "_hist_key")

    def __init__(self, inner, name: str):
        self._inner = inner
        self._stats = _get_stats(name)
        self._hist_key = (("lock", name),)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        st = self._stats
        st.acquisitions += 1
        inner = self._inner
        if inner.acquire(False):
            return True
        if not blocking:
            return False
        t0 = perf_counter()
        ok = inner.acquire(True, timeout)
        wait = perf_counter() - t0
        st.contended += 1
        st.wait_total += wait
        if wait > st.wait_max:
            st.wait_max = wait
        if wait >= HISTOGRAM_MIN_WAIT_S:
            try:
                _wait_hist()._observe_key(self._hist_key, wait)
            except Exception:
                pass
        if wait >= TRACE_MIN_WAIT_S:
            # contention slice on the unified timeline: only waits long
            # enough to be visible at trace zoom, only when tracing is
            # armed (uncontended/short paths never reach here)
            try:
                from ray_tpu_torch.util import tracing

                if tracing.tracing_enabled():
                    end = time.time_ns()
                    tracing.record_span(f"lock::{st.name}",
                                        end - int(wait * 1e9), end)
            except Exception:
                pass
        return ok

    def release(self):
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self._inner.release()
        return False

    # -- Condition protocol (delegated, untimed) -----------------------

    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        return self._inner._release_save()

    def _acquire_restore(self, state):
        return self._inner._acquire_restore(state)


class TimedLock(_TimedLockBase):
    def __init__(self, name: str):
        super().__init__(threading.Lock(), name)

    def locked(self):
        # only here, not on the base: threading.RLock has no .locked()
        # until 3.12, so TimedRLock must not advertise it either.
        return self._inner.locked()

    def _is_owned(self):  # Condition fallback for plain locks
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        self._inner.release()

    def _acquire_restore(self, state):
        self._inner.acquire()


class TimedRLock(_TimedLockBase):
    def __init__(self, name: str):
        super().__init__(threading.RLock(), name)


def enabled() -> bool:
    from ray_tpu_torch import config

    return bool(config.get("contention_profiler"))


def timed_lock(name: str):
    """A ``threading.Lock`` with wait-time accounting under ``name``
    (raw lock when the profiler is disabled)."""
    return TimedLock(name) if enabled() else threading.Lock()


def timed_rlock(name: str):
    return TimedRLock(name) if enabled() else threading.RLock()


def summarize() -> Dict[str, Dict[str, float]]:
    """Per-lock contention totals for THIS process since start:
    {name: {acquisitions, contended, contended_pct, wait_total_s,
    wait_max_s}} sorted by total wait, worst first."""
    with _stats_lock:
        rows = list(_stats.values())
    out = {}
    for st in sorted(rows, key=lambda s: -s.wait_total):
        acq = st.acquisitions
        out[st.name] = {
            "acquisitions": acq,
            "contended": st.contended,
            "contended_pct": round(100.0 * st.contended / acq, 2)
            if acq else 0.0,
            "wait_total_s": round(st.wait_total, 6),
            "wait_max_s": round(st.wait_max, 6),
        }
    return out


def reset() -> None:
    """Zero the accumulators (bench A/B sections)."""
    with _stats_lock:
        rows = list(_stats.values())
    for st in rows:
        st.acquisitions = 0
        st.contended = 0
        st.wait_total = 0.0
        st.wait_max = 0.0


def top_waits(n: int = 3) -> Dict[str, float]:
    """The n locks with the largest cumulative wait: {name: seconds}."""
    s = summarize()
    return {k: v["wait_total_s"] for k, v in list(s.items())[:n]}
