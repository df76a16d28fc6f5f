"""Alerting watchdog: declarative rules over the metric registries.

Role analog: the reference dashboard's alerting surface (and every
prod cluster's Prometheus rules file), folded into the head process —
the metrics already exist (four planes feed them), so alerting is a
small evaluator, not a new pipeline. A background thread at the head
samples the merged metric view every ``alerts_interval_s`` seconds and
evaluates a declarative rule list; a rule that breaches for
``for_ticks`` consecutive ticks RAISES (one ``alert_raised`` lifecycle
event + the ``rtpu_alerts_active`` gauge), and clears only after
``clear_ticks`` consecutive healthy ticks (hysteresis — a metric
hovering at the threshold must not flap a page).

Rule kinds (each a plain dict — the whole rule table is data):

``gauge_above``     any sample of ``metric`` exceeds ``threshold``
``ratio_above``     sum(metric) / sum(denominator) exceeds ``threshold``
``hist_p_above``    the ``q`` quantile of ``metric``'s observations
                    WITHIN the last tick window (bucket deltas, not
                    cumulative history) exceeds ``threshold``; skipped
                    until ``min_count`` observations land in the window
``stall``           ``metric`` (a depth gauge) sits at/above
                    ``min_depth`` while ``flow`` (a counter) made no
                    progress across the window
``delta_above``     the summed counter ``metric`` grew by more than
                    ``threshold`` within one tick window (a RATE rule
                    over cumulative counters — the compile-storm shape)

The default table covers the failure modes this box actually produces:
heartbeat-gap stretch, worker-spawn stalls (zygote queueing), serve KV
pool exhaustion, scheduler queue stalls, serve SLO burn (TTFT/TPOT
histograms), and arena occupancy. ``RTPU_ALERTS=0`` kills the plane;
surfaced via ``state.list_alerts()`` / ``/api/alerts`` / ``rtpu
status``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: consecutive breach/healthy ticks before raise/clear (hysteresis)
FOR_TICKS = 2
CLEAR_TICKS = 2

DEFAULT_RULES: List[Dict[str, Any]] = [
    {"name": "heartbeat_gap", "kind": "hist_p_above",
     "metric": "rtpu_gcs_heartbeat_gap_seconds", "q": 0.99,
     "threshold": 3.0, "min_count": 3, "severity": "warning",
     "description": "p99 inter-heartbeat gap stretched past 3s "
                    "(nominal 0.5s): GCS or sender contention"},
    {"name": "worker_spawn_stall", "kind": "hist_p_above",
     "metric": "rtpu_worker_spawn_seconds", "q": 0.5,
     "threshold": 5.0, "min_count": 1, "severity": "warning",
     "description": "median worker spawn >5s this window: fork/boot "
                    "queueing (the r8 zygote-burst signature)"},
    {"name": "kv_pool_exhaustion", "kind": "gauge_above",
     "metric": "rtpu_serve_pool_kv_used_fraction", "threshold": 0.95,
     "severity": "warning",
     "description": "a serve replica's KV block pool is >95% used: "
                    "admission sheds/preemption imminent"},
    {"name": "queue_stall", "kind": "stall",
     "metric": "rtpu_scheduler_ready_queue_depth",
     "flow": "rtpu_scheduler_tasks_dispatched_total", "min_depth": 1,
     "severity": "warning",
     "description": "ready tasks queued but nothing dispatched across "
                    "a whole window: resource deadlock or dead pool"},
    {"name": "serve_slo_ttft", "kind": "hist_p_above",
     "metric": "rtpu_serve_ttft_seconds", "q": 0.95,
     "threshold": 2.0, "min_count": 5, "severity": "warning",
     "description": "serve p95 time-to-first-token >2s this window"},
    {"name": "serve_slo_tpot", "kind": "hist_p_above",
     "metric": "rtpu_serve_tpot_seconds", "q": 0.95,
     "threshold": 0.5, "min_count": 20, "severity": "warning",
     "description": "serve p95 time-per-output-token >500ms this "
                    "window"},
    {"name": "arena_occupancy", "kind": "ratio_above",
     "metric": "rtpu_object_store_bytes_used",
     "denominator": "rtpu_object_store_capacity_bytes",
     "threshold": 0.9, "severity": "warning",
     "description": "shm arena >90% full: spills (and their disk-rate "
                    "ceiling) imminent"},
    {"name": "jit_compile_storm", "kind": "delta_above",
     "metric": "rtpu_jit_retraces_total", "threshold": 2.0,
     "severity": "warning",
     "description": "3+ jit retraces within one watchdog window: a "
                    "registered program is recompiling in a loop "
                    "(shape/dtype churn) — read the jit_recompile "
                    "events' signature diffs for the offending arg"},
    {"name": "hbm_occupancy", "kind": "ratio_above",
     "metric": "rtpu_tpu_hbm_used_bytes",
     "denominator": "rtpu_tpu_hbm_limit_bytes",
     "threshold": 0.92, "severity": "warning",
     "description": "device HBM >92% full: the next retrace or batch "
                    "bump OOMs — read /api/devices' live-buffer census "
                    "for what is resident"},
]

_lock = threading.Lock()
_state: Dict[str, Any] = {"enabled": None}


def _resolve() -> bool:
    with _lock:
        if _state["enabled"] is None:
            _state["enabled"] = os.environ.get("RTPU_ALERTS", "1") != "0"
        return _state["enabled"]


def alerts_enabled() -> bool:
    e = _state["enabled"]
    if e is None:
        return _resolve()
    return e


def _reset_for_tests() -> None:
    global _watchdog
    with _lock:
        _state["enabled"] = None
    _watchdog = None


# ---------------------------------------------------------------------------
# metric view: merged name -> [(tags_key, value)] across origins
# ---------------------------------------------------------------------------


def _merge_records(payloads: List[Tuple[dict, list]]) -> Dict[str, list]:
    """[(origin_labels, records)] -> {metric_name: [(key, value)]} with
    histogram values as (bucket_counts, sum, total, boundaries)."""
    view: Dict[str, list] = {}
    for _labels, records in payloads:
        for rec in records or ():
            samples = rec.get("samples") or []
            if not samples:
                continue
            rows = view.setdefault(rec["name"], [])
            if rec.get("type") == "histogram":
                bounds = rec.get("boundaries") or []
                for k, (counts, s, total) in samples:
                    rows.append((k, (list(counts), s, total, bounds)))
            else:
                rows.extend(samples)
    return view


def default_sample_fn() -> Dict[str, list]:
    """The head's merged metric view: this process's registry, its
    workers' federated samples, and — in cluster mode — every other
    node's latest heartbeat payload from the GCS."""
    from ray_tpu_torch.util import metrics as _metrics

    payloads: List[Tuple[dict, list]] = [({}, _metrics.registry_records())]
    try:
        payloads.extend(_metrics.federation.export())
    except Exception:
        pass
    try:
        from ray_tpu_torch.core import runtime as _rt_mod

        rt = _rt_mod._runtime
        cluster = getattr(rt, "cluster", None) if rt is not None else None
        if cluster is not None:
            remote = cluster.gcs.call("metrics_get",
                                      cluster.node_id, timeout=5)
            payloads.extend(remote or [])
    except Exception:
        pass
    return _merge_records(payloads)


# ---------------------------------------------------------------------------
# rule evaluation
# ---------------------------------------------------------------------------


def _hist_totals(rows: list):
    """Aggregate histogram samples: (summed bucket counts, total, bounds)."""
    counts: Optional[List[int]] = None
    total = 0
    bounds: list = []
    for _k, v in rows:
        c, _s, t, b = v
        if counts is None:
            counts = [0] * len(c)
            bounds = b
        if len(c) == len(counts):
            counts = [a + x for a, x in zip(counts, c)]
            total += t
    return counts or [], total, bounds


def _quantile(counts: List[int], total: int, bounds: list,
              q: float) -> float:
    """Upper-bound quantile from bucket counts (the Prometheus
    histogram_quantile convention: the bucket boundary the q-th
    observation falls under; +Inf bucket reports the top boundary)."""
    if total <= 0:
        return 0.0
    rank = q * total
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= rank:
            return float(bounds[i]) if i < len(bounds) else float(
                bounds[-1] if bounds else 0.0)
    return float(bounds[-1] if bounds else 0.0)


class Watchdog:
    """Evaluate a declarative rule table over the metric view on a
    fixed tick, with raise/clear hysteresis. ``evaluate_once`` is the
    whole engine — the thread just calls it on an interval — so tests
    drive ticks synthetically with a fake ``sample_fn``."""

    def __init__(self, rules: Optional[List[Dict[str, Any]]] = None,
                 sample_fn: Optional[Callable[[], Dict[str, list]]] = None,
                 interval_s: Optional[float] = None):
        if interval_s is None:
            try:
                from ray_tpu_torch import config

                interval_s = float(config.get("alerts_interval_s"))
            except Exception:
                interval_s = 5.0
        self.rules = list(DEFAULT_RULES if rules is None else rules)
        self.sample_fn = sample_fn or default_sample_fn
        self.interval_s = interval_s
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # per-rule evaluation state: breach/ok streaks + active flag
        self._streak: Dict[str, int] = {}
        self._active: Dict[str, Dict[str, Any]] = {}
        # previous cumulative samples for windowed kinds
        self._prev: Dict[str, Any] = {}

    # -- per-kind checks (each returns (breached, observed value)) -----

    def _check(self, rule: Dict[str, Any],
               view: Dict[str, list]) -> Tuple[Optional[bool], float]:
        kind = rule["kind"]
        rows = view.get(rule["metric"]) or []
        if kind == "gauge_above":
            if not rows:
                return None, 0.0
            val = max(float(v) for _k, v in rows)
            return val > rule["threshold"], val
        if kind == "ratio_above":
            den_rows = view.get(rule["denominator"]) or []
            num = sum(float(v) for _k, v in rows)
            den = sum(float(v) for _k, v in den_rows)
            if den <= 0:
                return None, 0.0
            val = num / den
            return val > rule["threshold"], val
        if kind == "hist_p_above":
            counts, total, bounds = _hist_totals(rows)
            prev = self._prev.get(rule["name"]) or ([0] * len(counts), 0)
            pc, pt = prev
            if len(pc) != len(counts):
                pc, pt = [0] * len(counts), 0
            self._prev[rule["name"]] = (counts, total)
            win = [max(0, a - b) for a, b in zip(counts, pc)]
            wtotal = max(0, total - pt)
            if wtotal < rule.get("min_count", 1):
                return None, 0.0
            val = _quantile(win, wtotal, bounds, rule["q"])
            return val > rule["threshold"], val
        if kind == "delta_above":
            total = sum(float(v) for _k, v in rows)
            prev = self._prev.get(rule["name"])
            self._prev[rule["name"]] = total
            if prev is None:
                return None, 0.0  # first tick: no window yet
            delta = max(0.0, total - prev)
            return delta > rule["threshold"], delta
        if kind == "stall":
            flow_rows = view.get(rule["flow"]) or []
            depth = max((float(v) for _k, v in rows), default=0.0)
            flow = sum(float(v) for _k, v in flow_rows)
            pflow = self._prev.get(rule["name"])
            self._prev[rule["name"]] = flow
            if pflow is None:
                return None, depth
            breached = (depth >= rule.get("min_depth", 1)
                        and flow - pflow <= 0)
            return breached, depth
        return None, 0.0

    def evaluate_once(self,
                      view: Optional[Dict[str, list]] = None) -> List[dict]:
        """One watchdog tick: evaluate every rule, apply hysteresis,
        emit raise/clear events, refresh the active gauge. Returns the
        active alert list."""
        if view is None:
            view = self.sample_fn()
        from ray_tpu_torch.util import events

        with self._lock:
            for rule in self.rules:
                name = rule["name"]
                try:
                    breached, val = self._check(rule, view)
                except Exception:
                    breached, val = None, 0.0
                if breached is None:
                    continue  # no data: streaks hold, nothing flaps
                streak = self._streak.get(name, 0)
                streak = (max(1, streak + 1) if breached
                          else min(-1, streak - 1))
                self._streak[name] = streak
                active = name in self._active
                if breached and not active and streak >= FOR_TICKS:
                    self._active[name] = {
                        "alert": name, "severity": rule["severity"],
                        "value": val, "threshold": rule["threshold"],
                        "description": rule["description"],
                        "since": time.time()}
                    events.emit("alert_raised", alert=name,
                                severity=rule["severity"], value=val,
                                threshold=rule["threshold"],
                                description=rule["description"])
                elif active:
                    if breached:
                        self._active[name]["value"] = val  # keep fresh
                    elif -streak >= CLEAR_TICKS:
                        self._active.pop(name, None)
                        events.emit("alert_cleared", alert=name,
                                    severity=rule["severity"], value=val,
                                    threshold=rule["threshold"])
            out = [dict(a) for a in self._active.values()]
        self._set_gauge(out)
        return out

    @staticmethod
    def _set_gauge(active: List[dict]) -> None:
        try:
            from ray_tpu_torch.util import metric_defs as _md

            g = _md.get("rtpu_alerts_active")
            by_sev: Dict[str, int] = {"warning": 0, "error": 0}
            for a in active:
                by_sev[a.get("severity", "warning")] = by_sev.get(
                    a.get("severity", "warning"), 0) + 1
            for sev, n in by_sev.items():
                g.set(n, tags={"severity": sev})
        except Exception:
            pass

    def active(self) -> List[dict]:
        with self._lock:
            return [dict(a) for a in self._active.values()]

    # -- thread --------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="alerts-watchdog")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                if not _is_head():
                    # node daemons share DriverRuntime (and this hook)
                    # but must not evaluate: their alert events would
                    # duplicate the head's per condition. The adapter
                    # attaches after __init__, so this is a per-tick
                    # check, not a start-time one.
                    continue
                self.evaluate_once()
            except Exception:
                pass


def _is_head() -> bool:
    """True for the process that should evaluate rules: the local-mode
    driver (no cluster) or the cluster head's driver — never a node
    daemon (its metrics reach the head on heartbeats)."""
    try:
        from ray_tpu_torch.core import runtime as _rt_mod

        rt = _rt_mod._runtime
        if rt is None:
            return False
        cluster = getattr(rt, "cluster", None)
        return cluster is None or bool(cluster.is_scheduler)
    except Exception:
        return False


_watchdog: Optional[Watchdog] = None


def start_watchdog() -> Optional[Watchdog]:
    """Start (once) the head-side watchdog thread; None when the plane
    is killed (``RTPU_ALERTS=0``)."""
    global _watchdog
    if not alerts_enabled():
        return None
    with _lock:
        if _watchdog is None:
            _watchdog = Watchdog()
            _watchdog.start()
        return _watchdog


def stop_watchdog() -> None:
    global _watchdog
    with _lock:
        wd = _watchdog
        _watchdog = None
    if wd is not None:
        wd.stop()


def active_alerts() -> List[dict]:
    """The raised-and-not-cleared alert list (empty when no watchdog)."""
    wd = _watchdog
    return wd.active() if wd is not None else []
