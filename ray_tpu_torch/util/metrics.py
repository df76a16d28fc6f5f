"""User metrics API: Counter/Gauge/Histogram + Prometheus text exposition
+ cluster-wide federation.

Role analog: ``python/ray/util/metrics.py`` over the reference's
OpenCensus pipeline (``src/ray/stats``) — a process-local registry with a
Prometheus text-format dump served by the dashboard-lite HTTP endpoint
(``_private/metrics_agent.py`` analog). Federation mirrors the reference's
agent pipeline shape: every process serializes its registry to plain
records and pushes *deltas* up one hop (worker -> driver over the control
pipe; node -> GCS on the heartbeat), so the head ``/metrics`` endpoint
exposes every process's samples as ONE Prometheus-scrapable target with
``node_id``/``worker_id``/``component`` origin labels.

Registration semantics (reference parity): re-creating a metric with an
existing name MERGES into the existing registration — both instances share
one backing store, so previously recorded samples are never orphaned.
Re-registering under a different metric type (or histogram boundaries)
raises.
"""

from __future__ import annotations

import bisect
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: Dict[str, "Metric"] = {}

# Collector hooks: callables run right before every registry snapshot
# (local exposition, worker delta push, node heartbeat payload), so
# sampled gauges — queue depths, table sizes, arena usage — are refreshed
# at read time instead of taxing every mutation on the hot path
# (reference: opencensus gauge-callback role). Hooks must be fast and
# never raise (exceptions are swallowed; a broken hook loses its samples,
# not the scrape).
_collectors_lock = threading.Lock()
_collectors: List = []


def register_collector(fn) -> None:
    with _collectors_lock:
        if fn not in _collectors:
            _collectors.append(fn)


def unregister_collector(fn) -> None:
    with _collectors_lock:
        try:
            _collectors.remove(fn)
        except ValueError:
            pass


def _run_collectors() -> None:
    with _collectors_lock:
        hooks = list(_collectors)
    for fn in hooks:
        try:
            fn()
        except Exception:
            pass


class Metric:
    metric_type = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()

    def _register(self) -> None:
        """Publish this metric, merging into an existing registration of
        the same name (see module docstring). Called by subclasses AFTER
        their sample storage exists, so merging can alias it."""
        with _registry_lock:
            existing = _registry.get(self.name)
            if existing is None or existing is self:
                _registry[self.name] = self
                return
            if existing.metric_type != self.metric_type:
                raise ValueError(
                    f"metric {self.name!r} already registered as "
                    f"{existing.metric_type}, cannot re-register as "
                    f"{self.metric_type}")
            self._merge_into(existing)

    def _merge_into(self, existing: "Metric") -> None:
        # share the lock; subclasses alias their sample storage too
        self._lock = existing._lock

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        merged = {**self._default_tags, **(tags or {})}
        return tuple(sorted(merged.items()))

    def _samples(self) -> List[Tuple[Tuple, float]]:
        raise NotImplementedError


class Counter(Metric):
    metric_type = "counter"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._values: Dict[Tuple, float] = {}
        self._register()

    def _merge_into(self, existing: "Metric") -> None:
        super()._merge_into(existing)
        self._values = existing._values

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        self._inc_key(self._key(tags), value)

    def _inc_key(self, k: Tuple, value: float = 1.0) -> None:
        """Pre-sorted-key fast path (hot-loop callers cache tag tuples)."""
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def _samples(self):
        with self._lock:
            return list(self._values.items())


class Gauge(Metric):
    metric_type = "gauge"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._values: Dict[Tuple, float] = {}
        self._register()

    def _merge_into(self, existing: "Metric") -> None:
        super()._merge_into(existing)
        self._values = existing._values

    def set(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[self._key(tags)] = float(value)

    def inc(self, value: float = 1.0, tags=None) -> None:
        k = self._key(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def dec(self, value: float = 1.0, tags=None) -> None:
        self.inc(-value, tags)

    def _samples(self):
        with self._lock:
            return list(self._values.items())


class Histogram(Metric):
    metric_type = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries or
                                 [0.001, 0.01, 0.1, 1, 10, 100, 1000])
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._totals: Dict[Tuple, int] = {}
        self._register()

    def _merge_into(self, existing: "Metric") -> None:
        if list(self.boundaries) != list(existing.boundaries):
            raise ValueError(
                f"histogram {self.name!r} already registered with "
                f"boundaries {existing.boundaries}, cannot re-register "
                f"with {self.boundaries}")
        super()._merge_into(existing)
        self._counts = existing._counts
        self._sums = existing._sums
        self._totals = existing._totals

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        self._observe_key(self._key(tags), value)

    def _observe_key(self, k: Tuple, value: float) -> None:
        """Pre-sorted-key fast path for hot-loop callers that cache their
        tag tuples (the task flight recorder observes several phases per
        task; re-merging/sorting the same one-tag dict each time is pure
        overhead there)."""
        with self._lock:
            self._observe_locked(k, value)

    def observe_many(self, items) -> None:
        """Batch observe of (pre-sorted-key, value) pairs under ONE lock
        acquisition — the flight recorder records ~7 phases per finished
        task from several reader threads at once; per-observe locking
        would bounce this lock thousands of times a second."""
        with self._lock:
            for k, value in items:
                self._observe_locked(k, value)

    def _observe_locked(self, k: Tuple, value: float) -> None:
        if k not in self._counts:
            self._counts[k] = [0] * (len(self.boundaries) + 1)
            self._sums[k] = 0.0
            self._totals[k] = 0
        idx = bisect.bisect_left(self.boundaries, value)
        self._counts[k][idx] += 1
        self._sums[k] += value
        self._totals[k] += 1

    def _samples(self):
        with self._lock:
            return [(k, (list(c), self._sums[k], self._totals[k]))
                    for k, c in self._counts.items()]


def _escape_label(v: str) -> str:
    # Prometheus text format: \ -> \\, " -> \", newline -> \n
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _fmt_tags(key: Tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
    return "{" + inner + "}"


# ----------------------------------------------------------------------
# plain-record form (what crosses process boundaries)
# ----------------------------------------------------------------------
#
# A record is a picklable dict:
#   {"name", "type", "desc", "samples", ["boundaries"]}
# with histogram sample values as (bucket_counts, sum, total) triples —
# exactly the in-registry shape, so export is a snapshot, not a transform.


def metric_record(m: Metric) -> Dict[str, Any]:
    rec: Dict[str, Any] = {"name": m.name, "type": m.metric_type,
                           "desc": m.description, "samples": m._samples()}
    if isinstance(m, Histogram):
        rec["boundaries"] = list(m.boundaries)
    return rec


def registry_records() -> List[Dict[str, Any]]:
    """Snapshot every registered metric as a plain record (running the
    sampled-gauge collector hooks first, so reads see fresh values)."""
    _run_collectors()
    with _registry_lock:
        metrics = list(_registry.values())
    return [metric_record(m) for m in metrics]


class DeltaExporter:
    """Ship only metrics whose samples changed since the last collect —
    the sender side of the federation push (reference metrics-agent delta
    exporter role). Cumulative values ride whole (receivers replace per
    metric name), so a lost push self-heals on the next change."""

    def __init__(self):
        self._fp: Dict[str, int] = {}

    def collect(self) -> List[Dict[str, Any]]:
        out = []
        for rec in registry_records():
            fp = hash(repr((rec["samples"], rec.get("boundaries"))))
            if self._fp.get(rec["name"]) != fp:
                self._fp[rec["name"]] = fp
                out.append(rec)
        return out


class FederationStore:
    """Receiver side: per-origin metric records with origin labels
    (worker_id / node_id / component), merged per metric name. Bounded by
    origin count; a re-pushed record replaces the previous one, so
    cumulative counters never double-count."""

    MAX_ORIGINS = 512

    def __init__(self):
        self._lock = threading.Lock()
        # origin -> {"labels": {...}, "records": {name: record}}
        self._origins: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()

    def ingest(self, origin: str, labels: Dict[str, str],
               records: List[Dict[str, Any]]) -> None:
        with self._lock:
            ent = self._origins.pop(origin, None)
            if ent is None:
                ent = {"labels": dict(labels), "records": {}}
            else:
                ent["labels"] = dict(labels)
            for rec in records:
                ent["records"][rec["name"]] = rec
            self._origins[origin] = ent
            while len(self._origins) > self.MAX_ORIGINS:
                self._origins.popitem(last=False)

    def export(self) -> List[Tuple[Dict[str, str], List[Dict[str, Any]]]]:
        """[(labels, records)] for every known origin (render/forward)."""
        with self._lock:
            return [(dict(e["labels"]), list(e["records"].values()))
                    for e in self._origins.values()]

    def clear(self) -> None:
        with self._lock:
            self._origins.clear()


#: process-wide store of remote-origin samples (driver: its workers;
#: daemon: its workers; head dashboard additionally pulls peers' via GCS)
federation = FederationStore()


def _render_scalar(lines: List[str], name: str, labels, samples) -> None:
    for key, val in samples:
        if labels:
            key = tuple(sorted({**dict(key), **labels}.items()))
        lines.append(f"{name}{_fmt_tags(key)} {val}")


def _render_histogram(lines: List[str], name: str, labels, boundaries,
                      samples) -> None:
    for key, (counts, total_sum, total) in samples:
        base = {**dict(key), **(labels or {})}
        cum = 0
        for b, c in zip(boundaries, counts):
            cum += c
            tags = dict(base)
            tags["le"] = repr(b)
            lines.append(
                f"{name}_bucket{_fmt_tags(tuple(sorted(tags.items())))} {cum}")
        tags = dict(base)
        tags["le"] = "+Inf"
        lines.append(
            f"{name}_bucket{_fmt_tags(tuple(sorted(tags.items())))} {total}")
        bkey = tuple(sorted(base.items()))
        lines.append(f"{name}_sum{_fmt_tags(bkey)} {total_sum}")
        lines.append(f"{name}_count{_fmt_tags(bkey)} {total}")


def prometheus_text(extra: Optional[List[Tuple[Dict[str, str],
                                               List[Dict[str, Any]]]]] = None
                    ) -> str:
    """Prometheus exposition of the local registry, plus optional remote
    origins (``extra``: [(origin_labels, records)]). Samples sharing a
    metric name are grouped under ONE HELP/TYPE header (the text format
    forbids repeating it); origin labels are merged into each remote
    sample's label set. Local samples stay unlabeled — single-process
    consumers see the exact pre-federation format."""
    groups: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()

    def add(labels, rec):
        g = groups.get(rec["name"])
        if g is None:
            groups[rec["name"]] = g = {"type": rec["type"],
                                       "desc": rec["desc"], "entries": []}
        elif g["type"] != rec["type"]:
            return  # cross-origin type conflict: keep the first seen
        g["entries"].append((labels, rec))

    for rec in registry_records():
        add(None, rec)
    for labels, recs in extra or ():
        for rec in recs:
            add(labels, rec)

    lines: List[str] = []
    for name, g in groups.items():
        lines.append(f"# HELP {name} {g['desc']}")
        lines.append(f"# TYPE {name} {g['type']}")
        for labels, rec in g["entries"]:
            if g["type"] == "histogram":
                _render_histogram(lines, name, labels,
                                  rec.get("boundaries") or [],
                                  rec["samples"])
            else:
                _render_scalar(lines, name, labels, rec["samples"])
    return "\n".join(lines) + "\n"


def registered(name: str) -> Optional[Metric]:
    """The currently registered instance for ``name`` (None if absent).
    Lets caches (metric_defs) notice a clear_registry and re-register."""
    return _registry.get(name)


def clear_registry() -> None:
    with _registry_lock:
        _registry.clear()
