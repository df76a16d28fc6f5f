"""Head-side lifecycle-event store (the receiver half of the event plane).

``util/events.py`` is the recording half: every process records
lifecycle events into its bounded ring; collection drains the rings over
the existing channels (worker control pipe, GCS heartbeat) into ONE of
these per head process, each event stamped with origin labels
(``node_id`` / ``worker_id`` / ``component``) — the exact shape the
TraceStore gives spans and the metrics federation gives samples.
Reference role: the event head's aggregated table behind the dashboard's
event view.

Appends carry an absolute sequence number so the cluster adapter can
ship deltas over the heartbeat with an acked cursor (the same
cursor+dedup contract the task/trace/profile pipelines use); eviction
past the cap silently advances the readable window.
"""

from __future__ import annotations

import threading
from collections import deque
from itertools import islice
from typing import Any, Dict, List, Optional, Tuple


class EventStore:
    """Bounded store of collected lifecycle events with origin labels."""

    def __init__(self, cap: Optional[int] = None):
        if cap is None:
            try:
                from ray_tpu_torch import config

                cap = int(config.get("event_store_max"))
            except Exception:
                cap = 16384
        self._lock = threading.Lock()
        self._dq: "deque[Dict[str, Any]]" = deque(maxlen=max(64, cap))
        self._total = 0  # events ever appended (absolute sequence)

    def ingest(self, events: List[Dict[str, Any]],
               labels: Optional[Dict[str, str]] = None) -> None:
        if not events:
            return
        with self._lock:
            for ev in events:
                if labels:
                    ev = dict(ev)
                    for k, v in labels.items():
                        ev.setdefault(k, v)
                self._dq.append(ev)
                self._total += 1

    def snapshot(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._dq)
        return out[-limit:] if limit else out

    def since(self, cursor: int, max_n: int = 1000
              ) -> Tuple[List[Dict[str, Any]], int]:
        """(batch, start) where ``start`` is the absolute index of
        batch[0] (>= cursor when eviction skipped events). Advance the
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
