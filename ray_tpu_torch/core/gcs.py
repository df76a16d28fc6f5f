"""Global control state: object directory, KV store, function/actor tables.

Role analog: reference GCS server (``src/ray/gcs/gcs_server``): InternalKV
(``gcs_kv_manager.h``), function table (``gcs_function_manager.h``), actor
table (``gcs_actor_manager.h``), plus the object directory the reference
keeps per-owner (``ownership_based_object_directory.h``). Single-node
round 1: in-process state guarded by locks; the narrow method surface is the
seam where a networked control plane slots in for multi-node.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ray_tpu_torch.core.ids import ActorID, ObjectID

PENDING = "PENDING"
READY = "READY"
ERROR = "ERROR"


class ObjectState:
    __slots__ = ("status", "inline", "error", "size")

    def __init__(self):
        self.status = PENDING
        self.inline: Optional[bytes] = None  # blob if stored inline
        self.error: Optional[bytes] = None  # serialized TaskError
        self.size = 0


class ActorInfo:
    __slots__ = (
        "actor_id", "name", "worker_id", "state", "create_spec",
        "max_restarts", "restarts", "pending_queue",
        "death_cause", "max_concurrency", "inflight",
    )

    def __init__(self, actor_id: ActorID, create_spec: dict):
        self.actor_id = actor_id
        self.name = create_spec.get("name") or ""
        self.worker_id = None
        self.state = "PENDING"  # PENDING | ALIVE | RESTARTING | DEAD
        self.create_spec = create_spec
        self.max_restarts = create_spec.get("max_restarts", 0)
        self.restarts = 0
        self.pending_queue: List[dict] = []
        self.death_cause = ""
        self.max_concurrency = create_spec.get("max_concurrency", 1)
        self.inflight = 0


class _Waiter:
    __slots__ = ("ids", "num_needed", "callback", "fired", "include_errors")

    def __init__(self, ids, num_needed, callback):
        self.ids: Set[ObjectID] = set(ids)
        self.num_needed = num_needed
        self.callback = callback
        self.fired = False


class Gcs:
    def __init__(self):
        self.lock = threading.RLock()
        self.kv: Dict[str, Dict[str, bytes]] = {}  # namespace -> {key: val}
        self.functions: Dict[str, bytes] = {}
        self.objects: Dict[ObjectID, ObjectState] = {}
        self.actors: Dict[ActorID, ActorInfo] = {}
        self.named_actors: Dict[str, ActorID] = {}
        self._obj_waiters: Dict[ObjectID, List[_Waiter]] = {}
        self._cv = threading.Condition(self.lock)
        # terminal-event log for blocking waits: each waiter replays only
        # the events since its last wake instead of rescanning its whole
        # id set per wake (the rescan was O(n^2) — 4M hash lookups for a
        # 2000-task get). Appended only while waiters exist; compacted to
        # the minimum live cursor so one stuck waiter cannot make the log
        # grow with every completion system-wide. _term_base is the global
        # sequence number of _term_events[0].
        self._term_events: List[ObjectID] = []
        self._term_base = 0
        self._wait_cursors: Dict[int, int] = {}  # waiter token -> seq
        self._wait_token = 0
        self._wait_count = 0
        # Cluster-mode hooks (set by the cluster adapter): called AFTER an
        # object turns terminal locally so the global directory learns about
        # it. Must be non-blocking (they cast over a socket).
        self.on_object_ready: Optional[Callable[[ObjectID, Optional[bytes], int], None]] = None
        self.on_object_error: Optional[Callable[[ObjectID, bytes], None]] = None
        # Fired on EVERY terminal transition (local or delivered), the one
        # choke point all completion paths share — the runtime releases
        # task-argument reference pins here.
        self.on_terminal: Optional[Callable[[ObjectID], None]] = None

    def _compact_term_events_locked(self) -> None:
        if len(self._term_events) < 4096 or not self._wait_cursors:
            return
        low = min(self._wait_cursors.values())
        drop = low - self._term_base
        if drop > 0:
            del self._term_events[:drop]
            self._term_base = low

    # -- function table ---------------------------------------------------

    def register_fn(self, h: str, blob: bytes) -> None:
        with self.lock:
            self.functions.setdefault(h, blob)

    def get_fn(self, h: str) -> Optional[bytes]:
        with self.lock:
            return self.functions.get(h)

    # -- KV ---------------------------------------------------------------

    def kv_put(self, key: str, value: bytes, namespace: str = "default", overwrite: bool = True) -> bool:
        with self.lock:
            ns = self.kv.setdefault(namespace, {})
            if not overwrite and key in ns:
                return False
            ns[key] = value
            return True

    def kv_get(self, key: str, namespace: str = "default") -> Optional[bytes]:
        with self.lock:
            return self.kv.get(namespace, {}).get(key)

    def kv_del(self, key: str, namespace: str = "default") -> bool:
        with self.lock:
            return self.kv.get(namespace, {}).pop(key, None) is not None

    def kv_keys(self, prefix: str = "", namespace: str = "default") -> List[str]:
        with self.lock:
            return [k for k in self.kv.get(namespace, {}) if k.startswith(prefix)]

    # -- object directory -------------------------------------------------

    def ensure_object(self, obj_id: ObjectID) -> ObjectState:
        with self.lock:
            st = self.objects.get(obj_id)
            if st is None:
                st = ObjectState()
                self.objects[obj_id] = st
            return st

    def mark_ready(self, obj_id: ObjectID, inline: Optional[bytes] = None,
                   size: int = 0, _local_only: bool = False) -> None:
        with self.lock:
            st = self.ensure_object(obj_id)
            if st.status == ERROR:
                return  # terminal states never downgrade (e.g. cancellation)
            st.status = READY
            st.inline = inline
            st.size = size or (len(inline) if inline else 0)
            if self._wait_count:
                self._term_events.append(obj_id)
            self._fire_waiters(obj_id)
            self._cv.notify_all()
        if self.on_object_ready is not None and not _local_only:
            self.on_object_ready(obj_id, inline, st.size)
        if self.on_terminal is not None:
            self.on_terminal(obj_id)

    def mark_error(self, obj_id: ObjectID, err_blob: bytes,
                   _local_only: bool = False) -> None:
        with self.lock:
            st = self.ensure_object(obj_id)
            st.status = ERROR
            st.error = err_blob
            if self._wait_count:
                self._term_events.append(obj_id)
            self._fire_waiters(obj_id)
            self._cv.notify_all()
        if self.on_object_error is not None and not _local_only:
            self.on_object_error(obj_id, err_blob)
        if self.on_terminal is not None:
            self.on_terminal(obj_id)

    def object_state(self, obj_id: ObjectID) -> Optional[ObjectState]:
        with self.lock:
            return self.objects.get(obj_id)

    def drop_object(self, obj_id: ObjectID) -> None:
        with self.lock:
            self.objects.pop(obj_id, None)

    def reset_object(self, obj_id: ObjectID) -> None:
        """Back to PENDING for lineage re-execution of a lost object."""
        with self.lock:
            st = self.ensure_object(obj_id)
            st.status = PENDING
            st.inline = None
            st.error = None

    def _fire_waiters(self, obj_id: ObjectID) -> None:
        # caller holds lock
        waiters = self._obj_waiters.pop(obj_id, [])
        for w in waiters:
            if w.fired:
                continue
            w.ids.discard(obj_id)
            w.num_needed -= 1
            if w.num_needed <= 0:
                w.fired = True
                for other in w.ids:
                    lst = self._obj_waiters.get(other)
                    if lst and w in lst:
                        lst.remove(w)
                cb = w.callback
                threading.Thread(target=cb, daemon=True).start()

    def add_waiter(self, ids: List[ObjectID], num_needed: int, callback: Callable[[], None]):
        """Invoke ``callback`` (on a fresh thread) once ``num_needed`` of
        ``ids`` are terminal (READY or ERROR). Fires immediately if already
        satisfied. Returns the waiter (or None if fired) so callers with a
        timeout can ``cancel_waiter`` it."""
        with self.lock:
            pending = []
            done = 0
            for i in ids:
                st = self.objects.get(i)
                if st is not None and st.status in (READY, ERROR):
                    done += 1
                else:
                    self.ensure_object(i)
                    pending.append(i)
            if done >= num_needed:
                threading.Thread(target=callback, daemon=True).start()
                return None
            w = _Waiter(pending, num_needed - done, callback)
            for i in pending:
                self._obj_waiters.setdefault(i, []).append(w)
            return w

    def cancel_waiter(self, w) -> None:
        if w is None:
            return
        with self.lock:
            if w.fired:
                return
            w.fired = True
            for i in w.ids:
                lst = self._obj_waiters.get(i)
                if lst and w in lst:
                    lst.remove(w)
                    if not lst:
                        del self._obj_waiters[i]

    def wait_objects(
        self, ids: List[ObjectID], num_returns: int, timeout: Optional[float]
    ) -> Tuple[List[ObjectID], List[ObjectID]]:
        """Blocking wait (driver-side fast path).

        One full scan up front, then each wake replays only the terminal
        events logged since the previous wake — total work O(ids +
        completions), not O(ids x wakes). ``ready`` preserves the caller's
        id order for the initial scan and completion order after (matches
        the reference's wait semantics)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            ready = []
            pending: Dict[ObjectID, int] = {}  # id -> multiplicity
            for i in ids:
                st = self.objects.get(i)
                if st is not None and st.status in (READY, ERROR):
                    ready.append(i)
                else:
                    pending[i] = pending.get(i, 0) + 1
            self._wait_count += 1
            self._wait_token += 1
            token = self._wait_token
            cursor = self._term_base + len(self._term_events)
            self._wait_cursors[token] = cursor
            try:
                while True:
                    if len(ready) >= num_returns:
                        ready = ready[:num_returns]
                        rs = set(ready)
                        return ready, [i for i in ids if i not in rs]
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            rs = set(ready)
                            return ready, [i for i in ids if i not in rs]
                        self._cv.wait(remaining)
                    else:
                        self._cv.wait(5.0)
                    evs = self._term_events
                    end = self._term_base + len(evs)
                    for k in range(cursor - self._term_base,
                                   len(evs)):
                        oid = evs[k]
                        n = pending.pop(oid, 0)
                        if n:
                            ready.extend([oid] * n)
                    cursor = end
                    self._wait_cursors[token] = cursor
                    self._compact_term_events_locked()
            finally:
                self._wait_count -= 1
                self._wait_cursors.pop(token, None)
                if self._wait_count == 0:
                    self._term_events.clear()
                    self._term_base = 0

    # -- actor table ------------------------------------------------------

    def register_actor(self, info: ActorInfo) -> None:
        with self.lock:
            self.actors[info.actor_id] = info
            if info.name:
                if info.name in self.named_actors:
                    raise ValueError(f"actor name {info.name!r} already taken")
                self.named_actors[info.name] = info.actor_id

    def get_actor(self, actor_id: ActorID) -> Optional[ActorInfo]:
        with self.lock:
            return self.actors.get(actor_id)

    def lookup_named(self, name: str) -> Optional[ActorID]:
        with self.lock:
            return self.named_actors.get(name)

    # -- state-API accessors (reference GcsTaskManager/table dumps) -------

    def all_actors(self) -> List["ActorInfo"]:
        with self.lock:
            return list(self.actors.values())

    def all_objects(self):
        with self.lock:
            return list(self.objects.items())

    def mark_actor_dead(self, actor_id: ActorID, cause: str) -> None:
        with self.lock:
            info = self.actors.get(actor_id)
            if info:
                info.state = "DEAD"
                info.death_cause = cause
                if info.name:
                    self.named_actors.pop(info.name, None)
