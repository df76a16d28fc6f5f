"""Worker process: task execution loop + worker-side runtime client.

Role analog: reference worker main loop (``python/ray/_private/workers/
default_worker.py`` + ``_raylet.pyx:2251 task_execution_handler``). One
worker executes one task at a time; while executing, nested API calls
(``get``/``put``/``remote``/actor calls) flow over the same control pipe to
the driver as request/reply or one-way casts.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import cloudpickle

from ray_tpu_torch.core import serialization, task_spec as ts
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    TaskError,
)
from ray_tpu_torch.core.ids import ActorID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_ref import ObjectRef, collect_serialized_refs
from ray_tpu_torch.core.object_store import INLINE_THRESHOLD, StoreClient

# sentinel for request() timeouts (None is a legitimate reply payload)
_TIMEOUT = object()


class WorkerRuntime:
    """Runtime interface bound inside a worker process (see runtime.py for
    the driver-side twin; both expose the same narrow surface)."""

    is_driver = False

    def __init__(self, conn, session: str, worker_id: bytes):
        import queue

        self.conn = conn
        self.session = session
        self.worker_id = WorkerID(worker_id)
        self.store = StoreClient(session)
        self.fn_cache: Dict[str, Any] = {}
        self.registered_fns: set = set()
        self.actors: Dict[bytes, Any] = {}
        self.actor_concurrency: Dict[bytes, int] = {}
        self._actor_pools: Dict[bytes, Any] = {}  # ThreadPoolExecutor
        # async actors: one persistent event loop per actor — concurrent
        # calls are coroutines on THAT loop, interleaving at awaits
        # (reference fiber semantics, src/ray/core_worker/fiber.h)
        self._actor_loops: Dict[bytes, Any] = {}
        # cooperative cancel: task_id -> thread ident / asyncio future
        self._running_threads: Dict[bytes, int] = {}
        self._running_futs: Dict[bytes, Any] = {}
        self._running_lock = threading.Lock()
        # chunked-pull alignment hints (oid -> (stride, payload_bytes)):
        # the pull runs in the HOSTING runtime (driver/daemon), so get()
        # forwards these on the wire — a worker-local registry would
        # never be seen by the process that actually fetches (ISSUE 13)
        self._pull_aligns: Dict[bytes, tuple] = {}
        self._req_counter = itertools.count()
        self._send_lock = threading.Lock()
        # Control-message coalescing (r13, ROADMAP item 1): fire-and-forget
        # casts buffer here and ship as ONE framed batch — flushed by a
        # Nagle-style window thread (RTPU_PIPE_COALESCE_US) or piggybacked
        # onto the next latency-sensitive send (done/req/ready), whichever
        # comes first. This is what turns the multi-client shape's ~5 pipe
        # messages/task (submit cast + refpin transitions + get machinery)
        # into ~2 frames/task of driver-side receive work.
        from collections import deque as _cast_deque

        self._cast_q: "_cast_deque" = _cast_deque()
        # packed refpin transitions awaiting the same Nagle flush (the
        # r13 pickled path buffered them inside _cast_q; the r14 packed
        # path must keep that cadence or every 0<->1 transition pays its
        # own frame + syscall)
        self._refpin_buf: list = []
        self._cast_q_lock = threading.Lock()
        self._flush_ev = threading.Event()
        self._flusher_started = False
        self._coalesce_s: Optional[float] = None
        # serializes the rate-limited telemetry pushes: they run from the
        # main loop AND from compiled-DAG exec loops (see push_telemetry)
        self._push_lock = threading.Lock()
        # Borrowed-reference tracking (reference reference_count.h:61
        # "borrower" role): live ObjectRef instances in THIS worker pin the
        # object at the driver (which aggregates into node-level pins at
        # the cluster directory). Only 0<->1 transitions cross the pipe.
        self._refs_lock = threading.Lock()
        self._ref_counts: Dict[bytes, int] = {}
        # GC-safety (advisor r3): the __del__ hook may fire at any
        # allocation point, including on a thread already holding
        # _refs_lock or _send_lock — it must take no locks and do no IO.
        # It only appends (deque.append is atomic); normal code paths
        # drain. Pin casts are queued under _refs_lock (order-preserving)
        # and shipped outside it. Shared machinery: core/refqueue.py.
        from ray_tpu_torch.core.refqueue import DeferredDrops, OrderedCastFlusher

        # batch mode: one "refpins" cast per drain instead of one pipe
        # message per 0<->1 transition (r13 control-message coalescing).
        # With the native driver engine (r14) the batch ships as a PACKED
        # binary frame the driver's C++ receiver applies off the GIL.
        self._ref_casts = OrderedCastFlusher(self._ship_refpins, batch=True)
        self._refpin_packed: Optional[bool] = None
        # store pins to drop once outside _refs_lock (see
        # _apply_ref_drop_locked); deque: append/popleft are atomic
        from collections import deque as _deque

        self._pending_pin_releases: "_deque" = _deque()
        self._deferred_ref_drops = DeferredDrops(
            self._refs_lock, self._apply_ref_drop_locked,
            self._after_ref_drops)
        from ray_tpu_torch.core import object_ref as _object_ref

        _object_ref.set_ref_hook(self._ref_added,
                                 self._deferred_ref_drops.append)
        # Demuxed transport: exactly ONE thread reads the pipe and routes
        # replies to the issuing thread. This lets ANY thread in the worker
        # (the task thread, a train-session thread, a user thread) make
        # runtime calls (get/put/remote) without racing the main loop for
        # messages.
        self._exec_queue: "queue.Queue" = queue.Queue()
        self._reply_lock = threading.Lock()
        self._replies: Dict[int, Any] = {}
        self._reply_events: Dict[int, threading.Event] = {}
        self._recv_started = False
        # context of the currently running task — thread-local because
        # concurrent actors (max_concurrency > 1) execute methods on pool
        # threads and must not see each other's ids
        self._task_ctx = threading.local()
        # metrics federation (sender side): this process's registry —
        # built-ins below plus any user metrics tasks create — is pushed
        # to the driver as batched DELTAS over the existing pipe, never
        # per-call; see _maybe_push_metrics
        self._metrics_exporter = None
        self._metrics_last_push = 0.0
        self._metrics_interval: Optional[float] = None
        self._wmetrics = None
        # trace plane (sender side): finished spans accumulate in this
        # process's bounded ring and ride the pipe as batched casts,
        # rate-limited like the metric delta push
        self._trace_last_push = 0.0
        self._trace_interval: Optional[float] = None
        # profiling plane (sender side): the sampler's aggregated window
        # rides the pipe as batched casts on the same cadence pattern
        self._profile_last_push = 0.0
        self._profile_interval: Optional[float] = None
        # event plane (sender side): lifecycle events ride the pipe as
        # batched casts on the same cadence pattern (events are rare —
        # the interval only bounds the batching delay)
        self._event_last_push = 0.0
        self._event_interval: Optional[float] = None
        # device plane (sender side): compiled-program registry snapshots
        # ride the pipe as casts, version-gated — nothing ships unless a
        # compile/retrace bumped the registry since the last push
        self._device_last_push = 0.0
        self._device_interval: Optional[float] = None
        self._device_version_shipped = 0
        try:
            from ray_tpu_torch import config as _cfg

            self._flight_enabled = bool(_cfg.get("flight_recorder"))
        except Exception:
            self._flight_enabled = True

    @property
    def labels(self) -> Dict[str, str]:
        """This node's labels (propagated by the spawner via env)."""
        from ray_tpu_torch.util.labels import parse_labels

        return parse_labels(os.environ.get("RTPU_NODE_LABELS", ""))

    @property
    def current_task_id(self) -> Optional[TaskID]:
        return getattr(self._task_ctx, "task_id", None)

    @current_task_id.setter
    def current_task_id(self, value: Optional[TaskID]) -> None:
        self._task_ctx.task_id = value

    @property
    def current_actor_id(self) -> Optional[ActorID]:
        return getattr(self._task_ctx, "actor_id", None)

    @current_actor_id.setter
    def current_actor_id(self, value: Optional[ActorID]) -> None:
        self._task_ctx.actor_id = value

    # -- transport --------------------------------------------------------

    def _dropped(self, msg) -> bool:
        """THE chaos filter for worker->driver messages — every egress
        path (deferred cast, piggyback, urgent) funnels each message
        through this single ``worker.pipe.send`` site."""
        from ray_tpu_torch.util import failpoints

        return failpoints.hit("worker.pipe.send", msg[0])

    def _coalesce_window(self) -> float:
        if self._coalesce_s is None:
            try:
                from ray_tpu_torch import config as _cfg

                self._coalesce_s = max(
                    0.0, int(_cfg.get("pipe_coalesce_us")) / 1e6)
            except Exception:
                self._coalesce_s = 0.0
        return self._coalesce_s

    def _send_frame(self, msg=None) -> None:
        """Ship pending casts (+ optionally ``msg``) as ONE frame.
        Drain happens under the send lock, so frame order matches global
        issue order — a cast enqueued before a done/req can never be
        observed after it. Buffered packed refpins go out FIRST (a +1
        borrow must reach the driver before the done that releases the
        matching arg pin), in their own binary frame."""
        import struct as _struct

        with self._send_lock:
            with self._cast_q_lock:
                if self._cast_q:
                    batch = list(self._cast_q)
                    self._cast_q.clear()
                else:
                    batch = []
                pins = self._refpin_buf
                if pins:
                    self._refpin_buf = []
            if pins:
                self.conn.send_bytes(b"RTP1" + b"".join(
                    _struct.pack("<16sb", oid_b, d) for oid_b, d in pins))
            if msg is not None:
                batch.append(msg)
            if not batch:
                return
            self.conn.send(batch[0] if len(batch) == 1
                           else ("batch", batch))

    def _send(self, msg):
        """Latency-sensitive send (done/req/ready/reply): goes out NOW,
        piggybacking any buffered casts in the same frame."""
        if self._dropped(msg):
            return  # chaos: drop this worker->driver control message
        self._send_frame(msg)

    def cast(self, op: str, *args):
        """Fire-and-forget cast: buffered for the coalescing window (or
        the next urgent send), then shipped in a batch frame."""
        msg = ("cast", op, args)
        if self._dropped(msg):
            return
        if self._coalesce_window() <= 0:
            self._send_frame(msg)
            return
        with self._cast_q_lock:
            self._cast_q.append(msg)
        if not self._flusher_started:
            self._start_cast_flusher()
        self._flush_ev.set()

    def _start_cast_flusher(self) -> None:
        with self._cast_q_lock:
            if self._flusher_started:
                return
            self._flusher_started = True
        t = threading.Thread(target=self._cast_flusher_loop, daemon=True,
                             name="rtpu_cast_flusher")
        t.start()

    def _cast_flusher_loop(self) -> None:
        """The Nagle window: after the first buffered cast, wait
        ``RTPU_PIPE_COALESCE_US`` for more to accumulate, then flush them
        as one frame (unless an urgent send piggybacked them first)."""
        from ray_tpu_torch.util import profiling

        while True:
            self._flush_ev.wait()
            self._flush_ev.clear()
            profiling.idle_sleep(self._coalesce_window())
            try:
                self._send_frame()
            except (OSError, BrokenPipeError):
                return  # pipe gone: the recv loop exits the process

    def _ship_refpins(self, items) -> None:
        """Ship one drained batch of borrow transitions. Packed wire form
        ("RTP1" + (id[16] + i8)*) when the native-pipe plane is on — the
        driver applies it without touching the interpreter (its Python
        fallback reader parses the same frame); else the r13 pickled
        ``refpins`` cast. Either way the transitions ride the SAME Nagle
        cadence as ordinary casts (a frame per 0<->1 transition would
        triple the multi-client frames/task)."""
        if self._refpin_packed is None:
            try:
                from ray_tpu_torch import config as _cfg

                self._refpin_packed = bool(_cfg.get("native_pipe"))
            except Exception:
                self._refpin_packed = False
        if not self._refpin_packed:
            self.cast("refpins", items)
            return
        # the ONE worker->driver chaos filter covers this egress too
        if self._dropped(("cast", "refpins", (items,))):
            return
        with self._cast_q_lock:
            self._refpin_buf.extend(items)
        if self._coalesce_window() <= 0:
            self._send_frame()
            return
        if not self._flusher_started:
            self._start_cast_flusher()
        self._flush_ev.set()

    def _ref_added(self, oid_b: bytes) -> None:
        with self._refs_lock:
            before = self._ref_counts.get(oid_b, 0)
            self._ref_counts[oid_b] = before + 1
            if before == 0:
                self._ref_casts.append((oid_b, 1))
        self._ref_casts.flush()
        self._drain_ref_drops()

    def _apply_ref_drop_locked(self, b: bytes) -> None:
        n = self._ref_counts.get(b, 0) - 1
        if n > 0:
            self._ref_counts[b] = n
        else:
            self._ref_counts.pop(b, None)
            if n == 0:
                self._ref_casts.append((b, -1))
                # local refcount hit zero: this process's store pin must
                # drop too (release() keeps it if zero-copy views are
                # still alive), or a free()d arena object stays kDeleting
                # forever on our reader ref and its memory never returns
                self._pending_pin_releases.append(b)

    def _after_ref_drops(self) -> None:
        self._ref_casts.flush()
        while True:
            try:
                # graftlint: disable=unguarded-shared-write -- deque ops are
                # GIL-atomic; drain is deliberately lock-free (refqueue.py:
                # __del__ hooks must take no locks)
                b = self._pending_pin_releases.popleft()
            except IndexError:
                return
            try:
                self.store.release(ObjectID(b))
            except Exception:
                pass

    def _drain_ref_drops(self) -> None:
        """Apply ref drops queued by ObjectRef.__del__ (which cannot lock)."""
        self._deferred_ref_drops.drain()

    def _start_receiver(self):
        if self._recv_started:
            return
        self._recv_started = True
        t = threading.Thread(target=self._recv_loop, daemon=True,
                             name="rtpu_worker_recv")
        t.start()

    def _recv_loop(self):
        import pickle as _pickle

        while True:
            try:
                buf = self.conn.recv_bytes()
            except (EOFError, OSError):
                os._exit(0)
            if buf[:4] == b"RTB1":
                # native-coalesced driver frame: magic + u32be count +
                # (u32be len + pickle)* — the GIL-free sender packs every
                # message queued during the previous write into one frame
                n = int.from_bytes(buf[4:8], "big")
                off = 8
                for _ in range(n):
                    ln = int.from_bytes(buf[off:off + 4], "big")
                    off += 4
                    self._dispatch_recv(_pickle.loads(buf[off:off + ln]))
                    off += ln
                continue
            # no "batch" unwrap here: driver->worker coalescing is the
            # native RTB1 frame above — only the worker->driver direction
            # ships ("batch", [...]) tuples (pipe-protocol-sync)
            self._dispatch_recv(_pickle.loads(buf))

    def _dispatch_recv(self, msg):
        kind = msg[0]
        if kind == "exec":
            self._exec_queue.put(msg[1])
        elif kind == "cancel":
            self._deliver_cancel(msg[1])
        elif kind == "reply":
            req_id = msg[1]
            with self._reply_lock:
                ev = self._reply_events.pop(req_id, None)
                if ev is not None:   # drop replies nobody awaits
                    self._replies[req_id] = (msg[2], msg[3])
            if ev is not None:
                ev.set()
        elif kind == "fp":
            # chaos plane: driver-pushed failpoint arm/disarm
            from ray_tpu_torch.util import failpoints

            if msg[1] is None:
                failpoints.clear()
            else:
                try:
                    failpoints.apply_spec(msg[1])
                except ValueError:
                    pass
        elif kind == "trace":
            # trace plane: driver-pushed mid-session arm/disarm —
            # workers spawned before enable_tracing() learn here
            from ray_tpu_torch.util import tracing

            if msg[1] is not None:
                tracing.apply_remote(msg[1])
                if not msg[1].get("enabled"):
                    # disarm: ship the ring's tail NOW — the push
                    # loop stops looking once tracing is off, and
                    # the last interval's spans (the end of the
                    # traced workload) must not strand here
                    self._push_spans_now()
        elif kind == "prof":
            # profiling plane: driver-pushed mid-session arm/disarm —
            # apply_remote starts/stops this process's sampler
            from ray_tpu_torch.util import profiling

            if msg[1] is not None:
                profiling.apply_remote(msg[1])
                if not msg[1].get("enabled"):
                    # disarm: ship the table's tail NOW (the push
                    # loop stops looking once profiling is off)
                    self._push_profile_now()
        elif kind == "events":
            # event plane: driver-pushed mid-session arm/disarm —
            # workers spawned before an enable/disable_events() flip
            # learn here
            from ray_tpu_torch.util import events

            if msg[1] is not None:
                events.apply_remote(msg[1])
                if not msg[1].get("enabled"):
                    # disarm: ship the ring's tail NOW (the push
                    # loop stops looking once events are off)
                    self._push_events_now()
        elif kind == "stackdump":
            # live stack request (`ray_tpu_torch stack` py-spy role): walk
            # sys._current_frames on THIS receiver thread (pure
            # frame-graph reads, no locks) and cast the reply back
            from ray_tpu_torch.util import profiling

            try:
                self.cast("stacks", profiling.current_stacks())
            except Exception:
                pass
        elif kind == "shutdown":
            os._exit(0)

    def request(self, op: str, *args, timeout: Optional[float] = None):
        """Request/reply over the pipe. Returns the payload, or the
        ``_TIMEOUT`` sentinel when ``timeout`` expires first."""
        import time as _time

        req_id = next(self._req_counter)
        ev = threading.Event()
        with self._reply_lock:
            self._reply_events[req_id] = ev
        deadline = None if timeout is None else _time.monotonic() + timeout
        try:
            self._send(("req", req_id, op, args))
            # polled wait, not a bare ev.wait(): an injected cancellation
            # (PyThreadState_SetAsyncExc) can only be delivered while this
            # thread executes bytecode — a C-level block would pin a
            # cancelled task forever (e.g. a backpressured producer whose
            # consumer went away)
            while not ev.wait(0.5):
                if deadline is not None and _time.monotonic() > deadline:
                    with self._reply_lock:
                        self._reply_events.pop(req_id, None)
                        self._replies.pop(req_id, None)
                    return _TIMEOUT
        except BaseException:
            # interrupted (cancel injection): a late reply must not leak
            # into self._replies forever
            with self._reply_lock:
                self._reply_events.pop(req_id, None)
                self._replies.pop(req_id, None)
            raise
        with self._reply_lock:
            status, payload = self._replies.pop(req_id)
        if status == "err":
            raise cloudpickle.loads(payload)
        return payload

    # -- object API -------------------------------------------------------

    def put(self, value: Any) -> ObjectRef:
        obj_id = ObjectID.from_random()
        # refs nested inside the value transfer to the stored object's
        # lifetime (owner pins them until the outer object is freed) — a
        # borrower dropping its local refs must not strand the consumer
        # (advisor r3: results/puts previously leaked this pin)
        with collect_serialized_refs() as nested:
            inline, size = self.store.put(obj_id, value)
        # creation call-site for `ray_tpu_torch memory` forensics rides the
        # existing cast, captured only while the profiler is armed
        from ray_tpu_torch.util import profiling

        site = (profiling.caller_site()
                if profiling.profiling_enabled() else None)
        if site is None:
            self.cast("put", obj_id.binary(), inline, size,
                      list(nested) or None)
        else:
            self.cast("put", obj_id.binary(), inline, size,
                      list(nested) or None, site)
        return ObjectRef(obj_id)

    def put_parts(self, data: bytes, buffers) -> ObjectRef:
        obj_id = ObjectID.from_random()
        inline, size = self.store.put_parts(obj_id, data, buffers)
        self.cast("put", obj_id.binary(), inline, size)
        return ObjectRef(obj_id)

    def hint_pull_align(self, oid_b: bytes, stride: int,
                        payload_bytes: int = 0) -> None:
        """Register a chunk-alignment (stride, payload-size) hint for
        ``oid_b``'s next get (consumed by the hosting runtime's chunked
        cross-node pull — records start after the serialized header)."""
        if stride > 1 and len(self._pull_aligns) < 4096:
            self._pull_aligns[bytes(oid_b)] = (int(stride),
                                               int(payload_bytes))

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None):
        ids = [r.id.binary() for r in refs]
        # pop-with-default: two task threads getting the same hinted
        # ref must not race a bare pop into a KeyError
        aligns = {i: h for i in ids
                  if (h := self._pull_aligns.pop(i, None)) is not None}
        self.cast("blocked")
        try:
            if aligns:
                results = self.request("get", ids, timeout, aligns)
            else:
                results = self.request("get", ids, timeout)
        finally:
            self.cast("unblocked")
        if results is None:
            raise GetTimeoutError(f"get timed out after {timeout}s on {refs}")
        out = []
        for (kind, payload), r in zip(results, refs):
            if kind == "i":
                out.append(serialization.loads_oob(payload))
            elif kind == "s":
                out.append(self._store_get_with_recovery(r.id))
            else:
                raise cloudpickle.loads(payload)
        return out

    def wait(self, refs, num_returns, timeout, fetch_local=True):
        ids = [r.id.binary() for r in refs]
        self.cast("blocked")
        try:
            ready, rest = self.request("wait", ids, num_returns, timeout)
        finally:
            self.cast("unblocked")
        by_id = {r.id.binary(): r for r in refs}
        return [by_id[i] for i in ready], [by_id[i] for i in rest]

    # -- task/actor submission -------------------------------------------

    def ensure_fn(self, h: str, blob: bytes):
        if h not in self.registered_fns:
            self.cast("fn_put", h, blob)
            self.registered_fns.add(h)

    def _stamp_trace(self, spec: dict, kind: str) -> None:
        """Nested submissions join the ENCLOSING task's trace: the spec
        carries this worker's active span context so the driver-side
        handling and the eventual execute span parent here, not in a
        fresh trace (reference tracing_helper nested-call propagation)."""
        from ray_tpu_torch.util import tracing

        if not tracing.tracing_enabled():
            return
        name = spec.get("name") or spec.get("method") or "task"
        with tracing.span(f"submit::{name}",
                          {"task_id": spec["task_id"].hex(),
                           "nested": True}) as tp:
            spec["trace_ctx"] = tp

    def submit(self, spec: dict) -> List[ObjectRef]:
        self._stamp_trace(spec, "task")
        self.cast("submit", spec)
        tid = TaskID(spec["task_id"])
        return [ObjectRef(ObjectID(b), task_id=tid) for b in spec["return_ids"]]

    def create_actor(self, spec: dict):
        self.request("actor_create", spec)

    def submit_actor_task(self, spec: dict) -> List[ObjectRef]:
        self._stamp_trace(spec, "actor_call")
        self.cast("actor_call", spec)
        return [ObjectRef(ObjectID(b)) for b in spec["return_ids"]]

    def kill_actor(self, actor_id: bytes, no_restart: bool = True):
        self.cast("kill_actor", actor_id, no_restart)

    def cancel(self, ref: ObjectRef, force: bool = False):
        self.cast("cancel", ref.id.binary(), force)

    def lookup_named_actor(self, name: str):
        return self.request("name_lookup", name)

    def actor_queue_depths(self, actor_ids):
        return self.request("actor_depths", actor_ids)

    def create_placement_group(self, bundles, strategy: str) -> bytes:
        return self.request("pg_create", bundles, strategy)

    def remove_placement_group(self, pg_id: bytes):
        self.request("pg_remove", pg_id)

    def kv_op(self, op: str, *args):
        return self.request("kv", op, *args)

    def resources(self, which: str) -> Dict[str, float]:
        return self.request("resources", which)

    def node_info(self):
        return self.request("nodes")

    def free(self, ids: List[bytes]):
        # the caller asserts the objects are fully consumed: drop OUR store
        # pin first (view-liveness guarded), then let the driver delete —
        # otherwise the arena entry waits on this process's reader ref,
        # which leaks outright if this worker is killed before idle-drain
        for b in ids:
            try:
                self.store.release(ObjectID(b))
            except Exception:
                pass
        self.cast("free", ids)

    # -- cooperative cancellation ----------------------------------------

    def _deliver_cancel(self, task_id: bytes):
        """Interrupt the task if it is running HERE (reference
        ``execute_task_with_cancellation_handler``, ``_raylet.pyx:2084``).

        Sync tasks get ``TaskCancelledError`` injected into their thread
        via ``PyThreadState_SetAsyncExc`` (lands at the next bytecode
        boundary — blocking syscalls finish first); async actor calls get
        their asyncio future cancelled, which interrupts at the next
        await."""
        from ray_tpu_torch.core.exceptions import TaskCancelledError

        with self._running_lock:
            fut = self._running_futs.get(task_id)
            # re-read under the lock at injection time: if the task already
            # finished, its entry is gone and we must NOT inject into a
            # thread that has moved on (main loop / another task) — a small
            # check->inject window remains, which main_loop's cancel guard
            # absorbs
            tident = self._running_threads.get(task_id)
            if fut is not None:
                fut.cancel()
                return
            if tident is None:
                return
            import ctypes

            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(tident), ctypes.py_object(TaskCancelledError))

    # -- execution --------------------------------------------------------

    def _resolve_fn(self, h: str):
        fn = self.fn_cache.get(h)
        if fn is None:
            blob = self.request("fn_get", h)
            if blob is None:
                raise RuntimeError(f"function {h} not found in GCS")
            fn = cloudpickle.loads(blob)
            self.fn_cache[h] = fn
            self.registered_fns.add(h)
        return fn

    def _decode_arg(self, e, timings: Optional[Dict[str, float]] = None):
        """Decode one spec argument. ``timings`` (flight recorder)
        accumulates inline/deserialize time under "deserialize" and
        store reads of ref args — fetch + load together, the store get
        returns the object — under "arg_fetch"."""
        kind = e[0]
        t0 = time.perf_counter() if timings is not None else 0.0
        if kind == "v":
            out, tkey = serialization.loads_oob(e[1]), "deserialize"
        elif kind == "ri":
            out, tkey = serialization.loads_oob(e[2]), "deserialize"
        elif kind == "r":
            out = self._store_get_with_recovery(ObjectID(e[1]))
            tkey = "arg_fetch"
        elif kind == "re":
            raise cloudpickle.loads(e[1])
        else:
            raise ValueError(f"bad arg encoding {kind}")
        if timings is not None:
            timings[tkey] = (timings.get(tkey, 0.0)
                             + time.perf_counter() - t0)
        return out

    def _store_get_with_recovery(self, oid: ObjectID):
        """Store read with lineage recovery: a missing segment (evicted /
        deleted behind the directory) asks the driver to re-execute the
        producer, then retries (reference object_recovery_manager.h:41)."""
        try:
            return self.store.get(oid)
        except (FileNotFoundError, OSError):
            # release our resource slot while the producer re-executes —
            # on a saturated pool the reconstruction task needs it
            self.cast("blocked")
            try:
                ok = self.request("reconstruct", oid.binary())
            finally:
                self.cast("unblocked")
            if not ok:
                raise
            return self.store.get(oid)

    def _encode_results(self, spec: dict, value: Any):
        rids = spec["return_ids"]
        if len(rids) == 1:
            values = [value]
        else:
            values = list(value)
            if len(values) != len(rids):
                raise ValueError(
                    f"task declared num_returns={len(rids)} but returned {len(values)}"
                )
        results = []
        for rid_b, v in zip(rids, values):
            oid = ObjectID(rid_b)
            # collect refs nested in the RESULT (not just args): the owner
            # pins them against the return object's lifetime, so a consumer
            # deserializing after this worker's local refs are GC'd still
            # finds them live (advisor r3, reference borrowed-refs-in-
            # returned-values semantics)
            with collect_serialized_refs() as nested:
                inline, size = self.store.put(oid, v)
            if inline is not None:
                entry = (rid_b, "i", inline)
            else:
                # payload = segment size: the runtime records it in the
                # directory so peers can plan chunked pulls (re-statting
                # on the demux thread would tax every result)
                entry = (rid_b, "s", size)
            if nested:
                entry = entry + (list(nested),)
            results.append(entry)
        return results

    def _apply_runtime_env(self, spec: dict):
        """Apply a per-task/actor runtime_env (reference
        ``python/ray/runtime_env``: env_vars, working_dir, py_modules,
        pip site dirs — conda/containers stay unsupported, the image is
        fixed). Returns an undo closure; actor creation applies
        permanently (the process is dedicated). A failure mid-apply
        (bad working_dir, failed pip install) rolls back everything
        applied so far — a partial env must never leak into later
        tasks."""
        renv = spec.get("runtime_env")
        if not renv:
            return lambda: None
        saved_env = {}
        saved_cwd = None
        path_entries = []
        try:
            for k, v in (renv.get("env_vars") or {}).items():
                saved_env[k] = os.environ.get(k)
                os.environ[k] = str(v)
            wd = renv.get("working_dir")
            if wd:
                saved_cwd = os.getcwd()
                os.chdir(wd)
                import sys

                sys.path.insert(0, wd)
                path_entries.append(wd)
            uris = renv.get("py_modules_uris")
            if uris:
                import sys

                from ray_tpu_torch.runtime_env import (_PKG_NAMESPACE,
                                                 materialize_py_modules)

                for entry in materialize_py_modules(
                        uris,
                        lambda u: self.kv_op("get", u, _PKG_NAMESPACE)):
                    sys.path.insert(0, entry)
                    path_entries.append(entry)
            pip_env = renv.get("pip_env")
            if pip_env:
                import sys

                from ray_tpu_torch.runtime_env import ensure_pip_env

                # first use on this node builds the env
                # (flock-serialized); later uses hit the .ready cache.
                # The site dir takes import PRECEDENCE for the task's
                # duration and is fully undone after (module eviction
                # below included).
                entry = ensure_pip_env(pip_env)
                sys.path.insert(0, entry)
                path_entries.append(entry)
        except BaseException:
            self._undo_runtime_env(saved_env, saved_cwd, path_entries)
            raise
        if spec["type"] == ts.ACTOR_CREATE:
            return lambda: None  # permanent for the actor's lifetime

        return lambda: self._undo_runtime_env(saved_env, saved_cwd,
                                              path_entries)

    @staticmethod
    def _undo_runtime_env(saved_env, saved_cwd, path_entries) -> None:
        """Revert an applied (possibly PARTIAL) runtime_env — the one
        definition used by both the post-task undo and the mid-apply
        failure rollback."""
        import sys

        for k, old in saved_env.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        if saved_cwd is not None:
            os.chdir(saved_cwd)
        for entry in path_entries:
            if entry in sys.path:
                sys.path.remove(entry)
        if path_entries:
            # evict modules loaded from the removed entries, or they
            # would leak into later tasks without this runtime_env
            doomed = [
                name for name, mod in list(sys.modules.items())
                if getattr(mod, "__file__", None)
                and any(mod.__file__.startswith(e + os.sep)
                        for e in path_entries)
            ]
            for name in doomed:
                del sys.modules[name]

    def _stream_results(self, spec: dict, value):
        """Drain a streaming task's generator: each yield becomes an object
        under a deterministic id announced immediately (consumers overlap
        with production); the declared return id is the end sentinel and
        resolves to the item count.

        With ``stream_backpressure`` = N, production pauses while N yields
        are unconsumed (reference ``generator_waiter.cc``): the driver
        tracks consumption from the ObjectRefGenerator and releases
        permits."""
        bp = spec.get("stream_backpressure")
        count = 0
        for item in value:
            if bp and count >= bp:
                bp = self._await_stream_permit(spec, count, bp)
            self._emit_stream_item(spec, count, item)
            count += 1
        return self._encode_results(spec, count)

    def _await_stream_permit(self, spec: dict, count: int, bp: int):
        """Permit to produce item ``count``: at most ``bp`` outstanding.
        Releases our resource slot while parked — a consumer draining
        slowly must not starve the pool. The timeout is a deadlock valve
        (e.g. consumer acks lost to a dead node): proceed unthrottled
        rather than park a worker forever. Returns bp, or None when pacing
        was abandoned."""
        self.cast("blocked")
        try:
            out = self.request("stream_permit", spec["task_id"],
                               count + 1 - bp, timeout=300.0)
        finally:
            self.cast("unblocked")
        return None if out is _TIMEOUT else bp

    def _emit_stream_item(self, spec: dict, count: int, item) -> None:
        oid = ObjectID(ts.streaming_return_id(spec["task_id"], count))
        with collect_serialized_refs() as nested:
            inline, size = self.store.put(oid, item)
        self.cast("put", oid.binary(), inline, size, list(nested) or None)

    def stream_consumed(self, task_id: bytes, n: int, owner=None) -> None:
        self.cast("stream_consumed", task_id, n, owner)

    @property
    def cluster_node_id(self):
        return None  # workers tag no owner; their node runtime routes

    def _make_actor_loop(self, actor_id: bytes):
        import asyncio

        loop = asyncio.new_event_loop()
        threading.Thread(target=loop.run_forever, daemon=True,
                         name="rtpu_actor_loop").start()
        self._actor_loops[actor_id] = loop
        return loop

    def _schedule_async(self, spec: dict, coro, undo_env):
        """Schedule an async actor call on the actor's persistent loop and
        return immediately — the main loop keeps dispatching, so concurrent
        calls interleave at awaits. The done message is sent from the
        future's callback."""
        import asyncio

        loop = self._actor_loops[spec["actor_id"]]
        fut = asyncio.run_coroutine_threadsafe(coro, loop)
        tid = spec["task_id"]
        with self._running_lock:
            self._running_futs[tid] = fut

        def on_done(f):
            with self._running_lock:
                self._running_futs.pop(tid, None)
            try:
                try:
                    value = f.result()
                except BaseException as e:  # noqa: BLE001
                    self._send_error(spec, e)
                    return
                results = self._encode_results(spec, value)
                self._send(("done", tid, results))
            except BaseException as e:  # noqa: BLE001
                self._send_error(spec, e)
            finally:
                undo_env()
                self._note_task_metrics({})  # async calls count too

        fut.add_done_callback(on_done)

    def _schedule_async_stream(self, spec: dict, agen, undo_env):
        """``num_returns="streaming"`` on an ASYNC actor method: drain the
        async generator on the actor's persistent loop, announcing each
        yield through the same put path as the sync stream — concurrent
        calls keep interleaving at awaits (ADVICE r2: a sync ``for`` over
        an async generator raised TypeError). Backpressure permits are
        awaited off-loop so the actor loop never blocks."""
        import asyncio

        async def drain():
            bp = spec.get("stream_backpressure")
            count = 0
            aloop = asyncio.get_running_loop()
            async for item in agen:
                if bp and count >= bp:
                    bp = await aloop.run_in_executor(
                        None, self._await_stream_permit, spec, count, bp)
                self._emit_stream_item(spec, count, item)
                count += 1
            return count

        # the sentinel return id resolves to the item count, exactly like
        # a plain async call resolves to its value
        self._schedule_async(spec, drain(), undo_env)

    def _send_error(self, spec: dict, e: BaseException):
        from concurrent.futures import CancelledError

        from ray_tpu_torch.core.exceptions import TaskCancelledError

        desc = f"{spec['type']} {spec.get('name') or spec.get('method', '')}"
        if isinstance(e, (CancelledError, TaskCancelledError)):
            # cancellation travels as a bare TaskCancelledError so callers
            # see ONE exception type regardless of when the cancel landed
            # (queued / running / force all match the queued path)
            err = TaskCancelledError("task was cancelled")
        elif isinstance(e, TaskError):
            err = e
        else:
            err = TaskError(
                e, "".join(traceback.format_exception(type(e), e,
                                                      e.__traceback__)),
                desc)
        blob = cloudpickle.dumps(err)
        results = [(rid, "e", blob) for rid in spec["return_ids"]]
        self._send(("done", spec["task_id"], results))

    def execute(self, spec: dict):
        from ray_tpu_torch.util import tracing

        if tracing.tracing_enabled():
            name = spec.get("name") or spec.get("method") or "task"
            with tracing.span(f"execute::{name}",
                              {"task_id": spec["task_id"].hex(),
                               "worker_id": self.worker_id.hex()},
                              parent=spec.get("trace_ctx")):
                return self._execute_inner(spec)
        return self._execute_inner(spec)

    def _execute_inner(self, spec: dict):
        ttype = spec["type"]
        self.current_task_id = TaskID(spec["task_id"])
        undo_env = lambda: None  # noqa: E731
        tid_b = spec["task_id"]
        with self._running_lock:
            self._running_threads[tid_b] = threading.get_ident()
        # computed BEFORE decoding (it reads only the encoded spec): a
        # mid-decode failure must still release the pins the args decoded
        # so far already took
        arg_oids = ts.arg_refs(spec["args"], spec["kwargs"])
        # flight-recorder phase durations; ride the done message so the
        # driver's recorder sees worker-side phases without extra traffic
        # (None when disabled: no timing calls, no extra message payload)
        phases: Optional[Dict[str, float]] = (
            {} if self._flight_enabled else None)

        def enc(v, streaming=False):
            if phases is None:
                return (self._stream_results(spec, v) if streaming
                        else self._encode_results(spec, v))
            t2 = time.perf_counter()
            if streaming:
                # the generator drain IS the execution (produce + store
                # interleave); no separate store_result phase
                r = self._stream_results(spec, v)
                phases["execute"] = time.perf_counter() - t_exec
            else:
                phases["execute"] = t2 - t_exec
                r = self._encode_results(spec, v)
                phases["store_result"] = time.perf_counter() - t2
            return r

        from ray_tpu_torch.util import failpoints

        try:
            # inside the try: a bad runtime_env (missing working_dir...)
            # must fail THIS task, not crash the worker process
            failpoints.hit("worker.exec",
                           spec.get("name") or spec.get("method"))
            undo_env = self._apply_runtime_env(spec)
            args = [self._decode_arg(a, phases) for a in spec["args"]]
            kwargs = {k: self._decode_arg(v, phases)
                      for k, v in spec["kwargs"].items()}
            t_exec = time.perf_counter()
            if ttype == ts.TASK:
                fn = self._resolve_fn(spec["fn_hash"])
                value = fn(*args, **kwargs)
                results = enc(value, streaming=bool(spec.get("streaming")))
            elif ttype == ts.ACTOR_CREATE:
                cls = self._resolve_fn(spec["fn_hash"])
                self.current_actor_id = ActorID(spec["actor_id"])
                instance = cls(*args, **kwargs)
                self.actors[spec["actor_id"]] = instance
                self.actor_concurrency[spec["actor_id"]] = int(
                    spec.get("max_concurrency", 1))
                if _has_async_methods(cls):
                    self._make_actor_loop(spec["actor_id"])
                results = enc(None)
            elif ttype == ts.ACTOR_METHOD:
                instance = self.actors.get(spec["actor_id"])
                if instance is None:
                    raise ActorDiedError("actor instance not found in this worker")
                self.current_actor_id = ActorID(spec["actor_id"])
                if spec["method"] == "__rtpu_call__":
                    # run an arbitrary function against the instance
                    # (reference ``actor.__ray_call__`` analog; the
                    # compiled-DAG exec loop rides this).
                    fn, *rest = args
                    value = fn(instance, *rest, **kwargs)
                else:
                    method = getattr(instance, spec["method"])
                    value = method(*args, **kwargs)
                import inspect as _inspect

                if _inspect.isasyncgen(value):
                    if (spec.get("streaming")
                            and spec["actor_id"] in self._actor_loops):
                        self._schedule_async_stream(spec, value, undo_env)
                        undo_env = lambda: None  # noqa: E731 — owned by cb
                        return

                    # non-streaming call: drain the async generator to a
                    # list. On an async actor this becomes a coroutine and
                    # flows into the persistent-loop branch below — running
                    # it inline here would freeze the dispatch thread (and
                    # deadlock if the generator awaits another method of
                    # the same actor).
                    async def _collect(g=value):
                        return [x async for x in g]

                    if spec["actor_id"] in self._actor_loops:
                        value = _collect()
                    else:
                        import asyncio

                        value = asyncio.run(_collect())

                if _iscoroutine(value):
                    if spec["actor_id"] in self._actor_loops:
                        # async actor: schedule on the persistent loop and
                        # return — done is sent by the future callback
                        self._schedule_async(spec, value, undo_env)
                        undo_env = lambda: None  # noqa: E731 — owned by cb
                        return
                    # sync actor that returned a coroutine: run it out
                    import asyncio

                    value = asyncio.run(value)
                results = enc(value, streaming=bool(spec.get("streaming")))
            else:
                raise ValueError(f"unknown task type {ttype}")
            failpoints.hit("worker.exec.before_result",
                           spec.get("name") or spec.get("method"))
            if phases is None:
                self._send(("done", spec["task_id"], results))
            else:
                self._send(("done", spec["task_id"], results, phases))
            self._note_task_metrics(phases or {})
        except BaseException as e:  # noqa: BLE001 — remote errors must not kill the worker
            self._send_error(spec, e)
            self._note_task_metrics(phases or {})  # errored tasks count too
        finally:
            undo_env()
            # Drop the store pins _decode_arg's gets took: no ObjectRef
            # tracks them, so without this a free()d arg object stays
            # kDeleting on our reader ref and its arena memory never
            # returns. The frame's own locals are view-holders — clear
            # them first or the liveness guard below always fires.
            # release() keeps the pin whenever OTHER live zero-copy views
            # still reference the segment (baseline guard), so a
            # task/actor that stashed a view of its arg stays safe.
            args = kwargs = value = results = None  # noqa: F841
            for _oid in arg_oids:
                try:
                    self.store.release(_oid)
                except Exception:
                    pass
            with self._running_lock:
                self._running_threads.pop(tid_b, None)
                # Absorb a cancel injected but not yet DELIVERED: a pending
                # async exc landing after this frame returns would kill an
                # unrelated frame (e.g. actor thread-pool internals,
                # permanently shrinking the pool). Clearing under the same
                # lock the injector holds closes the window: once the entry
                # is gone no new injection can target this thread.
                import ctypes

                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(threading.get_ident()),
                    ctypes.c_void_p(0))
            self.current_task_id = None

    # -- metrics federation (sender side) --------------------------------

    def _note_task_metrics(self, phases: Dict[str, float]) -> None:
        """Worker-local built-ins: executed-task counter + exec-time
        histogram. These live in THIS process's registry and reach the
        head /metrics via the federated delta push, labeled with this
        worker's id."""
        try:
            if self._wmetrics is None:
                from ray_tpu_torch.util import metric_defs

                self._wmetrics = {
                    "tasks": metric_defs.get("rtpu_worker_tasks_total"),
                    "exec": metric_defs.get(
                        "rtpu_worker_task_exec_seconds"),
                }
            self._wmetrics["tasks"].inc()
            if "execute" in phases:
                self._wmetrics["exec"].observe(phases["execute"])
        except Exception:
            pass

    def _maybe_push_metrics(self) -> None:
        """Push metric-registry DELTAS to the driver over the existing
        pipe, rate-limited (default 2s) — the federation hop for worker
        processes. Between pushes the hot path pays one monotonic-clock
        read; nothing is sent when no metric changed."""
        if self._metrics_interval is None:
            try:
                from ray_tpu_torch import config as _cfg

                self._metrics_interval = (
                    float(_cfg.get("metrics_push_interval_s"))
                    if _cfg.get("metrics_federation") else 0.0)
            except Exception:
                self._metrics_interval = 0.0
        if self._metrics_interval <= 0:
            return
        now = time.monotonic()
        if now - self._metrics_last_push < self._metrics_interval:
            return
        self._metrics_last_push = now
        try:
            from ray_tpu_torch.util import metrics as _metrics

            if self._metrics_exporter is None:
                self._metrics_exporter = _metrics.DeltaExporter()
            records = self._metrics_exporter.collect()
            if records:
                self.cast("metrics", records)
        except Exception:
            pass

    def _maybe_push_spans(self) -> None:
        """Drain this process's span ring to the driver as a batched cast
        (the trace-plane hop for worker processes; driver ingests into its
        TraceStore with this worker's origin labels). One dict get when
        tracing is disabled; rate-limited otherwise."""
        from ray_tpu_torch.util import tracing

        if not tracing.tracing_enabled():
            return
        now = time.monotonic()
        if self._trace_interval is None:
            try:
                from ray_tpu_torch import config as _cfg

                self._trace_interval = float(
                    _cfg.get("trace_push_interval_s"))
            except Exception:
                self._trace_interval = 1.0
        if now - self._trace_last_push < self._trace_interval:
            return
        self._trace_last_push = now
        self._push_spans_now()

    def _push_spans_now(self) -> None:
        """Drain the ring and ship it as one cast — THE span-push hop,
        shared by the rate-limited loop and the disarm-time tail flush."""
        from ray_tpu_torch.util import tracing

        try:
            batch = tracing.drain_ring()
            if batch:
                self.cast("spans", batch)
                tracing.note_push()
        except Exception:
            pass

    def _maybe_push_profile(self) -> None:
        """Drain this process's profile table to the driver as a batched
        cast, rate-limited (the profile twin of _maybe_push_spans). One
        dict get when profiling is disarmed; also the lazy start point
        for the sampler in env-armed workers (zygote children restart
        theirs here after fork)."""
        from ray_tpu_torch.util import profiling

        if not profiling.profiling_enabled():
            return
        profiling.ensure_sampler()
        now = time.monotonic()
        if self._profile_interval is None:
            try:
                from ray_tpu_torch import config as _cfg

                self._profile_interval = float(
                    _cfg.get("profile_push_interval_s"))
            except Exception:
                self._profile_interval = 1.0
        if now - self._profile_last_push < self._profile_interval:
            return
        self._profile_last_push = now
        self._push_profile_now()

    def _push_profile_now(self) -> None:
        """Drain the table and ship it as one cast — THE profile-push
        hop, shared by the rate-limited loop and the disarm tail flush."""
        from ray_tpu_torch.util import profiling

        try:
            batches = profiling.drain_batches()
            if batches:
                self.cast("prof", batches)
                profiling.note_push()
        except Exception:
            pass

    def _maybe_push_events(self) -> None:
        """Drain this process's lifecycle-event ring to the driver as a
        batched cast, rate-limited (the event twin of
        _maybe_push_spans). One dict get when the plane is killed."""
        from ray_tpu_torch.util import events

        if not events.events_enabled():
            return
        now = time.monotonic()
        if self._event_interval is None:
            try:
                from ray_tpu_torch import config as _cfg

                self._event_interval = float(
                    _cfg.get("event_push_interval_s"))
            except Exception:
                self._event_interval = 1.0
        if now - self._event_last_push < self._event_interval:
            return
        self._event_last_push = now
        self._push_events_now()

    def _push_events_now(self) -> None:
        """Drain the ring and ship it as one cast — THE event-push hop,
        shared by the rate-limited loop and the disarm tail flush."""
        from ray_tpu_torch.util import events

        try:
            batch = events.drain_ring()
            if batch:
                self.cast("events", batch)
                events.note_push()
        except Exception:
            pass

    def _maybe_push_device(self) -> None:
        """Ship this process's compiled-program registry snapshot to the
        driver, rate-limited AND version-gated. A worker that never
        imported the plane has an empty registry and ships nothing; the
        guard also keeps this tick from importing torch into it."""
        import sys

        device_plane = sys.modules.get("ray_tpu_torch.util.device_plane")
        if device_plane is None or not device_plane.device_plane_enabled():
            return
        now = time.monotonic()
        if self._device_interval is None:
            try:
                from ray_tpu_torch import config as _cfg

                self._device_interval = float(
                    _cfg.get("device_push_interval_s"))
            except Exception:
                self._device_interval = 2.0
        if now - self._device_last_push < self._device_interval:
            return
        self._device_last_push = now
        try:
            snap = device_plane.snapshot(
                min_version=self._device_version_shipped)
            if snap is not None:
                self._device_version_shipped = snap["version"]
                self.cast("device", snap)
        except Exception:
            pass

    def push_telemetry(self) -> None:
        """Rate-limited metric/span/profile/event pushes, callable from
        ANY thread: the main loop's idle ticks, and compiled-DAG exec
        loops — whose occupying ``__rtpu_call__`` starves a
        concurrency-1 actor's main loop, so without this hook a DAG
        actor's spans/metrics would strand in its rings until teardown."""
        with self._push_lock:
            self._maybe_push_metrics()
            self._maybe_push_spans()
            self._maybe_push_profile()
            self._maybe_push_events()
            self._maybe_push_device()

    def main_loop(self):
        self._start_receiver()
        self._send(("ready",))
        import queue as _queue

        while True:
            try:
                spec = self._exec_queue.get(timeout=2.0)
            except _queue.Empty:
                # idle: bounded staleness for __del__-deferred ref drops
                self._drain_ref_drops()
                self.push_telemetry()
                continue
            self._drain_ref_drops()
            self.push_telemetry()
            conc = (self.actor_concurrency.get(spec.get("actor_id", b""), 1)
                    if spec["type"] == ts.ACTOR_METHOD else 1)
            if (spec["type"] == ts.ACTOR_METHOD
                    and spec.get("actor_id") in self._actor_loops):
                # async actor: execute() schedules the coroutine on the
                # actor's persistent loop and returns immediately — no
                # thread pool needed for interleaving
                self._execute_guarded(spec)
            elif conc > 1:
                # concurrent actor: run the call on the actor's thread
                # pool so the main loop keeps draining dispatches
                aid = spec["actor_id"]
                pool = self._actor_pools.get(aid)
                if pool is None:
                    from concurrent.futures import ThreadPoolExecutor

                    pool = ThreadPoolExecutor(
                        max_workers=conc,
                        thread_name_prefix="rtpu_actor")
                    self._actor_pools[aid] = pool
                pool.submit(self._execute_guarded, spec)
            else:
                self._execute_guarded(spec)

    def _execute_guarded(self, spec: dict):
        """execute() plus a guard for a cancel injection that lands after
        the task's except/finally (the SetAsyncExc check->inject window):
        the stray TaskCancelledError must not kill the dispatch thread."""
        from ray_tpu_torch.core.exceptions import TaskCancelledError

        try:
            self.execute(spec)
        except TaskCancelledError:
            pass


def _iscoroutine(value) -> bool:
    import inspect

    return inspect.iscoroutine(value)


def _has_async_methods(cls) -> bool:
    import inspect

    return any(
        inspect.iscoroutinefunction(m := getattr(cls, name, None))
        or inspect.isasyncgenfunction(m)
        for name in dir(cls) if not name.startswith("_")
    )


def worker_entry(conn, session: str, worker_id: bytes):
    os.environ["RTPU_WORKER"] = "1"
    import ray_tpu_torch.core.runtime as rt

    w = WorkerRuntime(conn, session, worker_id)
    rt._set_runtime(w)
    try:
        w.main_loop()
    except KeyboardInterrupt:
        os._exit(0)


def _main():
    """Worker executable: ``python -m ray_tpu_torch.core.worker --addr ...``.

    Workers are separate executables that dial back to the driver over a
    unix socket (reference: raylet execs ``default_worker.py``) — NOT
    multiprocessing children, so a driver script without an
    ``if __name__ == "__main__"`` guard can never fork-bomb.
    """
    import argparse
    import faulthandler
    import signal
    from multiprocessing.connection import Client

    # `ray_tpu_torch stack` analog of `ray stack` (py-spy role): SIGUSR1 dumps
    # every thread's python stack into the worker's log file. The spawner
    # pre-sets SIGUSR1 to SIG_IGN across exec (ignored dispositions
    # survive), so a stray signal during the multi-second interpreter
    # boot cannot kill the worker before this register runs.
    faulthandler.register(signal.SIGUSR1, all_threads=True)

    ap = argparse.ArgumentParser()
    ap.add_argument("--addr", required=True)
    ap.add_argument("--session", required=True)
    ap.add_argument("--worker-id", required=True)
    args = ap.parse_args()

    # Retry transient connect failures: a spawn burst can momentarily
    # fill the driver listener's accept backlog, and unix sockets fail
    # with EAGAIN instead of blocking — crashing here would kill the
    # actor this worker was spawned for.
    deadline = time.monotonic() + 10.0
    while True:
        try:
            conn = Client(args.addr, family="AF_UNIX",
                          authkey=args.session.encode())
            break
        except (BlockingIOError, ConnectionRefusedError, OSError):
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.05)
    wid = bytes.fromhex(args.worker_id)
    conn.send(("hello", wid))
    worker_entry(conn, args.session, wid)


if __name__ == "__main__":
    _main()
