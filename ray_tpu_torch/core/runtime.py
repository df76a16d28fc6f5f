"""Driver-side runtime: scheduler, worker pool, public API.

Role analogs in the reference:
  - scheduler/dispatch: ``src/ray/raylet/local_task_manager.h`` +
    ``scheduling/cluster_task_manager.h`` (single node, so no spillback)
  - worker pool: ``src/ray/raylet/worker_pool.h`` (prestart, dedicated
    actor workers)
  - public API: ``python/ray/_private/worker.py`` (init/get/put/wait/remote)

Control transport is one duplex pipe per worker; the driver runs one reader
thread per worker plus an event-driven dispatch loop under a single lock
(fine for a single node; the multi-node design moves this behind gRPC).
"""

from __future__ import annotations

import atexit
import logging
import os
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

import cloudpickle

from ray_tpu_torch import config
from ray_tpu_torch.core import serialization, task_spec as ts
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    TaskCancelledError,
    WorkerCrashedError,
)
from ray_tpu_torch.core.gcs import ERROR, Gcs, READY, ActorInfo
from ray_tpu_torch.core.ids import ActorID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.object_store import StoreClient

logger = logging.getLogger(__name__)

_runtime = None
_runtime_lock = threading.Lock()

# -- built-in pipe/spawn instrumentation (defs in util/metric_defs) ------
# Pre-sorted tag keys: the pipe counters sit on the per-message hot
# path, so each message pays two cached _inc_key calls and nothing
# else. metric_defs.get is itself a cached fast path that re-registers
# after a test's clear_registry, so the accessor just rebuilds.
_SENT_KEY = (("direction", "sent"),)
_RECV_KEY = (("direction", "recv"),)
_SPAWN_KEYS = {"zygote": (("mode", "zygote"),), "exec": (("mode", "exec"),)}

#: wire magic of a packed worker->driver refpin frame (parsed natively by
#: the pipe engine; the Python fallback reader understands it too)
_REFPIN_MAGIC = b"RTP1"
#: wire magic of a native-coalesced driver->worker batch frame
_BATCH_MAGIC = b"RTB1"


def _pipe_metrics():
    from ray_tpu_torch.util import metric_defs as md

    return {"sent": md.get("rtpu_pipe_sent_bytes_total"),
            "recv": md.get("rtpu_pipe_recv_bytes_total"),
            "msgs": md.get("rtpu_pipe_messages_total"),
            "batch": md.get("rtpu_pipe_batch_messages"),
            "nsend": md.get("rtpu_pipe_native_send_seconds"),
            "ndrain": md.get("rtpu_pipe_native_drain_messages")}


def _set_runtime(rt):
    global _runtime
    _runtime = rt


def _get_runtime():
    if _runtime is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called in this process")
    return _runtime


class _WorkerState:
    __slots__ = (
        "worker_id", "proc", "conn", "kind", "status", "current",
        "held", "actor_id", "reader", "released", "send_lock", "log_path",
        "pending_spec", "inflight_specs", "pinned", "spawn_ts",
        "spawn_mode", "npipe", "sent_ctr", "native_pin_q",
    )

    def __init__(self, worker_id: WorkerID, proc, kind: str):
        from ray_tpu_torch.util.contention import timed_lock

        self.worker_id = worker_id
        self.proc = proc  # subprocess.Popen
        self.conn = None  # attached when the worker dials back
        # GIL-free pipe engine for this connection (None = Python path).
        # Once attached, the engine owns every read/write on the fd; the
        # Connection object only keeps the fd alive.
        self.npipe = None
        self.sent_ctr = 0  # 1-in-64 sampling of the nsend histogram
        # refpin transitions surfaced by the engine, pending application
        # (appended lock-free by _native_cb_refpins, drained by THIS
        # connection's reader thread — per-worker so no other reader can
        # steal a +1 and apply it after a later 'done' in our burst)
        from collections import deque as _wdeque

        self.native_pin_q: "_wdeque" = _wdeque()
        self.kind = kind  # "pool" | "actor"
        self.status = "starting"  # starting | idle | busy | dead
        self.current: Optional[dict] = None
        self.held: Dict[str, float] = {}
        self.actor_id: Optional[bytes] = None
        self.released = False
        self.send_lock = timed_lock("driver.worker_send")
        self.log_path = ""
        self.pending_spec: Optional[dict] = None  # dispatch once connected
        # all dispatched-but-unfinished specs keyed by task id (>1 only for
        # actors with max_concurrency > 1)
        self.inflight_specs: Dict[bytes, dict] = {}
        # objects this worker process borrows (oid -> transition count)
        self.pinned: Dict[bytes, int] = {}
        # spawn-latency stamp (zygote | exec), observed on "ready"
        self.spawn_ts = time.monotonic()
        self.spawn_mode = "exec"

    def send(self, msg):
        if self.conn is None:
            raise OSError("worker not connected yet")
        from ray_tpu_torch.util import failpoints

        if failpoints.hit("pipe.send", msg[0]):
            return  # chaos: drop this driver->worker control message
        # pre-pickle so the framed byte count is known (what conn.send
        # does internally anyway — same reducer, no extra copy)
        from multiprocessing.reduction import ForkingPickler

        buf = ForkingPickler.dumps(msg)
        np_ = self.npipe
        if np_ is not None:
            # GIL-free fast path: the engine frames and writes inline
            # (nonblocking) or hands off to its sender thread when the
            # socket backs up. NO per-message Python metric work here —
            # the engine counts natively and the runtime's collector
            # reconciles rtpu_pipe_* at exposition time; only a sampled
            # 1-in-64 enqueue-latency observation stays on this path.
            self.sent_ctr += 1
            if self.sent_ctr & 63:
                if not np_.send(buf):
                    raise OSError("native pipe closed (worker gone)")
                return
            t0 = time.perf_counter()
            if not np_.send(buf):
                raise OSError("native pipe closed (worker gone)")
            try:
                _pipe_metrics()["nsend"]._observe_key(
                    (), time.perf_counter() - t0)
            except Exception:
                pass
            return
        with self.send_lock:
            self.conn.send_bytes(buf)
        try:
            m = _pipe_metrics()
            m["sent"]._inc_key((), len(buf))
            m["msgs"]._inc_key(_SENT_KEY)
        except Exception:
            pass


def _worker_site_dirs() -> list:
    """Every site dir a -S worker must re-add: system site-packages PLUS
    the user site (pip install --user) when enabled — dropping the latter
    would break imports that work in the driver."""
    import site

    dirs = list(site.getsitepackages())
    try:
        if site.ENABLE_USER_SITE:
            user = site.getusersitepackages()
            if user and user not in dirs:
                dirs.append(user)
    except Exception:
        pass
    return dirs


class _ZygoteChild:
    """Popen-like handle for a worker forked by the zygote.

    The zygote (the fork parent) reaps the child and reports its exit over
    the control pipe; this proxy turns that report into the wait()/poll()/
    terminate()/kill() surface _WorkerState expects. If the zygote itself
    dies, liveness falls back to signal-0 probing."""

    def __init__(self, zygote: "_Zygote", wid_hex: str):
        self._zygote = zygote
        self._wid = wid_hex
        self.pid: Optional[int] = None
        self.returncode: Optional[int] = None
        self._exit_ev = threading.Event()
        self._pid_ev = threading.Event()

    def _on_spawned(self, pid: int) -> None:
        self.pid = pid
        self._pid_ev.set()

    def _on_exit(self, status: int) -> None:
        self.returncode = status
        self._exit_ev.set()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            step = 0.5
            if deadline is not None:
                step = min(step, deadline - time.monotonic())
                if step <= 0:
                    import subprocess

                    raise subprocess.TimeoutExpired("zygote-child",
                                                    timeout or 0)
            if self._exit_ev.wait(step):
                return self.returncode
            if self._zygote.dead:
                # exit reports are gone; probe the process directly
                if self.pid is None or not _pid_alive(self.pid):
                    self.returncode = self.returncode or -1
                    self._exit_ev.set()
                    return self.returncode

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        if self._zygote.dead and (self.pid is None
                                  or not _pid_alive(self.pid)):
            self.returncode = -1
            self._exit_ev.set()
        return self.returncode

    def _signal(self, sig: int) -> None:
        if not self._pid_ev.wait(5.0) or self.pid is None:
            return
        try:
            os.kill(self.pid, sig)
        except ProcessLookupError:
            pass

    def terminate(self) -> None:
        import signal as _signal_mod

        self._signal(_signal_mod.SIGTERM)

    def kill(self) -> None:
        import signal as _signal_mod

        self._signal(_signal_mod.SIGKILL)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def _worker_crashed_error(ws, spec, pm) -> WorkerCrashedError:
    """A ``WorkerCrashedError`` carrying the death postmortem: the exit
    cause class rides ``error_type`` (the r16 machine-readable contract,
    e.g. ``worker_died:signal:SIGKILL``), the structured forensics ride
    ``postmortem``, and the message folds in the readable excerpt so a
    bare ``ray_tpu_torch.get`` shows WHY the worker died."""
    from ray_tpu_torch.util import events as _events

    cause = (pm or {}).get("cause", "unknown")
    msg = (f"worker {ws.worker_id.hex()} died running task "
           f"{spec.get('name') if spec else '?'} ({cause})")
    detail = _events.format_postmortem(pm)
    if detail:
        msg += "\n--- worker postmortem ---\n" + detail
    err = WorkerCrashedError(msg)
    err.error_type = f"worker_died:{cause}"
    err.postmortem = pm
    return err


def _actor_died_error(actor_hex: str, pm) -> ActorDiedError:
    """``ActorDiedError`` twin of :func:`_worker_crashed_error`."""
    from ray_tpu_torch.util import events as _events

    cause = (pm or {}).get("cause", "unknown")
    msg = f"actor {actor_hex} died ({cause})"
    detail = _events.format_postmortem(pm)
    if detail:
        msg += "\n--- worker postmortem ---\n" + detail
    err = ActorDiedError(msg)
    err.error_type = f"actor_died:{cause}"
    err.postmortem = pm
    return err


class _Zygote:
    """Driver-side handle for the fork-server process (core/zygote.py)."""

    def __init__(self, env: Dict[str, str]):
        import subprocess
        import sys

        dirs = ", ".join(repr(d) for d in _worker_site_dirs())
        bootstrap = (
            "import signal; signal.signal(signal.SIGUSR1, signal.SIG_IGN); "
            f"import site; [site.addsitedir(d) for d in ({dirs},)]; "
            "import runpy; "
            "runpy.run_module('ray_tpu_torch.core.zygote', run_name='__main__')"
        )
        self.proc = subprocess.Popen(
            [sys.executable, "-S", "-c", bootstrap],
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL)
        self.dead = False
        self.restartable = True
        self._lock = threading.Lock()
        self._children: Dict[str, _ZygoteChild] = {}
        self._ready = threading.Event()
        threading.Thread(target=self._reader_loop, daemon=True,
                         name="rtpu-zygote-reader").start()
        deadline = time.monotonic() + 20.0
        while not self._ready.wait(0.25):
            # abort EARLY on child death — a crashing bootstrap must not
            # cost the full timeout (and callers latch the failure so no
            # later spawn re-pays it)
            if self.proc.poll() is not None:
                self.dead = True
                self.restartable = False
                raise RuntimeError(
                    f"zygote exited rc={self.proc.returncode} at boot")
            if time.monotonic() > deadline:
                self.dead = True
                self.restartable = False
                try:
                    self.proc.kill()
                except Exception:
                    pass
                raise RuntimeError("zygote did not come up within 20s")

    def spawn(self, wid_hex: str, addr: str, session: str,
              log_path: str) -> _ZygoteChild:
        import json as _json

        child = _ZygoteChild(self, wid_hex)
        with self._lock:
            if self.dead:
                raise OSError("zygote dead")
            self._children[wid_hex] = child
            req = _json.dumps({"wid": wid_hex, "addr": addr,
                               "session": session, "log": log_path})
            self.proc.stdin.write((req + "\n").encode())
            self.proc.stdin.flush()
        return child

    def _reader_loop(self) -> None:
        import json as _json

        for line in self.proc.stdout:
            try:
                msg = _json.loads(line)
            except _json.JSONDecodeError:
                continue
            ev = msg.get("event")
            if ev == "ready":
                self._ready.set()
            elif ev == "spawned":
                with self._lock:
                    c = self._children.get(msg["wid"])
                if c is not None:
                    c._on_spawned(msg["pid"])
            elif ev == "exit":
                # map mutation under the same lock spawn() inserts with;
                # the child callback runs outside it (it only sets events,
                # but lock scope stays minimal on principle)
                with self._lock:
                    c = self._children.pop(msg["wid"], None)
                if c is not None:
                    c._on_exit(msg.get("status", -1))
        self.dead = True  # stdout EOF: zygote gone; proxies self-probe

    def close(self) -> None:
        self.dead = True
        self.restartable = False
        try:
            self.proc.stdin.close()  # zygote exits on stdin EOF
        except Exception:
            pass
        try:
            self.proc.wait(2.0)
        except Exception:
            try:
                self.proc.kill()
            except Exception:
                pass


class DriverRuntime:
    is_driver = True

    def __init__(
        self,
        num_cpus: Optional[int] = None,
        num_gpus: Optional[int] = None,
        resources: Optional[Dict[str, float]] = None,
        namespace: str = "default",
        worker_env: Optional[Dict[str, str]] = None,
        log_to_driver: bool = True,
        labels: Optional[Dict[str, str]] = None,
        _pool_prestart: Optional[int] = None,
    ):
        self.session = uuid.uuid4().hex[:12]
        self.namespace = namespace
        self.node_id = NodeID.from_random()
        # static node labels (reference NodeLabels role): user labels +
        # RTPU_NODE_LABELS env ("k=v,k=v"); NodeLabelSchedulingStrategy
        # targets them (TPU generation / slice type in real deployments)
        from ray_tpu_torch.util.labels import parse_labels

        self.labels: Dict[str, str] = parse_labels(
            os.environ.get("RTPU_NODE_LABELS", ""))
        self.labels.update(labels or {})
        self.gcs = Gcs()
        self.store = StoreClient(self.session)
        self.worker_env = dict(worker_env or {})
        # Workers must not claim the card by default: the driver (or an
        # actor that opts in) owns it. A hard default, NOT the driver's env
        # value: a pool worker that saw the card could create a CUDA
        # context on it by accident (hundreds of MB of device memory each)
        # and, once it did, no actor promoted from it could ever see the
        # card again. The NVML check keeps ``torch.cuda.is_available()``
        # from initialising the driver API. An actor opts back in with
        # @remote(num_gpus=1, runtime_env={"env_vars":
        # {"CUDA_VISIBLE_DEVICES": "0"}}) and gets a fresh process.
        from ray_tpu_torch.accelerators.gpu import (hidden_worker_env,
                                                    detect_num_gpus)

        for k, v in hidden_worker_env().items():
            self.worker_env.setdefault(k, v)

        cpus = num_cpus if num_cpus is not None else (os.cpu_count() or 1)
        gpus = num_gpus if num_gpus is not None else detect_num_gpus()
        self.total: Dict[str, float] = {"CPU": float(cpus)}
        if gpus:
            self.total["GPU"] = float(gpus)
        for k, v in (resources or {}).items():
            self.total[k] = float(v)
        self.avail = dict(self.total)

        # hot-lock contention accounting (util/contention.py): the
        # dispatch lock and ref lock are the driver's scalability
        # bottlenecks under multi-client load — instrument them so
        # state.summarize_contention() can say WHERE time goes
        from ray_tpu_torch.util.contention import timed_lock, timed_rlock

        self.lock = timed_rlock("driver.lock")
        self.workers: Dict[WorkerID, _WorkerState] = {}
        self.ready_tasks: deque = deque()
        self.waiting_specs: Dict[bytes, dict] = {}
        self.cancelled: set = set()
        # pg_id -> {"bundles": {global idx: avail dict}, "totals": {...}}.
        # Keyed by GLOBAL bundle index: in cluster mode a node holds only
        # the bundles reserved on it (reference
        # placement_group_resource_manager.h role).
        self.pgs: Dict[bytes, dict] = {}
        # 2-phase reservation staging (reference GCS placement group
        # scheduler's prepare/commit, gcs_placement_group_scheduler.h:111):
        # resources are deducted at prepare, become a live pg at commit,
        # and return at abort (or reap, if the creator died mid-protocol).
        self._pg_staged: Dict[bytes, dict] = {}
        self.timeline_events: List[dict] = []
        self._task_start_ts: Dict[bytes, float] = {}
        # Task-lifecycle flight recorder (reference task_event_buffer.h
        # role): bounded ring of per-task phase timings feeding
        # state.summarize_tasks percentiles; built-in phase histograms are
        # created lazily (first finished task), with pre-sorted tag keys so
        # the per-task observe cost stays a few microseconds.
        self.task_ring: deque = deque(maxlen=int(config.get("task_ring")))
        self._flight_enabled = bool(config.get("flight_recorder"))
        # trace plane (receiver side): workers' span batches and this
        # process's own ring land here; on a node daemon the heartbeat
        # ships deltas to the GCS, on the head state.list_spans() reads it
        from ray_tpu_torch.util.trace_store import TraceStore

        self.trace_store = TraceStore()
        # arming payload for workers spawned after enable_tracing()
        # (delivered on dial-back, like _fp_specs)
        self._trace_push = None
        # profiling plane (receiver side): workers' profile batches and
        # this process's own sampler window land here; daemons ship
        # deltas on the heartbeat, the head merges at state.profile()
        from ray_tpu_torch.util import profiling as _profiling

        self.profile_store = _profiling.ProfileStore()
        self._profile_push = None
        # event plane (receiver side): workers' lifecycle-event batches
        # and this process's own ring land here; daemons ship deltas on
        # the heartbeat, the head serves state.list_events()
        from ray_tpu_torch.util.event_store import EventStore

        self.event_store = EventStore()
        self._event_push = None
        # device plane (receiver side): workers' compiled-program
        # registry snapshots land here (replace-by-origin, like the
        # metric FederationStore — registry rows are mutable state, not
        # an append log); state.device_report() merges this with the
        # driver's own registry and remote nodes' GCS payloads
        from ray_tpu_torch.util.device_plane import DeviceStore

        self.device_store = DeviceStore()
        # alerting watchdog (head-side): declarative rules over the
        # metric view, RTPU_ALERTS=0 kills it. Started here (the driver
        # IS the head in local mode and the head node's driver in
        # cluster mode); daemons don't evaluate — their metrics reach
        # the head on heartbeats.
        try:
            from ray_tpu_torch.util import alerts as _alerts

            _alerts.start_watchdog()
        except Exception:
            pass
        # env-armed boot (RTPU_PROFILING=1 before init): resolving here
        # starts this process's sampler; one dict get when disarmed
        _profiling.profiling_enabled()
        # live cluster-wide stack dumps (`ray_tpu_torch stack` py-spy role):
        # workers reply to a "stackdump" push with a "stacks" cast
        self._stack_replies: Dict[bytes, dict] = {}
        # object-memory forensics: creation metadata per object id
        # (owner process, wall-clock birth, optional call-site when the
        # profiler is armed) — bounded FIFO, pure dict work on hot paths
        self._obj_meta: "OrderedDict[bytes, dict]" = OrderedDict()
        self._obj_meta_cap = int(config.get("obj_meta_max"))
        self._phase_hist = None
        self._phase_keys: Dict[str, tuple] = {}
        self._status_keys = {False: (("status", "ok"),),
                             True: (("status", "error"),)}
        self._finished_counter = None
        # built-in scheduler/worker-pool counters (defs in
        # util/metric_defs.py, reference metric_defs.cc role); tag keys
        # pre-sorted for the submit/dispatch hot paths
        from ray_tpu_torch.util import metric_defs as _md

        self._m_submitted = _md.get("rtpu_scheduler_tasks_submitted_total")
        self._m_dispatched = _md.get(
            "rtpu_scheduler_tasks_dispatched_total")
        self._m_spawns = _md.get("rtpu_worker_spawns_total")
        self._m_spawn_lat = _md.get("rtpu_worker_spawn_seconds")
        self._m_deaths = _md.get("rtpu_worker_deaths_total")
        self._m_zygote_restarts = _md.get("rtpu_zygote_restarts_total")
        self._type_keys = {ts.TASK: (("type", "task"),),
                           ts.ACTOR_CREATE: (("type", "actor_create"),),
                           ts.ACTOR_METHOD: (("type", "actor_method"),)}
        self.pool_cap = max(4, cpus)
        self.pool_hard_cap = max(64, cpus * 8)
        self._spawning = 0  # spawns decided but not yet registered
        self._spawns_in_flight = 0  # _spawn_worker calls not yet returned
        self._shutdown = False

        # cluster-mode adapter (ray_tpu_torch/cluster/adapter.py); None single-node
        self.cluster = None

        # Lineage for object reconstruction (reference
        # object_recovery_manager.h:41 / task_manager.h:468): return-id ->
        # producing TASK spec, bounded FIFO. A lost segment with live refs
        # re-executes the producer; recursion through lost deps happens
        # naturally (the re-executed task's worker hits the same path).
        # streaming-generator backpressure: task_id -> items consumed by
        # the ObjectRefGenerator; producers block on stream_permit until
        # consumption catches up (reference generator_waiter.cc). Permit
        # waits are entries in _stream_waiters serviced by whichever
        # thread advances consumption — no thread per permit. The counter
        # dict is bounded (entries are re-creatable by late acks).
        self._stream_consumed: Dict[bytes, int] = {}
        self._stream_waiters: List[tuple] = []  # (task_id, need, reply)
        self._stream_cv = threading.Condition(self.lock)

        # Distributed object lifetime (reference ReferenceCounter,
        # reference_count.h:61 role): per-object pin counts aggregate
        # (a) live ObjectRef instances in THIS process, (b) worker-reported
        # borrows, (c) task-argument pins held from submit until the task's
        # first return turns terminal. Node-level 0<->1 transitions are
        # reported to the cluster directory, which never evicts pinned
        # entries and tells holders to free segments on the last unpin.
        self._ref_lock = timed_lock("driver.ref_lock")
        self._pin_total: Dict[bytes, int] = {}
        self._arg_pins: Dict[bytes, List[bytes]] = {}
        # GC-safety (advisor r3): ObjectRef.__del__ can fire at ANY
        # allocation point — including on a thread that already holds
        # _ref_lock (a dict mutation inside _pin_delta triggering cycle
        # collection) or an rpc send lock. The __del__ hook therefore only
        # appends to a deque; normal code paths and a small janitor thread
        # drain it, and directory pin/unpin casts are queued under the lock
        # (preserving transition order) but shipped outside it. Shared
        # machinery: ray_tpu_torch/core/refqueue.py.
        from ray_tpu_torch.core.refqueue import DeferredDrops, OrderedCastFlusher

        self._cast_flusher = OrderedCastFlusher(self._send_pin_cast)
        # store pins to drop once outside _ref_lock: when the driver's
        # local refcount for an object hits zero, its store pin (taken by
        # get()) must drop too, or a free()d object consumed with the
        # get-then-free pattern stays kDeleting on the driver's reader ref
        # forever (the worker-side twin lives in worker.py)
        from collections import deque as _deque

        self._local_pin_releases: "_deque" = _deque()
        self._deferred_unpins = DeferredDrops(
            self._ref_lock, lambda b: self._apply_pin_locked(b, -1),
            self._after_ref_unpins)
        # outer object id -> ids of refs nested in its stored bytes, pinned
        # by THIS owner until the outer object is freed
        self._result_ref_pins: Dict[bytes, set] = {}
        from ray_tpu_torch.core import object_ref as _object_ref

        _object_ref.set_ref_hook(
            lambda b: self._pin_delta(b, 1),
            self._deferred_unpins.append)
        self.gcs.on_terminal = self._release_arg_pins
        self._janitor_wake = threading.Event()  # never set; idle-typed wait
        threading.Thread(target=self._ref_janitor_loop, daemon=True,
                         name="rtpu-ref-janitor").start()

        self._lineage: Dict[bytes, dict] = {}
        self._lineage_cap = int(config.get("lineage_max"))
        # byte bound too (reference RAY_max_lineage_bytes role): specs keep
        # inlined serialized args alive, so count alone can hold GBs
        self._lineage_max_bytes = int(config.get("lineage_max_bytes"))
        self._lineage_bytes = 0
        self._lineage_sizes: Dict[bytes, int] = {}
        self._reconstructing: Dict[bytes, threading.Event] = {}

        self.session_dir = f"/tmp/rtpu-{self.session}"
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        self._sock_addr = os.path.join(self.session_dir, "driver.sock")
        from multiprocessing.connection import Listener

        # backlog: the default of 1 makes a 16-actor burst race the serial
        # accept loop — unix sockets return EAGAIN (not block) on a full
        # backlog, crashing the connecting worker (workers also retry)
        self._listener = Listener(self._sock_addr, family="AF_UNIX",
                                  backlog=64,
                                  authkey=self.session.encode())
        threading.Thread(target=self._accept_loop, daemon=True).start()

        self._zygote_obj = None
        self._zygote_disabled = False
        self._zygote_lock = threading.Lock()
        if _pool_prestart is None:
            _pool_prestart = int(config.get("pool_prestart"))
        self._prestart = min(_pool_prestart, self.pool_cap)
        for _ in range(self._prestart):
            self._spawn_worker("pool")

        # Log streaming to the driver (reference log_monitor.py +
        # GcsLogSubscriber, _raylet.pyx:3148 role): tail the session's
        # worker log files and echo new lines to the driver's stdout with
        # a worker prefix.
        self._log_monitor_stop = threading.Event()
        if log_to_driver and config.get("log_to_driver"):
            threading.Thread(target=self._log_monitor_loop, daemon=True,
                             name="rtpu-log-monitor").start()

        # OOM protection (reference MemoryMonitor + worker-killing policy):
        # kill the newest retriable task under host-RAM pressure. Killed
        # workers re-enter the normal death path, which retries the task.
        self._memory_monitor = None
        if config.get("memory_monitor"):
            from ray_tpu_torch.core.memory_monitor import (MemoryMonitor,
                                                     kill_retriable_policy)

            threshold = float(config.get("memory_usage_threshold"))
            self._memory_monitor = MemoryMonitor(
                usage_threshold=threshold,
                on_pressure=kill_retriable_policy(self),
            ).start()

        self._metrics_collector = None
        self._register_core_gauges()

    def _register_core_gauges(self) -> None:
        """Sampled scheduler gauges (queue depth, in-flight, pool size,
        refcount/lineage table sizes), refreshed by the metrics collector
        hook at every exposition/federation snapshot — the mutation hot
        paths pay nothing. Lock-free reads: dict/deque sizes are
        approximate by nature here and a torn read only skews one sample."""
        from ray_tpu_torch.util import metric_defs, metrics

        g_ready = metric_defs.get("rtpu_scheduler_ready_queue_depth")
        g_inflight = metric_defs.get("rtpu_scheduler_inflight_tasks")
        g_pending = metric_defs.get("rtpu_scheduler_actor_pending_calls")
        g_pool = metric_defs.get("rtpu_worker_pool_size")
        g_ref = metric_defs.get("rtpu_refcount_entries")
        g_argpin = metric_defs.get("rtpu_refcount_arg_pin_entries")
        g_lin = metric_defs.get("rtpu_lineage_entries")
        g_linb = metric_defs.get("rtpu_lineage_bytes")
        g_nframes = metric_defs.get("rtpu_pipe_native_frames")
        g_nmsgs = metric_defs.get("rtpu_pipe_native_messages")
        g_ntrans = metric_defs.get("rtpu_pipe_native_refpin_transitions")
        # last reconciled native totals per worker id (the engine counts
        # bytes/messages off-GIL; the rtpu_pipe_* counters are advanced by
        # the DELTA here so scrapes stay correct with zero per-message
        # Python cost on the native path)
        native_seen: Dict[bytes, dict] = {}

        def collect():
            if self._shutdown:
                metrics.unregister_collector(collect)
                return
            g_ready.set(len(self.ready_tasks))
            inflight = 0
            pool = {"starting": 0, "idle": 0, "busy": 0}
            nstats = {"sent_frames": 0, "sent_msgs": 0, "recv_frames": 0,
                      "recv_msgs": 0, "refpin_transitions": 0}
            native_any = False
            live_wids = set()
            for ws in list(self.workers.values()):
                inflight += len(ws.inflight_specs)
                if ws.status in pool:
                    pool[ws.status] += 1
                if ws.npipe is not None:
                    native_any = True
                    live_wids.add(ws.worker_id.binary())
                    try:
                        st = ws.npipe.stats()
                        if not st:
                            st = native_seen.get(ws.worker_id.binary(), {})
                        for k in nstats:
                            nstats[k] += st.get(k, 0)
                        last = native_seen.setdefault(
                            ws.worker_id.binary(), {})
                        d_sb = st.get("sent_bytes", 0) - last.get(
                            "sent_bytes", 0)
                        d_sm = st.get("sent_msgs", 0) - last.get(
                            "sent_msgs", 0)
                        d_rb = st.get("recv_bytes", 0) - last.get(
                            "recv_bytes", 0)
                        # FRAMES, not sub-messages: the Python reader
                        # counts one "message" per received frame (a
                        # coalesced batch counts once, its size going to
                        # rtpu_pipe_batch_messages) — keep the native
                        # reconciliation on the same definition so the
                        # off/on msgs-per-task A/B stays comparable
                        d_rm = st.get("recv_frames", 0) - last.get(
                            "recv_frames", 0)
                        if d_sb or d_sm or d_rb or d_rm:
                            m = _pipe_metrics()
                            m["sent"]._inc_key((), d_sb)
                            m["recv"]._inc_key((), d_rb)
                            m["msgs"]._inc_key(_SENT_KEY, d_sm)
                            m["msgs"]._inc_key(_RECV_KEY, d_rm)
                        native_seen[ws.worker_id.binary()] = dict(st)
                    except Exception:
                        pass
            g_inflight.set(inflight)
            for k, v in pool.items():
                g_pool.set(v, tags={"state": k})
            # prune reconciliation state for departed workers (their
            # final deltas were taken while they were still listed)
            for wid in list(native_seen):
                if wid not in live_wids:
                    del native_seen[wid]
            if native_any:
                # monotonic-within-a-worker-set counters, sampled (the
                # contention-stats pattern): mean msgs/frame is the
                # coalescing factor the A/B bench reads
                g_nframes.set(nstats["sent_frames"],
                              tags={"direction": "sent"})
                g_nframes.set(nstats["recv_frames"],
                              tags={"direction": "recv"})
                g_nmsgs.set(nstats["sent_msgs"], tags={"direction": "sent"})
                g_nmsgs.set(nstats["recv_msgs"], tags={"direction": "recv"})
                g_ntrans.set(nstats["refpin_transitions"])
            g_pending.set(sum(
                len(i.pending_queue)
                for i in list(self.gcs.actors.values())))
            g_ref.set(len(self._pin_total))
            g_argpin.set(len(self._arg_pins))
            g_lin.set(len(self._lineage))
            g_linb.set(self._lineage_bytes)

        self._metrics_collector = collect
        metrics.register_collector(collect)

    # ------------------------------------------------------------------
    # log streaming
    # ------------------------------------------------------------------

    def _log_monitor_loop(self):
        import sys

        logs_dir = os.path.join(self.session_dir, "logs")
        offsets: Dict[str, int] = {}
        partial: Dict[str, bytes] = {}
        while not self._log_monitor_stop.wait(0.2):
            try:
                names = os.listdir(logs_dir)
            except OSError:
                continue
            for name in names:
                if not name.endswith(".log"):
                    continue
                path = os.path.join(logs_dir, name)
                pos = offsets.get(name, 0)
                try:
                    size = os.path.getsize(path)
                    if size <= pos:
                        continue
                    with open(path, "rb") as f:
                        f.seek(pos)
                        chunk = f.read(size - pos)
                    offsets[name] = size
                except OSError:
                    continue
                data = partial.pop(name, b"") + chunk
                lines = data.split(b"\n")
                if lines and lines[-1]:
                    partial[name] = lines[-1]  # keep the unterminated tail
                prefix = f"({name[:-4]}) "
                for line in lines[:-1]:
                    try:
                        sys.stdout.write(
                            prefix + line.decode("utf-8", "replace") + "\n")
                    except Exception:
                        pass
            try:
                sys.stdout.flush()
            except Exception:
                pass

    # ------------------------------------------------------------------
    # worker lifecycle
    # ------------------------------------------------------------------

    def _accept_loop(self):
        while not self._shutdown:
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):
                return
            try:
                kind, wid_bytes = conn.recv()
                assert kind == "hello"
            except Exception:
                conn.close()
                continue
            wid = WorkerID(wid_bytes)
            with self.lock:
                ws = self.workers.get(wid)
            if ws is None or ws.status == "dead":
                conn.close()
                continue
            ws.conn = conn
            ws.npipe = self._attach_native_pipe(conn)
            target = (self._native_reader_loop if ws.npipe is not None
                      else self._reader_loop)
            reader = threading.Thread(target=target, args=(ws,), daemon=True)
            ws.reader = reader
            reader.start()

    def _attach_native_pipe(self, conn):
        """The GIL-free engine for one worker connection, or None (kill
        switch RTPU_NATIVE_PIPE=0, missing/stale .so — hasattr-gated like
        rtpu_frag_stats, so a pre-pipe .so degrades to the Python path
        instead of crashing)."""
        if not config.get("native_pipe"):
            return None
        try:
            from ray_tpu_torch import _native

            if not _native.pipe_engine_available():
                return None
            return _native.NativePipe(
                conn.fileno(),
                coalesce_us=int(config.get("pipe_native_coalesce_us")))
        except Exception:
            logger.exception("native pipe attach failed; Python pipe path")
            return None

    def _zygote(self):
        """The fork-server spawner (see core/zygote.py), started lazily.
        Returns None when disabled or dead (callers fall back to exec)."""
        if not config.get("worker_zygote") or self._zygote_disabled:
            return None
        with self._zygote_lock:
            z = self._zygote_obj
            if z is not None and not z.dead:
                return z
            if z is not None and z.dead and not z.restartable:
                return None
            try:
                env = dict(os.environ)
                env.update(self.worker_env)
                if env.get("RTPU_WORKER_FULL_SITE") == "1":
                    return None  # full-site workers need the real exec path
                env["RTPU_WORKER"] = "1"
                env["RTPU_NODE_ID"] = self.node_id.hex()
                if self.labels:
                    from ray_tpu_torch.util.labels import format_labels

                    env["RTPU_NODE_LABELS"] = format_labels(self.labels)
                pkg_root = os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__))))
                env["PYTHONPATH"] = (pkg_root + os.pathsep
                                     + env.get("PYTHONPATH", ""))
                self._zygote_obj = _Zygote(env)
                if z is not None:  # a previous fork-server died
                    self._m_zygote_restarts._inc_key(())
                return self._zygote_obj
            except Exception:
                logger.exception("zygote start failed; exec spawning only")
                # latch the failure: a crashing bootstrap must not re-pay
                # its boot timeout on every subsequent spawn
                self._zygote_disabled = True
                self._zygote_obj = None
                return None

    def _spawn_worker(self, kind: str) -> _WorkerState:
        with self.lock:
            if self._shutdown:
                raise RuntimeError("the runtime is shut down")
            self._spawns_in_flight += 1
        try:
            return self._spawn_worker_process(kind)
        finally:
            with self.lock:
                self._spawns_in_flight -= 1

    def _spawn_worker_process(self, kind: str) -> _WorkerState:
        import subprocess
        import sys

        # fast path: fork from the pre-warmed zygote (~5ms) instead of a
        # fresh interpreter exec (~0.15s CPU each, the actor/task launch
        # bottleneck on small hosts — VERDICT r3 #3)
        z = self._zygote()
        if z is not None:
            wid = WorkerID.from_random()
            log_path = os.path.join(self.session_dir, "logs",
                                    f"worker-{wid.hex()[:8]}.log")
            try:
                proc = z.spawn(wid.hex(), self._sock_addr, self.session,
                               log_path)
            except Exception:
                logger.exception("zygote spawn failed; falling back to exec")
            else:
                ws = _WorkerState(wid, proc, kind)
                ws.spawn_mode = "zygote"
                ws.log_path = log_path
                self._m_spawns._inc_key(_SPAWN_KEYS["zygote"])
                with self.lock:
                    self.workers[wid] = ws
                threading.Thread(target=self._reap, args=(ws,),
                                 daemon=True).start()
                self._note_spawn_event(ws)
                return ws

        wid = WorkerID.from_random()
        env = dict(os.environ)
        env.update(self.worker_env)
        env["RTPU_WORKER"] = "1"
        env["RTPU_NODE_ID"] = self.node_id.hex()
        if self.labels:
            # workers surface their node's labels (runtime context)
            from ray_tpu_torch.util.labels import format_labels

            env["RTPU_NODE_LABELS"] = format_labels(self.labels)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        log_path = os.path.join(self.session_dir, "logs", f"worker-{wid.hex()[:8]}.log")
        log_f = open(log_path, "wb", buffering=0)
        # The bootstrap ignores SIGUSR1 FIRST: a stack-dump signal landing
        # during interpreter boot must not kill the worker before its
        # faulthandler registers. Done in-child via -c (preexec_fn is
        # documented-unsafe in threaded parents); the literal
        # "ray_tpu_torch.core.worker" stays in the cmdline for discovery.
        #
        # -S spawn (the actor/task launch-latency fix): a sitecustomize
        # may import heavy packages into EVERY python process, so we skip
        # site processing and re-add site-packages by hand (addsitedir
        # handles .pth files). RTPU_WORKER_FULL_SITE=1 keeps the full-site
        # boot.
        full_site = env.get("RTPU_WORKER_FULL_SITE") == "1"
        if full_site:
            site_boot = ""
            py_flags = []
        else:
            dirs = ", ".join(repr(d) for d in _worker_site_dirs())
            site_boot = (f"import site; "
                         f"[site.addsitedir(d) for d in ({dirs},)]; ")
            py_flags = ["-S"]
        bootstrap = (
            "import signal; "
            "signal.signal(signal.SIGUSR1, signal.SIG_IGN); "
            + site_boot +
            "import runpy; "
            "runpy.run_module('ray_tpu_torch.core.worker', run_name='__main__')"
        )
        proc = subprocess.Popen(
            [
                sys.executable,
                *py_flags,
                "-c",
                bootstrap,
                "--addr",
                self._sock_addr,
                "--session",
                self.session,
                "--worker-id",
                wid.hex(),
            ],
            env=env,
            stdout=log_f,
            stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL,
        )
        log_f.close()
        ws = _WorkerState(wid, proc, kind)
        ws.log_path = log_path
        self._m_spawns._inc_key(_SPAWN_KEYS["exec"])
        with self.lock:
            self.workers[wid] = ws
        threading.Thread(target=self._reap, args=(ws,), daemon=True).start()
        self._note_spawn_event(ws)
        return ws

    def _note_spawn_event(self, ws: _WorkerState) -> None:
        """One worker_spawn lifecycle event per spawn (both paths)."""
        try:
            from ray_tpu_torch.util import events as _events

            _events.emit("worker_spawn",
                         worker_id=ws.worker_id.hex()[:8],
                         kind=ws.kind, spawn_mode=ws.spawn_mode,
                         pid=getattr(ws.proc, "pid", None))
        except Exception:
            pass

    def _reap(self, ws: _WorkerState):
        ws.proc.wait()
        if not self._shutdown:
            self._on_worker_death(ws)

    def _reader_loop(self, ws: _WorkerState):
        import pickle as _pickle

        while True:
            try:
                # recv_bytes + loads == conn.recv() internals, with the
                # framed size in hand for the pipe byte counters
                buf = ws.conn.recv_bytes()
                if buf[:4] == _REFPIN_MAGIC:
                    # packed borrow transitions (workers ship these
                    # whether or not the driver's native engine loaded)
                    self._apply_refpin_frame(ws, buf[4:])
                    continue
                msg = _pickle.loads(buf)
            except (EOFError, OSError):
                self._on_worker_death(ws)
                return
            try:
                m = _pipe_metrics()
                m["recv"]._inc_key((), len(buf))
                m["msgs"]._inc_key(_RECV_KEY)
                if msg[0] == "batch":
                    m["batch"].observe(len(msg[1]))
            except Exception:
                pass
            # r13 coalescing: workers ship bursts of casts (and the
            # piggybacked urgent message) as ONE framed batch. Each
            # sub-message keeps its own error isolation — one bad cast
            # must not swallow the piggybacked done/req behind it.
            for sub in (msg[1] if msg[0] == "batch" else (msg,)):
                try:
                    self._handle_msg(ws, sub)
                except Exception:
                    import traceback

                    traceback.print_exc()

    def _apply_refpin_frame(self, ws: _WorkerState, payload: bytes) -> None:
        """Python-fallback twin of the native refpin table: parse a packed
        (id[16] + i8 delta)* frame and apply each transition in order."""
        import struct as _struct

        for oid_b, d in _struct.iter_unpack("<16sb", payload):
            self.worker_ref_delta(ws, oid_b, d)

    def _native_reader_loop(self, ws: _WorkerState):
        """Drain thread over the GIL-free engine: the engine's receiver
        thread already did the length-prefix reads, batch unpacking and
        refpin bookkeeping; this thread wakes per BURST (not per message),
        unpickles, and dispatches. Refpin-transition records go through
        the lock-free ``_native_cb_*`` callback and are applied at the
        explicit drain point below — never inside the callback."""
        import pickle as _pickle

        from ray_tpu_torch import _native

        np_ = ws.npipe
        # metric handles hoisted out of the wake loop (a test's
        # clear_registry orphans them at worst — lost samples, not
        # errors; the byte/message counters are reconciled freshly by
        # the exposition collector either way), and the drain-shape
        # histogram is sampled 1-in-16 wakes
        try:
            m = _pipe_metrics()
        except Exception:
            m = None
        wakes = 0
        while True:
            recs = np_.drain(timeout=0.5)
            if recs is None:  # EOF: worker gone (all records delivered)
                if ws.native_pin_q:
                    self._drain_native_pins(ws)
                try:
                    # stop the engine's sender thread now (join happens at
                    # driver shutdown — never from this drain thread);
                    # drain_pins in the death path below still works
                    np_.shutdown()
                except Exception:
                    pass
                self._on_worker_death(ws)
                return
            if not recs:
                if ws.native_pin_q:
                    self._drain_native_pins(ws)
                continue
            wakes += 1
            if m is not None and not (wakes & 15):
                try:
                    m["ndrain"].observe(len(recs))
                except Exception:
                    pass
            for typ, payload in recs:
                if typ == _native.REC_REFPINS:
                    # queue (lock-free callback contract) AND drain
                    # IMMEDIATELY: transitions must apply in record order
                    # relative to the messages around them — a +1 borrow
                    # deferred past a later 'done' in the same burst
                    # would re-open the 1->0->1 unpin race the worker
                    # prevents by sending pins first
                    self._native_cb_refpins(ws, payload)
                    self._drain_native_pins(ws)
                    continue
                try:
                    msg = _pickle.loads(payload)
                except Exception:
                    # a mis-framed/corrupt record must be LOUD — if it
                    # carried a done, its caller is now hung (rate limit:
                    # one line per drop burst is fine at this severity)
                    logger.exception(
                        "dropping unpicklable pipe record from worker "
                        "%s (%d bytes)", ws.worker_id.hex()[:8],
                        len(payload))
                    continue
                if msg[0] == "batch":
                    try:
                        if m is not None:
                            m["batch"].observe(len(msg[1]))
                    except Exception:
                        pass
                    subs = msg[1]
                else:
                    subs = (msg,)
                for sub in subs:
                    try:
                        self._handle_msg(ws, sub)
                    except Exception:
                        import traceback

                        traceback.print_exc()
            # the drain point: apply queued transitions with locks allowed
            if ws.native_pin_q:
                self._drain_native_pins(ws)

    def _native_cb_refpins(self, ws: _WorkerState, payload: bytes) -> None:
        """Callback the native receiver drain hands packed refpin
        transitions to. MUST stay lock-free (graftlint
        native-callback-lock-discipline): it only appends to the
        CONNECTION's pending queue; ``_drain_native_pins`` applies at
        the reader's drain point."""
        # graftlint: deque append is GIL-atomic; no locks by contract
        ws.native_pin_q.append(payload)

    def _drain_native_pins(self, ws: _WorkerState) -> None:
        """Apply refpin transitions queued by the native callback (the
        only place they may take ``_ref_lock``-family locks). The queue
        is per-worker and drained only by that connection's reader
        thread, so a +1 borrow can never be applied after a LATER 'done'
        of the same burst (another reader stealing from a shared queue
        could be preempted holding the +1 while this thread releases the
        matching arg pin)."""
        import struct as _struct

        while True:
            try:
                payload = ws.native_pin_q.popleft()
            except IndexError:
                return
            for oid_b, d in _struct.iter_unpack("<16sb", payload):
                # per-worker bookkeeping lives in the NATIVE table (see
                # _drop_worker_pins); only the node-level pin moves here
                self._pin_delta(oid_b, d)

    def _on_worker_death(self, ws: _WorkerState):
        with self.lock:
            if ws.status == "dead":
                return
            was = ws.status
            ws.status = "dead"
        try:
            self._m_deaths._inc_key(())
        except Exception:
            pass
        # Death forensics at the reaping site (event plane): exit
        # code/signal from the Popen/zygote exit report, stderr tail +
        # error lines + last USR1 stack from the worker's log file —
        # built ONCE here and shared by the worker_death lifecycle event
        # and the WorkerCrashedError/ActorDiedError users see.
        pm = None
        try:
            from ray_tpu_torch.util import events as _events

            # the pipe-EOF reader usually gets here BEFORE the reaper /
            # zygote exit report lands; the process is already dead, so
            # a short wait turns "unknown" into the real exit signal
            status = ws.proc.poll()
            if status is None:
                try:
                    status = ws.proc.wait(timeout=2.0)
                except Exception:
                    status = ws.proc.poll()
            pm = _events.build_postmortem(
                exit_status=status,
                log_path=ws.log_path,
                pid=getattr(ws.proc, "pid", None))
        except Exception:
            pm = None
        self._drop_worker_pins(ws)
        with self.lock:
            if not ws.released:
                self._release_locked(ws.held)
            spec = ws.current
            inflight = list(ws.inflight_specs.values())
            ws.inflight_specs.clear()
            ws.current = None
        try:
            from ray_tpu_torch.util import events as _events

            _events.emit(
                "worker_death",
                worker_id=ws.worker_id.hex()[:8],
                kind=ws.kind,
                spawn_mode=ws.spawn_mode,
                pid=getattr(ws.proc, "pid", None),
                actor_id=(ActorID(ws.actor_id).hex()
                          if ws.actor_id else None),
                task=((spec.get("name") or spec.get("method"))
                      if spec else None),
                task_id=(spec["task_id"].hex()[:16]
                         if spec and spec.get("task_id") else None),
                cause=(pm or {}).get("cause", "unknown"),
                postmortem=pm)
        except Exception:
            pass
        if spec is not None and spec["type"] == ts.ACTOR_CREATE:
            self._actor_process_died(ws, [], pm)
        elif ws.actor_id is not None:
            self._actor_process_died(ws, inflight, pm)
        elif spec is not None:
            if spec.get("retries_left", 0) > 0:
                spec["retries_left"] -= 1
                self._enqueue_ready(spec)
            else:
                if spec["task_id"] in self.cancelled:
                    err = cloudpickle.dumps(
                        TaskCancelledError("task was cancelled (force)"))
                else:
                    err = cloudpickle.dumps(
                        _worker_crashed_error(ws, spec, pm))
                for rid in spec["return_ids"]:
                    self.gcs.mark_error(ObjectID(rid), err)
        with self.lock:
            alive_pool = sum(
                1 for w in self.workers.values() if w.kind == "pool" and w.status != "dead"
            )
            need = (
                ws.kind == "pool"
                and (self.ready_tasks or was == "busy")
                and alive_pool < self.pool_cap
            )
            shutdown = self._shutdown
        if need and not shutdown:
            self._spawn_worker("pool")
        self._pump()

    def _actor_process_died(self, ws: _WorkerState,
                            inflight_specs: List[dict],
                            pm: Optional[dict] = None):
        aid = ws.actor_id or next(
            (s.get("actor_id") for s in inflight_specs if s.get("actor_id")),
            None)
        if aid is None:
            return
        info = self.gcs.get_actor(ActorID(aid))
        if info is None:
            return
        err = cloudpickle.dumps(_actor_died_error(ActorID(aid).hex(), pm))
        for s in inflight_specs:
            for rid in s["return_ids"]:
                self.gcs.mark_error(ObjectID(rid), err)
        with self.lock:
            info.inflight = 0
            if info.restarts < info.max_restarts or info.max_restarts == -1:
                info.restarts += 1
                info.state = "RESTARTING"
                restart = True
            else:
                restart = False
        try:
            from ray_tpu_torch.util import events as _events

            if restart:
                _events.emit("actor_restart",
                             actor_id=ActorID(aid).hex(),
                             restarts=info.restarts,
                             max_restarts=info.max_restarts,
                             worker_id=ws.worker_id.hex()[:8],
                             cause=(pm or {}).get("cause", "unknown"))
            else:
                _events.emit("actor_death",
                             actor_id=ActorID(aid).hex(),
                             restarts=info.restarts,
                             worker_id=ws.worker_id.hex()[:8],
                             cause=(pm or {}).get("cause", "unknown"),
                             postmortem=pm)
        except Exception:
            pass
        if restart:
            new_ws = self._spawn_worker("actor")
            new_ws.actor_id = aid
            info.worker_id = new_ws.worker_id
            create_spec = dict(info.create_spec)
            new_ws.pending_spec = create_spec
            # the dead process's holdings were released on death; the
            # restarted actor re-holds its creation resources (forced as a
            # fallback: a restart must not deadlock on a transiently busy
            # node — accounting catches up as other work finishes)
            res = create_spec.get("resources") or {}
            with self.lock:
                held = self._acquire_locked(res, create_spec.get("pg"),
                                     create_spec.get("bundle_index", -1))
                if held is None:
                    held = dict(res)
                    self._acquire_forced_locked(held)
                new_ws.held = held
        else:
            self._mark_actor_dead_and_flush(ActorID(aid), "process died", err)

    def _mark_actor_dead_and_flush(self, actor_id: ActorID, cause: str, err_blob: bytes):
        """Mark an actor DEAD and fail every queued method call — otherwise
        callers blocked on queued refs would hang forever."""
        info = self.gcs.get_actor(actor_id)
        self.gcs.mark_actor_dead(actor_id, cause)
        if self.cluster is not None:
            self.cluster.publish_actor_state(actor_id.binary(), "DEAD")
        if info is None:
            return
        with self.lock:
            queued = list(info.pending_queue)
            info.pending_queue.clear()
        for q in queued:
            for rid in q["return_ids"]:
                self.gcs.mark_error(ObjectID(rid), err_blob)

    # ------------------------------------------------------------------
    # message handling (driver side)
    # ------------------------------------------------------------------

    def _handle_msg(self, ws: _WorkerState, msg):
        kind = msg[0]
        if kind == "ready":
            # chaos plane: workers spawned after failpoints.arm() must be
            # armed too, before their first dispatch
            specs = getattr(self, "_fp_specs", None)
            if specs is not None:
                try:
                    ws.send(("fp", specs))
                except (OSError, BrokenPipeError):
                    pass
            # trace plane: workers spawned after enable_tracing() must be
            # armed before their first dispatch, like failpoints above
            tpush = getattr(self, "_trace_push", None)
            if tpush is not None:
                try:
                    ws.send(("trace", tpush))
                except (OSError, BrokenPipeError):
                    pass
            # profiling plane: same replay for enable_profiling()
            ppush = getattr(self, "_profile_push", None)
            if ppush is not None:
                try:
                    ws.send(("prof", ppush))
                except (OSError, BrokenPipeError):
                    pass
            # event plane: same replay for enable/disable_events()
            epush = getattr(self, "_event_push", None)
            if epush is not None:
                try:
                    ws.send(("events", epush))
                except (OSError, BrokenPipeError):
                    pass
            with self.lock:
                was_starting = ws.status == "starting"
                if was_starting:
                    ws.status = "idle"
                pending = ws.pending_spec
                ws.pending_spec = None
            if was_starting:
                # worker launch latency: spawn decision -> ready message
                # (the zygote-vs-exec attribution for actors_launched/s)
                try:
                    self._m_spawn_lat._observe_key(
                        _SPAWN_KEYS[ws.spawn_mode],
                        time.monotonic() - ws.spawn_ts)
                except Exception:
                    pass
            if pending is not None:
                self._dispatch_to(ws, pending)
            else:
                self._pump()
        elif kind == "done":
            self._handle_done(ws, msg[1], msg[2],
                              msg[3] if len(msg) > 3 else None)
        elif kind == "cast":
            self._handle_cast(ws, msg[1], msg[2])
        elif kind == "req":
            self._handle_req(ws, msg[1], msg[2], msg[3])

    def _handle_done(self, ws: _WorkerState, task_id_b: bytes, results,
                     phases: Optional[dict] = None):
        with self.lock:
            spec = ws.inflight_specs.pop(task_id_b, None)
        if spec is None:
            # Every dispatch path goes through _dispatch_to, which populates
            # inflight_specs — an unknown id is a duplicate or late "done"
            # and must not be re-processed against an unrelated spec
            # (double-decrementing actor inflight, re-marking objects).
            logger.warning("dropping done for unknown task %s from worker %s",
                           task_id_b.hex()[:8], ws.worker_id.hex()[:8])
            return
        failed = bool(results and results[0][1] == "e")
        # retry_exceptions (reference ``@ray.remote(retry_exceptions=...)``):
        # an APPLICATION failure resubmits the task instead of surfacing,
        # while retries last. Plain tasks only — actor calls mutate state
        # and streaming tasks already announced yields; cancelled tasks
        # must surface TaskCancelledError, never re-run.
        retrying = (failed and spec["type"] == ts.TASK
                    and spec.get("retry_exceptions")
                    and spec.get("retries_left", 0) > 0
                    and not spec.get("streaming")
                    and spec["task_id"] not in self.cancelled)
        rex = spec.get("retry_exceptions")
        if retrying and isinstance(rex, bytes):
            # reference list form (cloudpickled tuple of types, see
            # make_task_spec): retry ONLY those — anything else is
            # intentionally fatal and must surface. The shipped payload
            # wraps the user exception in TaskError; match the cause.
            try:
                err = cloudpickle.loads(results[0][2])
                cause = getattr(err, "cause", err)
                retrying = isinstance(cause, cloudpickle.loads(rex))
            except Exception:
                retrying = False
        if retrying:
            spec["retries_left"] = spec.get("retries_left", 0) - 1
        else:
            self._apply_done_results(
                results, owner="worker:" + ws.worker_id.hex()[:8])
        fire = []
        with self._stream_cv:
            self._stream_consumed.pop(task_id_b, None)
            kept = []
            for tid, need, rep in self._stream_waiters:
                if tid == task_id_b:
                    fire.append(rep)  # task over: release any blocked producer
                else:
                    kept.append((tid, need, rep))
            self._stream_waiters = kept
        for rep in fire:
            rep(True)
        start = self._task_start_ts.pop(task_id_b, None)
        if start is not None and len(self.timeline_events) < 200_000:
            name = (spec or {}).get("name") or (spec or {}).get("method") or "task"
            tid_lane = ws.worker_id.hex()[:8]
            self.timeline_events.append(
                {
                    "name": name,
                    "ph": "X",
                    "ts": start * 1e6,
                    "dur": (time.time() - start) * 1e6,
                    "pid": 1,
                    "tid": tid_lane,
                }
            )
            if phases:
                # nested lifecycle slices: Chrome-trace nests same-lane X
                # events by containment, so the worker-side phase durations
                # laid out sequentially from dispatch render as children of
                # the task slice. Sub-millisecond phases are skipped — they
                # are invisible at trace zoom and would swell the event
                # list ~5x on microbench-style task storms.
                t = start
                for ph in ("arg_fetch", "deserialize", "execute",
                           "store_result"):
                    d = phases.get(ph)
                    if not d:
                        continue
                    if d >= 1e-3:
                        self.timeline_events.append(
                            {"name": f"{name}:{ph}", "ph": "X",
                             "ts": t * 1e6, "dur": d * 1e6, "pid": 1,
                             "tid": tid_lane, "cat": "task_phase"})
                    t += d
        if spec is not None and start is not None and self._flight_enabled:
            self._record_flight(spec, ws, start, phases, failed=failed)
        with self.lock:
            if not ws.inflight_specs:
                ws.current = None
            is_create = spec is not None and spec["type"] == ts.ACTOR_CREATE
            is_method = spec is not None and spec["type"] == ts.ACTOR_METHOD
            if is_method or (is_create and not failed):
                # actors HOLD their creation resources while alive (Ray
                # parity: num_cpus/custom resources gate actor packing,
                # not just __init__); method calls acquire nothing, so
                # there is nothing to release either. Death/kill releases
                # via _on_worker_death.
                if ws.released:
                    self._acquire_forced_locked(ws.held)
            else:
                if not ws.released:
                    self._release_locked(ws.held)
                ws.held = {}
            ws.released = False
            if spec is not None and spec["type"] == ts.ACTOR_CREATE:
                info = self.gcs.get_actor(ActorID(spec["actor_id"]))
                if info is not None:
                    if failed:
                        info.state = "DEAD"
                    else:
                        info.state = "ALIVE"
                    if self.cluster is not None:
                        self.cluster.publish_actor_state(
                            spec["actor_id"], info.state)
                ws.status = "idle"
            elif spec is not None and spec["type"] == ts.ACTOR_METHOD:
                info = self.gcs.get_actor(ActorID(spec["actor_id"]))
                if info is not None:
                    info.inflight = max(0, info.inflight - 1)
                ws.status = "idle" if not ws.inflight_specs else "busy"
            else:
                ws.status = "idle"
        if spec is not None and spec["type"] == ts.ACTOR_CREATE and failed:
            self._mark_actor_dead_and_flush(
                ActorID(spec["actor_id"]), "creation task failed", results[0][2]
            )
        if retrying:
            logger.info("retrying task %s after application error "
                        "(%d retries left)", task_id_b.hex()[:8],
                        spec.get("retries_left", 0))
            self._enqueue_ready(spec)
        self._pump()

    def _apply_done_results(self, results, owner: str = "") -> None:
        """Publish one done message's results to the object directory."""
        for entry in results:
            rid, rkind, payload = entry[0], entry[1], entry[2]
            oid = ObjectID(rid)
            if owner:
                self._note_obj_meta(rid, owner)
            # refs nested in the RESULT: pin them against the return
            # object's lifetime BEFORE marking ready (a consumer must
            # never observe the outer ready while inner refs are freeable)
            if len(entry) > 3 and entry[3]:
                self._pin_result_refs(rid, entry[3])
            if rkind == "i":
                self.gcs.mark_ready(oid, inline=payload)
            elif rkind == "s":
                # payload = segment size (directory needs it so peers can
                # pick chunked vs whole-blob pulls)
                self.gcs.mark_ready(oid, size=payload or 0)
            else:
                self.gcs.mark_error(oid, payload)

    # ------------------------------------------------------------------
    # task-lifecycle flight recorder
    # ------------------------------------------------------------------

    def _phase_metrics(self):
        if self._phase_hist is None:
            from ray_tpu_torch.util import metric_defs

            # racing first-finishers both create; registration merges, so
            # samples land in one shared store either way
            self._phase_hist = metric_defs.get("rtpu_task_phase_seconds")
            self._finished_counter = metric_defs.get(
                "rtpu_tasks_finished_total")
        return self._phase_hist

    def _record_flight(self, spec: dict, ws: _WorkerState, start_ts: float,
                       wphases: Optional[dict], failed: bool) -> None:
        """One finished task -> phase histograms + ring-buffer record.
        Driver-side phases (queue = dependency wait, lease = wait for a
        worker) come from the spec's lifecycle stamps; worker-side phases
        ride the done message. Everything here is dict/list work — no
        syscalls on the result path."""
        now = time.time()
        ph: Dict[str, float] = {}
        sub = spec.get("lc_submit")
        rdy = spec.get("lc_ready")
        if sub is not None and rdy is not None:
            ph["queue"] = max(0.0, rdy - sub)
        if rdy is not None:
            ph["lease"] = max(0.0, start_ts - rdy)
        if wphases:
            ph.update(wphases)
        ph["total"] = max(0.0, now - (sub if sub is not None else start_ts))
        try:
            hist = self._phase_metrics()
            keys = self._phase_keys
            hist.observe_many(
                (keys.get(k) or keys.setdefault(k, (("phase", k),)), v)
                for k, v in ph.items())
            self._finished_counter._inc_key(self._status_keys[failed])
        except Exception:
            pass
        # raw ids here; state.list_task_events hexes at query time (the
        # conversion is per-query, not per-task)
        self.task_ring.append({
            "task_id": spec["task_id"],
            "name": spec.get("name") or spec.get("method") or "task",
            "type": spec["type"],
            "worker_id": ws.worker_id,
            "status": "error" if failed else "ok",
            "phases": ph,
            "ts": now,
        })

    def _handle_cast(self, ws: _WorkerState, op: str, args):
        if op == "put":
            oid = ObjectID(args[0])
            # size rides the message (worker had it in hand at write time)
            size = args[2] if len(args) > 2 and args[1] is None else 0
            if len(args) > 3 and args[3]:
                # refs nested in the stored value: owner-pinned until the
                # outer object is freed
                self._pin_result_refs(args[0], args[3])
            self._note_obj_meta(
                args[0], "worker:" + ws.worker_id.hex()[:8],
                args[4] if len(args) > 4 else None)
            self.gcs.mark_ready(oid, inline=args[1], size=size)
        elif op == "submit":
            if self.cluster is not None:
                # placement may consult the GCS (dependency locality):
                # never block the worker-pipe receiver on the network
                self.cluster._io.submit(self.submit_spec, args[0])
            else:
                self.submit_spec(args[0])
        elif op == "actor_call":
            self._submit_actor_spec(args[0])
        elif op == "fn_put":
            self.gcs.register_fn(args[0], args[1])
            if self.cluster is not None:
                # publish to the global table too (worker-submitted specs
                # may spill to peers); async — this receiver thread must
                # keep demuxing, and consumers poll fetch_fn meanwhile
                self.cluster.publish_fn_async(args[0], args[1])
        elif op == "blocked":
            with self.lock:
                if not ws.released and ws.current is not None:
                    self._release_locked(ws.held)
                    ws.released = True
            self._pump()
        elif op == "unblocked":
            with self.lock:
                if ws.released:
                    self._acquire_forced_locked(ws.held)
                    ws.released = False
        elif op == "kill_actor":
            self.kill_actor(args[0], args[1])
        elif op == "cancel":
            self.cancel_task(ObjectID(args[0]),
                             args[1] if len(args) > 1 else False)
        elif op == "stream_consumed":
            self.stream_consumed(args[0], args[1],
                                 args[2] if len(args) > 2 else None)
        elif op == "refpins":
            # batched borrow transitions (r13 coalescing): list order IS
            # transition order, applied sequentially
            for oid_b, d in args[0]:
                self.worker_ref_delta(ws, oid_b, d)
        elif op == "metrics":
            # batched metric-delta push from the worker (federation): pure
            # dict merges — safe on this receiver thread
            from ray_tpu_torch.util.metrics import federation

            wid = ws.worker_id.hex()[:8]
            federation.ingest(
                "worker:" + wid,
                {"worker_id": wid, "node_id": self.node_id.hex()[:8],
                 "component": "worker"},
                args[0])
        elif op == "spans":
            # trace plane: batched span push from the worker — pure deque
            # appends into the bounded TraceStore, safe on this thread
            try:
                self.trace_store.ingest(
                    args[0],
                    {"worker_id": ws.worker_id.hex()[:8],
                     "node_id": self.node_id.hex()[:8],
                     "component": "worker"})
            except Exception:
                pass
        elif op == "prof":
            # profiling plane: batched profile push from the worker —
            # pure deque appends into the bounded ProfileStore
            try:
                self.profile_store.ingest(
                    args[0],
                    {"worker_id": ws.worker_id.hex()[:8],
                     "node_id": self.node_id.hex()[:8],
                     "component": "worker"})
            except Exception:
                pass
        elif op == "events":
            # event plane: batched lifecycle-event push from the worker —
            # pure deque appends into the bounded EventStore
            try:
                self.event_store.ingest(
                    args[0],
                    {"worker_id": ws.worker_id.hex()[:8],
                     "node_id": self.node_id.hex()[:8],
                     "component": "worker"})
            except Exception:
                pass
        elif op == "device":
            # device plane: version-gated program-registry snapshot from
            # the worker — replace semantics keyed by worker origin
            try:
                self.device_store.ingest(
                    ws.worker_id.hex()[:8],
                    {"worker_id": ws.worker_id.hex()[:8],
                     "node_id": self.node_id.hex()[:8],
                     "component": "worker"},
                    args[0])
            except Exception:
                pass
        elif op == "stacks":
            # live stack-dump reply (`ray_tpu_torch stack` py-spy role)
            self._stack_replies[ws.worker_id.binary()] = {
                "ts": time.monotonic(), "stacks": args[0]}
        elif op == "free":
            # full free path (directory + store + CLUSTER publication):
            # a worker-initiated free must reach holder nodes too, or the
            # streaming reducers' frees leak remote copies cluster-wide
            self.free(args[0])

    def _handle_req(self, ws: _WorkerState, req_id: int, op: str, args):
        def reply(payload, err: Optional[BaseException] = None):
            try:
                if err is not None:
                    ws.send(("reply", req_id, "err", cloudpickle.dumps(err)))
                else:
                    ws.send(("reply", req_id, "ok", payload))
            except (OSError, BrokenPipeError):
                pass

        try:
            if op == "get":
                # (a third argument, the worker's cluster-pull alignment
                # hints, has no use until cluster/ is ported)
                ids, timeout = args[0], args[1]
                self._async_get(ids, timeout, reply)
            elif op == "wait":
                ids, num_returns, timeout = args
                self._async_wait(ids, num_returns, timeout, reply)
            elif op == "stream_permit":
                tid, need = args[0], args[1]
                with self._stream_cv:
                    if (self._stream_consumed.get(tid, 0) >= need
                            or self._shutdown):
                        fire = True
                    else:
                        self._stream_waiters.append((tid, need, reply))
                        fire = False
                if fire:
                    reply(True)
            elif op == "reconstruct":
                # blocks until the producer re-ran: always off the
                # receiver thread
                def _rec(b=args[0]):
                    return self.reconstruct_object(ObjectID(b))

                def run():
                    try:
                        reply(_rec())
                    except BaseException as e:  # noqa: BLE001
                        reply(None, e)

                threading.Thread(target=run, daemon=True).start()
            elif op == "fn_get":
                def _fn_get(h=args[0]):
                    blob = self.gcs.get_fn(h)
                    if blob is None and self.cluster is not None:
                        blob = self.cluster.fetch_fn(h)
                        if blob is not None:
                            self.gcs.register_fn(h, blob)
                    return blob

                # may hit the cluster GCS: keep it off the receiver thread
                self._reply_offloaded(reply, _fn_get)
            elif op == "actor_create":
                self.submit_spec(args[0])
                reply(None)
            elif op == "name_lookup":
                # lookup_named_actor falls through to the cluster registry,
                # so workers resolve actors created on peer nodes too;
                # cluster mode offloads the network hop off this receiver
                # thread (it must keep demuxing results)
                self._reply_offloaded(
                    reply, lambda: self.lookup_named_actor(args[0]))
            elif op == "kv":
                # kv_op routes to the global GCS in cluster mode — worker
                # writes must land in the same store driver reads hit
                self._reply_offloaded(
                    reply, lambda: self.kv_op(args[0], *args[1:]))
            elif op == "actor_depths":
                reply(self.actor_queue_depths(args[0]))
            elif op == "resources":
                with self.lock:
                    reply(dict(self.avail if args[0] == "avail" else self.total))
            elif op == "nodes":
                reply(self.node_info())
            elif op == "pg_create":
                # cluster mode reserves bundles over the network: offload
                self._reply_offloaded(
                    reply,
                    lambda: self.create_placement_group(args[0], args[1]))
            elif op == "pg_remove":
                def _rm(pg_id=args[0]):
                    self.remove_placement_group(pg_id)

                self._reply_offloaded(reply, _rm)
            else:
                reply(None, RuntimeError(f"unknown op {op}"))
        except BaseException as e:  # noqa: BLE001
            reply(None, e)

    # ------------------------------------------------------------------
    # object reference pins
    # ------------------------------------------------------------------

    def _pin_delta(self, oid_b: bytes, d: int) -> None:
        if self._shutdown:
            return
        with self._ref_lock:
            self._apply_pin_locked(oid_b, d)
        self._flush_ref_casts()
        self._drain_deferred_unpins()
        self._drain_local_pin_releases()

    def _after_ref_unpins(self) -> None:
        """Post-drain hook of the deferred __del__ unpins."""
        self._flush_ref_casts()
        self._drain_local_pin_releases()

    def _drain_local_pin_releases(self) -> None:
        while True:
            try:
                # graftlint: disable=unguarded-shared-write -- deque ops are
                # GIL-atomic; the drain is deliberately lock-free (GC-safety
                # design, refqueue.py: __del__ hooks must take no locks)
                b = self._local_pin_releases.popleft()
            except IndexError:
                return
            try:
                self.store.release(ObjectID(b))
            except Exception:
                pass

    def _apply_pin_locked(self, oid_b: bytes, d: int) -> None:
        before = self._pin_total.get(oid_b, 0)
        after = before + d
        if after > 0:
            self._pin_total[oid_b] = after
        else:
            self._pin_total.pop(oid_b, None)
            if before > 0:
                # last local reference gone: queue the store-pin drop
                # (executed outside _ref_lock; view-liveness guarded)
                self._local_pin_releases.append(oid_b)
        # record the transition INSIDE the lock (pin/unpin casts must reach
        # the directory in transition order or a 1->0->1 race could leave a
        # live object unpinned remotely); the network cast itself happens
        # outside via _flush_ref_casts — rpc IO under _ref_lock widened the
        # GC self-deadlock window (advisor r3)
        if self.cluster is not None:
            if before == 0 and after > 0:
                self._cast_flusher.append((oid_b, 1))
            elif before > 0 and after <= 0:
                self._cast_flusher.append((oid_b, -1))

    def _pin_result_refs(self, outer_b: bytes, nested) -> None:
        """Pin refs nested inside a stored value against the OUTER object's
        lifetime (reference borrowed-refs-in-returned-values role): without
        this, the producer dropping its local ObjectRefs lets the global
        refcount hit zero and the free-grace sweep deletes the inner object
        before a late consumer deserializes. Released on the outer's
        'freed' publication (or never, in local mode, where no pin-driven
        freeing exists). Idempotent per (outer, inner): a lineage re-run
        re-ships the same nested list."""
        # record AND pin in ONE critical section: releasing between them
        # lets a concurrent _release_result_ref_pins (freed publication)
        # pop the set before the +1 lands, leaking a permanent pin
        with self._ref_lock:
            have = self._result_ref_pins.setdefault(outer_b, set())
            fresh = [b for b in nested if b not in have]
            have.update(fresh)
            for b in fresh:
                self._apply_pin_locked(b, 1)
        self._flush_ref_casts()
        self._drain_deferred_unpins()

    def _release_result_ref_pins(self, outer_b: bytes) -> None:
        with self._ref_lock:
            nested = self._result_ref_pins.pop(outer_b, None)
            for b in nested or ():
                self._apply_pin_locked(b, -1)
        if nested:
            self._flush_ref_casts()

    def _drain_deferred_unpins(self) -> None:
        """Apply unpins queued by ObjectRef.__del__ (which must not lock)."""
        if not self._shutdown:
            self._deferred_unpins.drain()

    def _send_pin_cast(self, item) -> None:
        oid_b, op = item
        if op > 0:
            self.cluster.pin_object(oid_b)
        else:
            self.cluster.unpin_object(oid_b)

    def _flush_ref_casts(self) -> None:
        """Ship queued pin/unpin transitions to the directory, in order."""
        if self.cluster is None:
            # graftlint: disable=unguarded-shared-write -- OrderedCastFlusher
            # is internally synchronized (atomic deque + try-lock flusher)
            self._cast_flusher.clear()
            return
        self._cast_flusher.flush()

    def _ref_janitor_loop(self) -> None:
        """Bound unpin staleness on an otherwise-idle driver: __del__ only
        queues; this drains every couple of seconds. Event.wait, not
        time.sleep: the sampling profiler cannot see C-level sleeps, so a
        time.sleep here would read as 2s of busy driver CPU per tick."""
        while not self._shutdown:
            self._janitor_wake.wait(2.0)
            try:
                self._drain_deferred_unpins()
                self._drain_local_pin_releases()
            except Exception:
                pass

    def _pin_args(self, spec: dict) -> None:
        """Pin a spec's argument objects until its first return is
        terminal — a submitted task keeps its args alive even when the
        caller dropped every ObjectRef (reference 'submitted task
        reference' semantics)."""
        deps = ts.arg_refs(spec["args"], spec["kwargs"])
        borrowed = spec.get("borrowed") or []
        if (not deps and not borrowed) or not spec["return_ids"]:
            return
        key = spec["return_ids"][0]
        with self._ref_lock:
            already = key in self._arg_pins
        if already:
            return  # resubmission (retry/reconstruction): pins survive
        dep_bytes = [d.binary() for d in deps] + list(borrowed)
        with self._ref_lock:
            self._arg_pins[key] = dep_bytes
        for b in dep_bytes:
            self._pin_delta(b, 1)

    def _release_arg_pins(self, oid: ObjectID) -> None:
        with self._ref_lock:
            deps = self._arg_pins.pop(oid.binary(), None)
        if deps:
            for b in deps:
                self._pin_delta(b, -1)

    def worker_ref_delta(self, ws, oid_b: bytes, d: int) -> None:
        """A worker reported a borrow transition (0<->1 in that process)."""
        if d > 0:
            ws.pinned[oid_b] = ws.pinned.get(oid_b, 0) + 1
        else:
            n = ws.pinned.get(oid_b, 0) - 1
            if n <= 0:
                ws.pinned.pop(oid_b, None)
            else:
                ws.pinned[oid_b] = n
        self._pin_delta(oid_b, d)

    def _drop_worker_pins(self, ws) -> None:
        pins = ws.pinned
        ws.pinned = {}
        for oid_b, n in pins.items():
            for _ in range(n):
                self._pin_delta(oid_b, -1)
        if ws.npipe is not None:
            # the native engine owns this connection's borrow table;
            # drain-and-clear it so a dead worker's pins release exactly
            # like the Python-path ws.pinned above
            try:
                native_pins = ws.npipe.drain_pins()
            except Exception:
                native_pins = []
            for oid_b, n in native_pins:
                # a positive native count surfaced exactly ONE +1
                # transition to _pin_total (0<->1 semantics): undo it once
                if n > 0:
                    self._pin_delta(oid_b, -1)

    # ------------------------------------------------------------------
    # lineage reconstruction
    # ------------------------------------------------------------------

    def _record_lineage(self, spec: dict) -> None:
        # approximate retained size: inlined arg blobs dominate
        approx = 256 + sum(
            len(e[1]) for e in list(spec["args"]) + list(spec["kwargs"].values())
            if e[0] == "v")
        with self.lock:
            for rid in spec["return_ids"]:
                self._lineage[rid] = spec
                self._lineage_sizes[rid] = approx
                self._lineage_bytes += approx
            # bounded FIFO by count AND bytes: evict oldest past either cap
            while (len(self._lineage) > self._lineage_cap
                   or self._lineage_bytes > self._lineage_max_bytes):
                old = next(iter(self._lineage))
                self._lineage.pop(old)
                self._lineage_bytes -= self._lineage_sizes.pop(old, 0)

    def reconstruct_object(self, oid: ObjectID,
                           timeout: float = 120.0) -> bool:
        """Re-execute the producer of a lost object (segment evicted or
        deleted behind the directory's back). Returns True when the object
        is terminal again.

        Deduplication is per PRODUCING TASK: concurrent callers for any of
        the task's return objects share one re-execution (per-object keys
        would let siblings of a multi-return task launch duplicate runs).
        Healthy sibling returns keep their segments — only lost ones are
        reset, and the store's idempotent put skips re-writing survivors.
        """
        b = oid.binary()
        with self.lock:
            spec = self._lineage.get(b)
            if spec is None:
                return False
            task_key = spec["task_id"]
            ev = self._reconstructing.get(task_key)
            if ev is not None:
                waiter_only = True
            else:
                ev = threading.Event()
                self._reconstructing[task_key] = ev
                waiter_only = False
        if waiter_only:
            ev.wait(timeout)
            st = self.gcs.object_state(oid)
            return st is not None and st.status in (READY, ERROR)
        try:
            logger.info("reconstructing lost object %s via task %s",
                        oid.hex()[:8], spec.get("name", "?"))
            respec = dict(spec)
            respec["retries_left"] = spec.get("max_retries", 0)
            # the original consumer is gone: a re-run producer waiting on
            # backpressure permits would park forever
            respec.pop("stream_backpressure", None)
            for rid in respec["return_ids"]:
                roid = ObjectID(rid)
                st = self.gcs.object_state(roid)
                inline = st is not None and st.inline is not None
                if not inline and not self.store.contains(roid):
                    self.gcs.reset_object(roid)
            self.submit_spec(respec)
            ready, _ = self.gcs.wait_objects([oid], 1, timeout)
            return bool(ready)
        finally:
            with self.lock:
                self._reconstructing.pop(task_key, None)
            ev.set()

    def _get_with_recovery(self, oid: ObjectID):
        try:
            return self.store.get(oid)
        except (FileNotFoundError, OSError):
            if not self.reconstruct_object(oid):
                raise
            st = self.gcs.object_state(oid)
            if st is not None and st.status == ERROR:
                raise cloudpickle.loads(st.error)
            if st is not None and st.inline is not None:
                return serialization.loads_oob(st.inline)
            return self.store.get(oid)

    def _reply_offloaded(self, reply, fn):
        """Run ``fn`` and reply — on the cluster io pool when in cluster
        mode (the call may hit the network), inline otherwise."""
        def run():
            try:
                reply(fn())
            except BaseException as e:  # noqa: BLE001
                reply(None, e)

        if self.cluster is not None:
            self.cluster._io.submit(run)
        else:
            run()

    # -- async get/wait used by worker requests ---------------------------

    def _object_payload(self, oid: ObjectID):
        st = self.gcs.object_state(oid)
        if st is None or st.status == "PENDING":
            return None
        if st.status == ERROR:
            return ("e", st.error)
        if st.inline is not None:
            return ("i", st.inline)
        return ("s", None)

    def _async_get(self, ids: List[bytes], timeout, reply):
        oids = [ObjectID(b) for b in ids]
        self._cluster_watch(oids)
        fired = threading.Event()
        timer_box = []

        def on_ready():
            if fired.is_set():
                return
            fired.set()
            for t in timer_box:
                t.cancel()
            reply([self._object_payload(o) for o in oids])

        waiter = self.gcs.add_waiter(oids, len(oids), on_ready)
        if timeout is not None:
            def on_timeout():
                if fired.is_set():
                    return
                fired.set()
                self.gcs.cancel_waiter(waiter)
                reply(None)

            t = threading.Timer(timeout, on_timeout)
            t.daemon = True
            timer_box.append(t)
            t.start()

    def _async_wait(self, ids: List[bytes], num_returns: int, timeout, reply):
        oids = [ObjectID(b) for b in ids]
        self._cluster_watch(oids)
        fired = threading.Event()
        timer_box = []

        def snapshot():
            ready, rest = [], []
            for o in oids:
                st = self.gcs.object_state(o)
                if st is not None and st.status in (READY, ERROR) and len(ready) < num_returns:
                    ready.append(o.binary())
                else:
                    rest.append(o.binary())
            return ready, rest

        def on_ready():
            if fired.is_set():
                return
            fired.set()
            for t in timer_box:
                t.cancel()
            reply(snapshot())

        waiter = self.gcs.add_waiter(oids, min(num_returns, len(oids)), on_ready)
        if timeout is not None:
            def on_timeout():
                if fired.is_set():
                    return
                fired.set()
                self.gcs.cancel_waiter(waiter)
                reply(snapshot())

            t = threading.Timer(timeout, on_timeout)
            t.daemon = True
            timer_box.append(t)
            t.start()

    # ------------------------------------------------------------------
    # resources
    # ------------------------------------------------------------------

    def _can_acquire(self, res: Dict[str, float], pg: Optional[bytes], bundle: int) -> bool:
        if pg is not None:
            pgs = self.pgs.get(pg)
            if pgs is None:
                return False
            if bundle >= 0:
                pool = pgs["bundles"].get(bundle)
                if pool is None:
                    return False  # bundle reserved on another node
                return all(pool.get(k, 0.0) >= v for k, v in res.items())
            # any-bundle: fits in some single locally-held bundle
            return any(
                all(b.get(k, 0.0) >= v for k, v in res.items())
                for b in pgs["bundles"].values()
            )
        return all(self.avail.get(k, 0.0) >= v for k, v in res.items())

    def _acquire_locked(self, res: Dict[str, float], pg: Optional[bytes], bundle: int) -> Optional[Dict[str, float]]:
        if not self._can_acquire(res, pg, bundle):
            return None
        if pg is not None:
            pgs = self.pgs[pg]
            idx = bundle
            if idx < 0:
                idx = next(
                    i
                    for i, b in sorted(pgs["bundles"].items())
                    if all(b.get(k, 0.0) >= v for k, v in res.items())
                )
            pool = pgs["bundles"][idx]
            for k, v in res.items():
                pool[k] = pool.get(k, 0.0) - v
            return {"__pg__": pg, "__bundle__": idx, **res}
        for k, v in res.items():
            self.avail[k] = self.avail.get(k, 0.0) - v
        return dict(res)

    def _release_locked(self, held: Dict[str, float]) -> None:
        if not held:
            return
        pg = held.get("__pg__")
        if pg is not None:
            pgs = self.pgs.get(pg)
            if pgs is None:
                return
            pool = pgs["bundles"][held["__bundle__"]]
            for k, v in held.items():
                if k.startswith("__"):
                    continue
                pool[k] = pool.get(k, 0.0) + v
            return
        for k, v in held.items():
            if k.startswith("__"):
                continue
            self.avail[k] = self.avail.get(k, 0.0) + v

    def _acquire_forced_locked(self, held: Dict[str, float]) -> None:
        pg = held.get("__pg__")
        if pg is not None:
            pgs = self.pgs.get(pg)
            if pgs is None:
                return
            pool = pgs["bundles"][held["__bundle__"]]
            for k, v in held.items():
                if not k.startswith("__"):
                    pool[k] = pool.get(k, 0.0) - v
            return
        for k, v in held.items():
            if not k.startswith("__"):
                self.avail[k] = self.avail.get(k, 0.0) - v

    # ------------------------------------------------------------------
    # placement groups
    # ------------------------------------------------------------------

    def create_placement_group(self, bundles: List[Dict[str, float]], strategy: str) -> bytes:
        from ray_tpu_torch.core.ids import PlacementGroupID

        pg_id = PlacementGroupID.from_random().binary()
        if self.cluster is not None:
            # cluster mode: bundles gang-reserve ACROSS nodes via 2-phase
            # prepare/commit (raises when infeasible, nothing reserved)
            self.cluster.create_pg(pg_id, [dict(b) for b in bundles],
                                   strategy)
            return pg_id
        with self.lock:
            scratch = dict(self.avail)
            for b in bundles:
                for k, v in b.items():
                    if scratch.get(k, 0.0) < v:
                        raise ValueError(
                            f"cannot reserve bundle {b}: insufficient {k} "
                            f"(avail {scratch.get(k, 0.0)})"
                        )
                    scratch[k] -= v
            for b in bundles:
                for k, v in b.items():
                    self.avail[k] -= v
            self.pgs[pg_id] = {
                "bundles": {i: dict(b) for i, b in enumerate(bundles)},
                "totals": {i: dict(b) for i, b in enumerate(bundles)},
                "strategy": strategy,
            }
            return pg_id

    def remove_placement_group(self, pg_id: bytes) -> None:
        if self.cluster is not None:
            self.cluster.remove_pg(pg_id)
            return
        self.pg_release_local(pg_id)

    # -- cluster-facing 2-phase reservation (called by the adapter / peers)

    def pg_prepare(self, pg_id: bytes,
                   bundle_map: Dict[int, Dict[str, float]]) -> bool:
        """Phase 1: atomically reserve this node's share of a group.
        Resources leave ``avail`` now so no concurrent task or competing
        group can take them before commit."""
        with self.lock:
            if pg_id in self._pg_staged or pg_id in self.pgs:
                return False  # duplicate prepare
            need: Dict[str, float] = {}
            for b in bundle_map.values():
                for k, v in b.items():
                    need[k] = need.get(k, 0.0) + v
            if not all(self.avail.get(k, 0.0) >= v for k, v in need.items()):
                return False
            for k, v in need.items():
                self.avail[k] -= v
            self._pg_staged[pg_id] = {
                "bundles": {int(i): dict(b) for i, b in bundle_map.items()},
                "ts": time.monotonic(),
            }
        return True

    def pg_commit(self, pg_id: bytes) -> bool:
        with self.lock:
            st = self._pg_staged.pop(pg_id, None)
            if st is None:
                return False
            ent = self.pgs.setdefault(
                pg_id, {"bundles": {}, "totals": {}, "strategy": ""})
            for i, b in st["bundles"].items():
                ent["bundles"][i] = dict(b)
                ent["totals"][i] = dict(b)
        self._pump()
        return True

    def pg_abort(self, pg_id: bytes) -> None:
        with self.lock:
            st = self._pg_staged.pop(pg_id, None)
            if st is None:
                return
            for b in st["bundles"].values():
                for k, v in b.items():
                    self.avail[k] = self.avail.get(k, 0.0) + v

    def pg_release_local(self, pg_id: bytes) -> None:
        """Release every bundle of ``pg_id`` held on THIS node."""
        self.pg_abort(pg_id)  # staged-but-uncommitted share, if any
        with self.lock:
            pgs = self.pgs.pop(pg_id, None)
            if pgs is None:
                return
            for b in pgs["totals"].values():
                for k, v in b.items():
                    self.avail[k] = self.avail.get(k, 0.0) + v

    def reap_stale_pg_stages(self, max_age_s: float = 30.0) -> None:
        """Abort prepared-but-never-committed reservations (creator died
        mid-protocol) so their resources don't leak."""
        now = time.monotonic()
        with self.lock:
            stale = [pid for pid, st in self._pg_staged.items()
                     if now - st["ts"] > max_age_s]
        for pid in stale:
            self.pg_abort(pid)

    # ------------------------------------------------------------------
    # submission + dispatch
    # ------------------------------------------------------------------

    def register_fn(self, h: str, blob: bytes):
        self.gcs.register_fn(h, blob)
        if self.cluster is not None:
            self.cluster.publish_fn(h, blob)

    def submit_spec(self, spec: dict) -> List[ObjectRef]:
        # flight-recorder stamp (setdefault: retries/reconstruction and
        # forwarded specs keep the ORIGINAL submit time)
        spec.setdefault("lc_submit", time.time())
        try:
            self._m_submitted._inc_key(self._type_keys[spec["type"]])
        except Exception:
            pass
        return self._traced_submit(spec, self._submit_spec_inner)

    def _traced_submit(self, spec: dict, inner) -> List[ObjectRef]:
        """Trace the DRIVER-SIDE submit work itself (reference
        tracing_helper role; near-zero cost when disabled): the span
        brackets dependency resolution + pinning + enqueue — the
        GIL-serialized control-plane CPU the multi-client inversion
        pays — so summarize_critical_path can print it per task. A spec
        that already carries trace_ctx was stamped by the submitting
        worker; the driver-side handling becomes a CHILD span."""
        from ray_tpu_torch.util import tracing

        if not tracing.tracing_enabled():
            return inner(spec)
        name = spec.get("name") or spec.get("method") or "task"
        parent = spec.get("trace_ctx")
        attrs = {"task_id": spec["task_id"].hex()}
        if parent:
            cm = tracing.span(f"driver.submit::{name}", attrs,
                              parent=parent)
        else:
            cm = tracing.span(f"submit::{name}", attrs)
        with cm as tp:
            if tp is not None:
                spec["trace_ctx"] = tp
            return inner(spec)

    def _submit_spec_inner(self, spec: dict) -> List[ObjectRef]:
        tid = TaskID(spec["task_id"])
        deps = ts.arg_refs(spec["args"], spec["kwargs"])
        self._pin_args(spec)
        if self.cluster is not None and self.cluster.maybe_forward_task(spec):
            # executes on a peer node; track refs locally + watch globally
            for rid in spec["return_ids"]:
                self.gcs.ensure_object(ObjectID(rid))
            return [ObjectRef(ObjectID(b), task_id=tid)
                    for b in spec["return_ids"]]
        if spec["type"] == ts.ACTOR_CREATE:
            info = ActorInfo(ActorID(spec["actor_id"]), spec)
            self.gcs.register_actor(info)
            if self.cluster is not None:
                self.cluster.publish_actor(spec["actor_id"], info.name)
        for rid in spec["return_ids"]:
            self.gcs.ensure_object(ObjectID(rid))
        if spec["type"] == ts.TASK and not spec.get("streaming"):
            self._record_lineage(spec)
        unresolved = [
            d for d in deps
            if (st := self.gcs.object_state(d)) is None or st.status == "PENDING"
        ]
        if unresolved:
            if self.cluster is not None:
                # deps may be produced on peer nodes: watch the global
                # directory so the local waiter can fire
                self.cluster.watch_many(unresolved)
            self.gcs.add_waiter(unresolved, len(unresolved), lambda: self._enqueue_ready(spec))
        else:
            self._enqueue_ready(spec)
        return [ObjectRef(ObjectID(b), task_id=tid) for b in spec["return_ids"]]

    def _submit_actor_spec(self, spec: dict) -> List[ObjectRef]:
        spec.setdefault("lc_submit", time.time())
        try:
            self._m_submitted._inc_key(self._type_keys[spec["type"]])
        except Exception:
            pass
        # same driver-side submit span as submit_spec (actor-call path)
        return self._traced_submit(spec, self._submit_actor_inner)

    def _submit_actor_inner(self, spec: dict) -> List[ObjectRef]:
        self._pin_args(spec)
        if (self.cluster is not None
                and self.gcs.get_actor(ActorID(spec["actor_id"])) is None
                and self.cluster.route_actor_call(spec)):
            # the actor lives on a peer node; refs tracked + watched there
            return [ObjectRef(ObjectID(b)) for b in spec["return_ids"]]
        for rid in spec["return_ids"]:
            self.gcs.ensure_object(ObjectID(rid))
        deps = ts.arg_refs(spec["args"], spec["kwargs"])
        unresolved = [
            d for d in deps
            if (st := self.gcs.object_state(d)) is None or st.status == "PENDING"
        ]
        if unresolved:
            if self.cluster is not None:
                self.cluster.watch_many(unresolved)
            self.gcs.add_waiter(
                unresolved, len(unresolved), lambda: self._enqueue_actor_call(spec)
            )
        else:
            self._enqueue_actor_call(spec)
        return [ObjectRef(ObjectID(b)) for b in spec["return_ids"]]

    def _enqueue_actor_call(self, spec: dict):
        info = self.gcs.get_actor(ActorID(spec["actor_id"]))
        if info is None or info.state == "DEAD":
            err = cloudpickle.dumps(ActorDiedError("actor is dead"))
            for rid in spec["return_ids"]:
                self.gcs.mark_error(ObjectID(rid), err)
            return
        spec["lc_ready"] = time.time()
        with self.lock:
            info.pending_queue.append(spec)
        self._pump()

    def _enqueue_ready(self, spec: dict):
        if spec["task_id"] in self.cancelled:
            err = cloudpickle.dumps(TaskCancelledError("task was cancelled"))
            for rid in spec["return_ids"]:
                self.gcs.mark_error(ObjectID(rid), err)
            return
        st0 = self.gcs.object_state(ObjectID(spec["return_ids"][0]))
        if st0 is not None and st0.status == ERROR:
            return  # cancelled while waiting for dependencies
        # propagate dependency errors without running the task
        err_blob = None
        for e in list(spec["args"]) + list(spec["kwargs"].values()):
            if e[0] == "r":
                st = self.gcs.object_state(ObjectID(e[1]))
                if st is not None and st.status == ERROR:
                    err_blob = st.error
                    break
        if err_blob is not None:
            for rid in spec["return_ids"]:
                self.gcs.mark_error(ObjectID(rid), err_blob)
            if spec["type"] == ts.ACTOR_CREATE:
                self._mark_actor_dead_and_flush(
                    ActorID(spec["actor_id"]), "creation args errored", err_blob
                )
            return
        spec["lc_ready"] = time.time()
        with self.lock:
            self.ready_tasks.append(spec)
        self._pump()

    def _attach_inline_args(self, spec: dict):
        def conv(e):
            if e[0] == "r":
                st = self.gcs.object_state(ObjectID(e[1]))
                if st is not None and st.inline is not None:
                    return ("ri", e[1], st.inline)
            return e

        spec["args"] = [conv(e) for e in spec["args"]]
        spec["kwargs"] = {k: conv(v) for k, v in spec["kwargs"].items()}

    def _dispatch_to(self, ws: _WorkerState, spec: dict):
        self._attach_inline_args(spec)
        try:
            self._m_dispatched._inc_key(())
        except Exception:
            pass
        with self.lock:
            ws.status = "busy"
            ws.current = spec
            ws.inflight_specs[spec["task_id"]] = spec
            ws.released = False
        self._task_start_ts[spec["task_id"]] = time.time()
        try:
            ws.send(("exec", spec))
        except (OSError, BrokenPipeError):
            self._on_worker_death(ws)

    def _pump(self):
        while True:
            dispatched = False
            with self.lock:
                if self._shutdown:
                    return
                # 1. ordinary tasks + actor creations from the ready queue
                for _ in range(len(self.ready_tasks)):
                    spec = self.ready_tasks.popleft()
                    if spec["task_id"] in self.cancelled:
                        err = cloudpickle.dumps(TaskCancelledError("task was cancelled"))
                        for rid in spec["return_ids"]:
                            self.gcs.mark_error(ObjectID(rid), err)
                        continue
                    res = spec.get("resources") or {}
                    held = self._acquire_locked(res, spec.get("pg"), spec.get("bundle_index", -1))
                    if held is None:
                        self.ready_tasks.append(spec)
                        continue
                    if spec["type"] == ts.ACTOR_CREATE:
                        # promote a prestarted idle POOL worker into the
                        # actor (reference worker_pool.h:159 prestart +
                        # dedicated-worker pop): the interpreter and
                        # jax-free imports are already warm, so actor
                        # creation skips the process cold-start entirely.
                        # An actor that asks for a GPU gets a fresh
                        # process instead: CUDA reads CUDA_VISIBLE_DEVICES
                        # once, at its first use in a process, and a pool
                        # worker's earlier tasks may already have made it
                        # read the hidden default.
                        ws = (None if res.get("GPU")
                              else self._claim_idle_pool_worker_locked())
                        info = self.gcs.get_actor(ActorID(spec["actor_id"]))
                        if ws is not None:
                            ws.kind = "actor"
                            ws.actor_id = spec["actor_id"]
                            if info is not None:
                                info.worker_id = ws.worker_id
                            ws.held = held
                            self._replenish_pool_locked()
                            target = (ws, spec)
                            dispatched = True
                            break
                        ws = self._spawn_worker_locked("actor")
                        ws.actor_id = spec["actor_id"]
                        if info is not None:
                            info.worker_id = ws.worker_id
                        ws.held = held
                        # worker hasn't dialed back yet; dispatch on "ready"
                        ws.pending_spec = spec
                        continue
                    ws = self._find_idle_pool_worker_locked()
                    if ws is None:
                        self._release_locked(held)
                        self.ready_tasks.append(spec)
                        continue
                    ws.held = held
                    target = (ws, spec)
                    dispatched = True
                    break
                else:
                    # 2. actor method calls (up to max_concurrency in
                    # flight per actor; >1 executes on worker threads)
                    target = None
                    for info in list(self.gcs.actors.values()):
                        if not info.pending_queue:
                            continue
                        if info.state not in ("ALIVE",):
                            continue
                        if info.inflight >= max(info.max_concurrency, 1):
                            continue
                        ws = self.workers.get(info.worker_id)
                        if ws is None or ws.status in ("starting", "dead"):
                            continue
                        if ws.status == "busy" and info.max_concurrency <= 1:
                            continue
                        spec = info.pending_queue.pop(0)
                        info.inflight += 1
                        # do NOT touch ws.held: the actor's CREATION
                        # resources stay held for its lifetime; method
                        # calls acquire nothing on top
                        target = (ws, spec)
                        dispatched = True
                        break
                if dispatched:
                    # claimed under the lock: _dispatch_to runs after it is
                    # released, and until then another thread's _pump must
                    # not see this worker idle and overwrite its held
                    # resources (each overwrite lost a CPU for good)
                    target[0].status = "busy"
            if not dispatched:
                return
            self._dispatch_to(*target)

    def _claim_idle_pool_worker_locked(self) -> Optional[_WorkerState]:
        """Scan-only variant (no spawn side effects) for actor promotion.
        _find_idle_pool_worker_locked delegates here so task dispatch and
        actor promotion share ONE definition of 'idle'."""
        for w in self.workers.values():
            if w.kind == "pool" and w.status == "idle":
                return w
        return None

    def _replenish_pool_locked(self) -> None:
        """Keep the warm-pool baseline after an actor promotion consumed a
        prestarted worker, so the NEXT actor creation is warm too."""
        n_warm = sum(
            1 for w in self.workers.values()
            if w.kind == "pool" and w.status in ("starting", "idle")
        ) + self._spawning
        n_pool = sum(
            1 for w in self.workers.values()
            if w.kind == "pool" and w.status != "dead"
        ) + self._spawning
        if n_warm < self._prestart and n_pool < self.pool_cap:
            self._spawning += 1
            threading.Thread(target=self._spawn_pool_async,
                             daemon=True).start()

    def _find_idle_pool_worker_locked(self) -> Optional[_WorkerState]:
        w = self._claim_idle_pool_worker_locked()
        if w is not None:
            return w
        n_pool = (
            sum(1 for w in self.workers.values() if w.kind == "pool" and w.status != "dead")
            + self._spawning
        )
        n_starting = (
            sum(1 for w in self.workers.values() if w.kind == "pool" and w.status == "starting")
            + self._spawning
        )
        # Spawn enough workers to drain the ready backlog (bounded by caps).
        want = len(self.ready_tasks) + 1 - n_starting
        want = min(want, self.pool_cap - n_pool, self.pool_hard_cap - n_pool)
        for _ in range(max(0, want)):
            self._spawning += 1
            threading.Thread(target=self._spawn_pool_async, daemon=True).start()
        return None

    def _spawn_pool_async(self):
        try:
            self._spawn_worker("pool")
        except RuntimeError:
            if not self._shutdown:
                raise
        finally:
            with self.lock:
                self._spawning -= 1

    def _spawn_worker_locked(self, kind: str) -> _WorkerState:
        # like _spawn_worker but callable with self.lock held (RLock)
        return self._spawn_worker(kind)

    # ------------------------------------------------------------------
    # public API surface (driver)
    # ------------------------------------------------------------------

    def _note_obj_meta(self, oid_b: bytes, owner: str,
                       site: Optional[str] = None) -> None:
        """Record creation metadata for `ray_tpu_torch memory` forensics:
        owner process, birth time, and (when the profiler is armed) the
        creating call-site. Bounded FIFO; pure dict work."""
        meta = self._obj_meta
        meta[oid_b] = {"owner": owner, "ts": time.time(), "site": site}
        while len(meta) > self._obj_meta_cap:
            meta.popitem(last=False)

    def put(self, value: Any) -> ObjectRef:
        oid = ObjectID.from_random()
        from ray_tpu_torch.core.object_ref import collect_serialized_refs

        with collect_serialized_refs() as nested:
            inline, size = self.store.put(oid, value)
        from ray_tpu_torch.util import profiling as _prof

        self._note_obj_meta(
            oid.binary(), "driver",
            _prof.caller_site() if _prof.profiling_enabled() else None)
        # ref BEFORE publishing ready: the pin cast precedes obj_ready on
        # the same connection, so the directory never sees this entry
        # terminal-and-unpinned
        ref = ObjectRef(oid)
        if nested:
            # nested refs live as long as the outer object (the caller may
            # drop its own ObjectRefs right after this put)
            self._pin_result_refs(oid.binary(), nested)
        self.gcs.mark_ready(oid, inline=inline,
                            size=0 if inline is not None else size)
        return ref

    def put_parts(self, data: bytes, buffers) -> ObjectRef:
        oid = ObjectID.from_random()
        inline, size = self.store.put_parts(oid, data, buffers)
        ref = ObjectRef(oid)
        self.gcs.mark_ready(oid, inline=inline,
                            size=0 if inline is not None else size)
        return ref

    def _cluster_watch(self, ids: List[ObjectID]) -> None:
        """Cluster mode: objects not terminal locally may be produced on a
        peer node — watch the global directory so local waiters can fire."""
        if self.cluster is None:
            return
        pending = [
            o for o in ids
            if (st := self.gcs.object_state(o)) is None or st.status == "PENDING"
        ]
        if pending:
            self.cluster.watch_many(pending)

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None):
        ids = [r.id for r in refs]
        self._cluster_watch(ids)
        ready, rest = self.gcs.wait_objects(ids, len(ids), timeout)
        if rest:
            raise GetTimeoutError(f"get timed out after {timeout}s; {len(rest)} pending")
        out = []
        for oid in ids:
            st = self.gcs.object_state(oid)
            if st.status == ERROR:
                raise cloudpickle.loads(st.error)
            if st.inline is not None:
                out.append(serialization.loads_oob(st.inline))
            else:
                out.append(self._get_with_recovery(oid))
        return out

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        ids = [r.id for r in refs]
        self._cluster_watch(ids)
        ready, rest = self.gcs.wait_objects(ids, num_returns, timeout)
        ready_set = set(ready)
        return (
            [r for r in refs if r.id in ready_set],
            [r for r in refs if r.id not in ready_set],
        )

    def submit(self, spec: dict) -> List[ObjectRef]:
        return self.submit_spec(spec)

    def create_actor(self, spec: dict):
        self.submit_spec(spec)

    def submit_actor_task(self, spec: dict) -> List[ObjectRef]:
        return self._submit_actor_spec(spec)

    def ensure_fn(self, h: str, blob: bytes):
        self.register_fn(h, blob)

    def kill_actor(self, actor_id: bytes, no_restart: bool = True):
        info = self.gcs.get_actor(ActorID(actor_id))
        if info is None:
            if self.cluster is not None:
                self.cluster.kill_remote_actor(actor_id, no_restart)
            return
        with self.lock:
            if no_restart:
                info.max_restarts = info.restarts  # exhaust restarts
            ws = self.workers.get(info.worker_id)
        if ws is not None and ws.status != "dead":
            try:
                ws.proc.terminate()
            except Exception:
                pass

    def cancel(self, ref: ObjectRef, force: bool = False):
        self.cancel_task(ref.id, force)

    def cancel_task(self, obj_id: ObjectID, force: bool = False):
        with self.lock:
            for spec in list(self.ready_tasks):
                if obj_id.binary() in spec["return_ids"]:
                    self.cancelled.add(spec["task_id"])
                    return
            # running: deliver cancellation into the worker (reference
            # execute_task_with_cancellation_handler, _raylet.pyx:2084) —
            # the worker raises TaskCancelledError in the task thread and
            # the normal done(error) path resolves the refs
            for ws in self.workers.values():
                for tid, spec in ws.inflight_specs.items():
                    if obj_id.binary() in spec["return_ids"]:
                        spec["retries_left"] = 0  # a cancelled task never retries
                        self.cancelled.add(tid)
                        if force:
                            try:
                                ws.proc.kill()
                            except Exception:
                                pass
                        else:
                            try:
                                ws.send(("cancel", tid))
                            except (OSError, BrokenPipeError):
                                pass
                        return
        # cluster mode: the task may be executing on a peer node (forwarded
        # task / routed actor call) — deliver the cancel THERE, where the
        # running worker lives (ADVICE r2: the fallback below would mark
        # the object cancelled while the remote task kept running)
        if (self.cluster is not None
                and self.cluster.cancel_remote(obj_id.binary(), force)):
            return
        err = cloudpickle.dumps(TaskCancelledError("task was cancelled"))
        st = self.gcs.object_state(obj_id)
        if st is not None and st.status == "PENDING":
            self.gcs.mark_error(obj_id, err)

    @property
    def cluster_node_id(self):
        """This node's cluster id (owner tag on streaming generators)."""
        return self.node_id.binary() if self.cluster is not None else None

    def stream_consumed(self, task_id: bytes, n: int, owner=None) -> None:
        fire = []
        advanced = False
        with self._stream_cv:
            if n > self._stream_consumed.get(task_id, 0):
                self._stream_consumed[task_id] = n
                advanced = True
            # bound the counter dict (late acks re-create entries) —
            # never evicting a stream with a parked producer
            if len(self._stream_consumed) > 10000:
                live = {tid for tid, _, _ in self._stream_waiters}
                for tid in list(self._stream_consumed):
                    if len(self._stream_consumed) <= 10000:
                        break
                    if tid not in live:
                        del self._stream_consumed[tid]
            kept = []
            for tid, need, rep in self._stream_waiters:
                if self._stream_consumed.get(tid, 0) >= need:
                    fire.append(rep)
                else:
                    kept.append((tid, need, rep))
            self._stream_waiters = kept
        if advanced and self.cluster is not None:
            # producer may be parked on a PEER node (forwarded/actor-routed
            # stream): relay the absolute count there, non-blocking. Only
            # on ADVANCE — an unconditional relay + a stale reciprocal
            # route pair would ping-pong the same ack forever.
            self.cluster.relay_stream_consumed(task_id, n, owner)
        for rep in fire:
            rep(True)

    def actor_queue_depths(self, actor_ids: List[bytes]) -> List[int]:
        """Queued + in-flight calls per actor — the TRUE load signal the
        serve router uses (reference keeps a replica-reported cache,
        replica_scheduler/common.py:218; here the scheduler's own view is
        authoritative and shared by every handle)."""
        out = []
        with self.lock:
            for b in actor_ids:
                info = self.gcs.get_actor(ActorID(b))
                out.append(0 if info is None
                           else len(info.pending_queue) + info.inflight)
        return out

    def lookup_named_actor(self, name: str):
        aid = self.gcs.lookup_named(name)
        if aid is None and self.cluster is not None:
            return self.cluster.lookup_named(name)
        return aid.binary() if aid else None

    def kv_op(self, op: str, *args):
        if self.cluster is not None:
            # cluster KV must be globally consistent across nodes
            return self.cluster.kv_op(op, *args)
        fn = {
            "put": self.gcs.kv_put,
            "get": self.gcs.kv_get,
            "del": self.gcs.kv_del,
            "keys": self.gcs.kv_keys,
        }[op]
        return fn(*args)

    def resources(self, which: str) -> Dict[str, float]:
        with self.lock:
            return dict(self.avail if which == "avail" else self.total)

    def free(self, ids: List[bytes]):
        for b in ids:
            oid = ObjectID(b)
            self.gcs.drop_object(oid)
            self._obj_meta.pop(b, None)
            self.store.delete(oid)
            if self.cluster is not None:
                self.cluster.gcs.cast("obj_drop", b)

    def node_info(self):
        if self.cluster is not None:
            nodes = self.cluster.node_info()
            if nodes:
                return nodes
        from ray_tpu_torch.util.host_stats import host_stats

        return [
            {
                "NodeID": self.node_id.hex(),
                "Alive": True,
                "Resources": dict(self.total),
                "alive": True,
                "stats": host_stats(),  # reporter-module role
            }
        ]

    def timeline(self):
        return list(self.timeline_events)

    def collect_trace_spans(self) -> None:
        """Drain this PROCESS's span ring into the runtime's TraceStore
        with origin labels — called at query time (state.list_spans) and
        before each heartbeat ships trace deltas, so driver/daemon spans
        join their workers' pushed batches."""
        from ray_tpu_torch.util import tracing

        batch = tracing.drain_ring()
        if not batch:
            return
        comp = "driver"
        if self.cluster is not None and not self.cluster.is_scheduler:
            comp = "raylet"
        self.trace_store.ingest(
            batch, {"node_id": self.node_id.hex()[:8], "component": comp})

    def collect_lifecycle_events(self) -> None:
        """Drain this PROCESS's event ring into the runtime's EventStore
        with origin labels — called at query time (state.list_events)
        and before each heartbeat ships event deltas, so driver/daemon
        events join their workers' pushed batches."""
        from ray_tpu_torch.util import events

        batch = events.drain_ring()
        if not batch:
            return
        comp = "driver"
        if self.cluster is not None and not self.cluster.is_scheduler:
            comp = "raylet"
        self.event_store.ingest(
            batch, {"node_id": self.node_id.hex()[:8], "component": comp})

    def fetch_local_logs(self, target: dict,
                         tail_bytes: Optional[int] = None) -> List[dict]:
        """Resolve a log-fetch target against THIS node's session logs
        (the daemon half of the log-federation rendezvous; also the
        single-node fast path). ``target``: ``{"worker_id": <hex>}`` for
        one worker's log, or ``{"node": True}`` for every log file of
        this node's session (daemon + workers, bounded). Live workers
        whose log file was deleted under them are read through
        ``/proc/<pid>/fd`` (the known failure mode on this box). Returns
        [] when the target resolves to nothing here — the head keeps
        only non-empty replies."""
        from ray_tpu_torch import config
        from ray_tpu_torch.util import events as _events

        if tail_bytes is None:
            tail_bytes = int(config.get("log_tail_bytes"))
        want_node = (target.get("node_id") or "").lower()
        if want_node and not self.node_id.hex().startswith(want_node[:8]):
            return []  # a node-scoped fetch for some other node
        logs_dir = os.path.join(self.session_dir, "logs")
        want_wid = (target.get("worker_id") or "").lower()
        rows: List[tuple] = []
        if want_wid:
            w8 = want_wid[:8]
            with self.lock:
                ws = next((w for w in self.workers.values()
                           if w.worker_id.hex().startswith(w8)), None)
            path = (ws.log_path if ws is not None and ws.log_path
                    else os.path.join(logs_dir, f"worker-{w8}.log"))
            pid = getattr(ws.proc, "pid", None) if ws is not None else None
            if ws is not None or os.path.exists(path):
                rows.append((f"worker:{w8}", path, pid))
        elif target.get("node"):
            try:
                for name in sorted(os.listdir(logs_dir))[:32]:
                    if name.endswith(".log"):
                        rows.append((name, os.path.join(logs_dir, name),
                                     None))
            except OSError:
                pass
        out: List[dict] = []
        for label, path, pid in rows:
            tail = _events._read_log_tail(path, pid, int(tail_bytes))
            out.append({
                "label": label,
                "path": path,
                "node_id": self.node_id.hex()[:8],
                "bytes": len(tail),
                "tail": tail,
                "error_lines": _events.extract_error_lines(tail),
            })
        if out:
            try:
                from ray_tpu_torch.util import metric_defs as _md

                _md.get("rtpu_log_fetches_total")._inc_key((), len(out))
                _md.get("rtpu_log_fetch_bytes_total")._inc_key(
                    (), sum(r["bytes"] for r in out))
            except Exception:
                pass
        return out

    def collect_profile_batches(self) -> None:
        """Drain this PROCESS's sampler window into the runtime's
        ProfileStore with origin labels — called at query time
        (state.profile) and before each heartbeat ships profile deltas,
        so driver/daemon samples join their workers' pushed batches."""
        from ray_tpu_torch.util import profiling

        batches = profiling.drain_batches()
        if not batches:
            return
        comp = "driver"
        if self.cluster is not None and not self.cluster.is_scheduler:
            comp = "raylet"
        self.profile_store.ingest(
            batches,
            {"node_id": self.node_id.hex()[:8], "component": comp})

    def dump_stacks(self, timeout: float = 2.0) -> Dict[str, dict]:
        """Live python stacks of this process AND every live worker
        (`ray_tpu_torch stack` py-spy role): push a ``stackdump`` to each
        worker, wait for the ``stacks`` reply casts, and merge with this
        process's own ``sys._current_frames()`` walk. Workers that miss
        the deadline are reported as pending."""
        from ray_tpu_torch.util import profiling

        asked = []
        t_req = time.monotonic()
        with self.lock:
            workers = list(self.workers.values())
        for ws in workers:
            if ws.status == "dead" or ws.conn is None:
                continue
            try:
                ws.send(("stackdump",))
                asked.append(ws.worker_id.binary())
            except Exception:
                pass
        comp = "driver"
        if self.cluster is not None and not self.cluster.is_scheduler:
            comp = "raylet"
        out = {f"{comp}/{os.getpid()}": profiling.current_stacks()}
        deadline = time.monotonic() + timeout
        pending = set(asked)
        while pending and time.monotonic() < deadline:
            for wid in list(pending):
                rep = self._stack_replies.get(wid)
                if rep is not None and rep["ts"] >= t_req:
                    pending.discard(wid)
            if pending:
                profiling.idle_sleep(0.02)
        for wid in asked:
            rep = self._stack_replies.get(wid)
            label = f"worker:{wid.hex()[:8]}"
            if rep is not None and rep["ts"] >= t_req:
                out[label] = rep["stacks"]
            else:
                out[label] = {"<pending>": "no reply within timeout"}
        return out

    def shutdown(self):
        from ray_tpu_torch.core import object_ref as _object_ref

        try:
            from ray_tpu_torch.util.metrics import federation, unregister_collector

            federation.clear()  # drop this runtime's worker-origin samples
            if self._metrics_collector is not None:
                unregister_collector(self._metrics_collector)
        except Exception:
            pass
        try:
            from ray_tpu_torch.util import alerts as _alerts

            _alerts.stop_watchdog()
        except Exception:
            pass
        _object_ref.clear_ref_hook()
        self.gcs.on_terminal = None
        self._log_monitor_stop.set()
        if self.cluster is not None:
            try:
                self.cluster.close()
            except Exception:
                pass
            self.cluster = None
        if self._memory_monitor is not None:
            self._memory_monitor.stop()
        with self.lock:
            self._shutdown = True
        # Stop every worker, those whose spawn was still in flight too:
        # a worker that outlives the sweep below can reopen the session's
        # arena by name, and so create it anew.
        workers: List[_WorkerState] = []
        deadline = time.monotonic() + 10.0
        while True:
            with self.lock:
                fresh = [ws for ws in self.workers.values()
                         if ws not in workers]
                in_flight = self._spawns_in_flight
            if fresh:
                self._stop_workers(fresh)
                workers.extend(fresh)
            elif in_flight == 0 or time.monotonic() > deadline:
                break
            else:
                time.sleep(0.01)
        for ws in workers:
            # reclaim the native engines' threads (never from their own
            # drain thread — this is the driver's shutdown caller)
            if ws.npipe is not None:
                try:
                    ws.npipe.close()
                except Exception:
                    pass
        with self._zygote_lock:
            if self._zygote_obj is not None:
                self._zygote_obj.close()
                self._zygote_obj = None
        try:
            self._listener.close()
        except Exception:
            pass
        try:
            os.unlink(self._sock_addr)
        except OSError:
            pass
        # the arena, the object segments and the compiled-DAG channels of
        # this session (rings a leaked CompiledDAG left behind)
        StoreClient.cleanup_session(self.session)

    @staticmethod
    def _stop_workers(workers: List[_WorkerState]) -> None:
        """Ask each worker to exit; terminate, then kill, the ones that
        do not within 2.5 s; and reap every one, killed ones included."""
        for ws in workers:
            try:
                ws.send(("shutdown",))
            except Exception:
                pass
        deadline = time.monotonic() + 2.0
        for ws in workers:
            t = max(0.05, deadline - time.monotonic())
            try:
                ws.proc.wait(t)
            except Exception:
                ws.proc.terminate()
        for ws in workers:
            if ws.proc.poll() is None:
                try:
                    ws.proc.wait(0.5)
                except Exception:
                    ws.proc.kill()
        for ws in workers:
            try:
                ws.proc.wait(5.0)
            except Exception:
                logger.warning("worker %s (pid %s) outlived SIGKILL",
                               ws.worker_id.hex()[:8],
                               getattr(ws.proc, "pid", None))


# ----------------------------------------------------------------------
# module-level public API
# ----------------------------------------------------------------------


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    namespace: str = "default",
    ignore_reinit_error: bool = False,
    runtime_env: Optional[dict] = None,
    log_to_driver: bool = True,
    labels: Optional[Dict[str, str]] = None,
    **kwargs,
):
    """Start the runtime in this process (reference: ``ray.init``,
    ``python/ray/_private/worker.py:1214``).

    One node. ``num_gpus`` (default: the cards NVML counts, with no CUDA
    context made) becomes the ``GPU`` resource that ``num_gpus=`` asks
    for. ``address="host:port"`` (joining a cluster) raises until
    ``cluster/`` is ported (ROADMAP.md queue 1 item 4).
    """
    if address and address not in ("auto", "local"):
        raise NotImplementedError(
            "init(address=...) joins a cluster, and cluster/ is not "
            "ported yet (ROADMAP.md queue 1 item 4)")
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            if ignore_reinit_error:
                return _runtime
            raise RuntimeError("ray_tpu_torch.init() already called (use ignore_reinit_error=True)")
        worker_env = {}
        if runtime_env and "env_vars" in runtime_env:
            worker_env.update(runtime_env["env_vars"])
        rt = DriverRuntime(
            num_cpus=num_cpus,
            num_gpus=num_gpus,
            resources=resources,
            namespace=namespace,
            worker_env=worker_env,
            log_to_driver=log_to_driver,
            labels=labels,
        )
        _runtime = rt
        atexit.register(_atexit_shutdown)
        try:
            from ray_tpu_torch.usage_stats import write_usage_report

            write_usage_report(rt)
        except Exception:
            pass
        return rt


def _atexit_shutdown():
    global _runtime
    rt = _runtime
    if rt is not None and rt.is_driver:
        try:
            rt.shutdown()
        except Exception:
            pass
        _runtime = None


def shutdown():
    global _runtime
    with _runtime_lock:
        rt = _runtime
        if rt is None:
            return
        if rt.is_driver:
            rt.shutdown()
        _runtime = None


def is_initialized() -> bool:
    return _runtime is not None


def put(value: Any) -> ObjectRef:
    return _get_runtime().put(value)


def get(refs, timeout: Optional[float] = None):
    rt = _get_runtime()
    if isinstance(refs, ObjectRef):
        return rt.get([refs], timeout)[0]
    if not isinstance(refs, list):
        raise TypeError("get() takes an ObjectRef or list of ObjectRefs")
    if not refs:
        return []
    return rt.get(refs, timeout)


def wait(refs, *, num_returns: int = 1, timeout: Optional[float] = None, fetch_local: bool = True):
    if not isinstance(refs, list):
        raise TypeError("wait() takes a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns > len(refs)")
    return _get_runtime().wait(refs, num_returns, timeout, fetch_local)


def kill(actor, *, no_restart: bool = True):
    from ray_tpu_torch.core.actor import ActorHandle

    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    _get_runtime().kill_actor(actor._actor_id.binary(), no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    _get_runtime().cancel(ref, force)


def get_actor(name: str, namespace: Optional[str] = None):
    from ray_tpu_torch.core.actor import ActorHandle

    aid = _get_runtime().lookup_named_actor(name)
    if aid is None:
        raise ValueError(f"no actor named {name!r}")
    return ActorHandle(ActorID(aid))


def free(refs) -> None:
    """Eagerly delete objects from the store + directory (reference
    ``ray.internal.free`` role). For owners that KNOW an object is fully
    consumed — the streaming exchange drops partition blocks this way so a
    shuffle's intermediates never accumulate. Unlike dropping ObjectRefs,
    this reclaims the segment immediately; lineage reconstruction of a
    freed object is impossible, so never free values a consumer may still
    fetch."""
    if isinstance(refs, ObjectRef):
        refs = [refs]
    refs = list(refs)  # a generator must not be exhausted by validation
    if not all(isinstance(r, ObjectRef) for r in refs):
        raise TypeError("free() takes an ObjectRef or list of ObjectRefs")
    if refs:
        _get_runtime().free([r.id.binary() for r in refs])


def object_store_memory() -> Dict[str, int]:
    """Local object-store usage (public API so libraries never reach into
    store internals): {"used_bytes", "capacity_bytes", "spilled_bytes"}."""
    from ray_tpu_torch import config

    rt = _get_runtime()
    return {"used_bytes": int(rt.store.store_bytes()),
            "capacity_bytes": int(config.get("store_capacity")),
            "spilled_bytes": int(rt.store.spill_dir_bytes())}


def available_resources() -> Dict[str, float]:
    return _get_runtime().resources("avail")


def cluster_resources() -> Dict[str, float]:
    return _get_runtime().resources("total")


def nodes():
    return _get_runtime().node_info()


def timeline(filename: Optional[str] = None):
    events = _get_runtime().timeline()
    if filename:
        import json

        with open(filename, "w") as f:
            json.dump(events, f)
    return events


def remote(*args, **options):
    """``@remote`` decorator for functions and classes (reference:
    ``python/ray/_private/worker.py:3212``)."""
    from ray_tpu_torch.core.actor import ActorClass
    from ray_tpu_torch.core.remote_function import RemoteFunction
    import inspect

    def make(target, opts):
        if inspect.isclass(target):
            return ActorClass(target, opts)
        return RemoteFunction(target, opts)

    if len(args) == 1 and callable(args[0]) and not options:
        return make(args[0], {})
    if args:
        raise TypeError("@remote options must be keyword arguments")

    def deco(target):
        return make(target, options)

    return deco


def method(**options):
    """``@ray.method`` analog: annotate actor methods (num_returns...)."""

    def deco(fn):
        fn._rtpu_method_options = options
        return fn

    return deco
