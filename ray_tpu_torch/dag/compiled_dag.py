"""CompiledDAG: channel-wired actor pipelines (twin of
``ray_tpu/dag/compiled_dag.py``).

Role analog: ``python/ray/dag/compiled_dag_node.py:278``. Compilation
allocates one mutable shm ring channel per DAG edge and launches a
long-running exec loop inside every participating actor (the reference's
per-actor exec loops). After that, invoking the DAG is: driver writes the
input channel → each actor's loop reads its upstream channels, runs its
methods, writes its output channel → driver reads the final channel. No
task submission, no scheduler, no per-call allocation on the hot path.

Channels are rings of ``max_in_flight + 1`` slots, so ``execute()`` admits
up to ``max_in_flight`` overlapping invocations — a K-stage pipeline
reaches stage-parallel throughput instead of lock-step round-trips.
Results are delivered strictly FIFO: invocation k's future resolves to
result k regardless of the order futures are awaited (an out-of-order
``get()`` buffers earlier results into their futures).
``execute_async()``/awaitable futures let asyncio callers (serve replicas)
drive a compiled DAG without blocking their loop.

Tensor edges (``with_tensor_transport()`` / a ``DeviceTensorType`` hint)
ride a :class:`~ray_tpu_torch.experimental.device_channel.DeviceChannel`:
one torch tensor's raw bytes in the slot. Its reader gets a CPU tensor
that ALIASES the slot, so:

- a stage's exec loop moves a tensor-edge input to the card where its
  process has one (the hint's device, else ``cuda``: one host-to-device
  copy); in a process without a card the stage gets the CPU view;
- the driver settles a tensor read from the output ring into its future
  as a COPY: with futures drained FIFO, a result may sit in its future
  while later invocations reuse its slot.

The exec loop intentionally occupies the actor (submitted as a normal actor
call that only returns at teardown) — a compiled DAG takes ownership of its
actors, matching the reference's semantics. A participating actor dying
mid-loop is detected by polling the loop refs while waiting on the output
channel: the failure surfaces promptly as :class:`DAGExecutionError`
instead of a channel-read timeout, and ``teardown()`` force-stops the
surviving stages by writing the stop sentinel into the dead actor's
output channels (safe: their writer is gone).
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import torch

from ray_tpu_torch.dag.dag_node import ClassMethodNode, DAGNode, InputNode
from ray_tpu_torch.experimental.channel import Channel
from ray_tpu_torch.experimental.device_channel import (DeviceChannel,
                                                       DeviceTensorType)


class _Stop:
    """Teardown sentinel propagated through the pipeline."""


class _NodeError:
    def __init__(self, err: BaseException, node_repr: str):
        self.err = err
        self.node_repr = node_repr


class DAGExecutionError(RuntimeError):
    pass


class DAGBackpressureError(DAGExecutionError):
    """``execute()`` found ``max_in_flight`` invocations already admitted
    and none completed within the deadline."""


# lazily-bound built-in metrics (defs in util/metric_defs); a metrics
# failure must never fail an execution
_m = {"execs": None, "inflight": None}


def _dag_metrics():
    if _m["execs"] is None:
        from ray_tpu_torch.util import metric_defs

        _m["execs"] = metric_defs.get("rtpu_dag_executions_total")
        _m["inflight"] = metric_defs.get("rtpu_dag_inflight")
    return _m


def _dag_exec_loop(instance, stages: List[Dict[str, Any]]) -> int:
    """Runs inside the actor: per invocation, execute this actor's stages
    in topo order. ``stages``: [{method, inputs: [(kind, key[, chan_kind,
    device])], out, out_kind}] where kind is "chan" | "const"; a
    "device" channel's tensor is moved by ``_to_edge_device``.
    """
    executed = 0
    chans: Dict[str, Channel] = {}

    def chan(name: str, kind: str = "obj") -> Channel:
        if name not in chans:
            cls = DeviceChannel if kind == "device" else Channel
            chans[name] = cls(name, create=False)
        return chans[name]

    from ray_tpu_torch.util import tracing

    # This loop occupies the actor's dispatch thread; on a concurrency-1
    # actor the worker main loop (which normally ships span/metric/profile
    # batches on idle ticks) never runs again until teardown — push from
    # here instead (rate-limited + thread-safe inside push_telemetry)
    try:
        from ray_tpu_torch.core.runtime import _get_runtime

        _push = getattr(_get_runtime(), "push_telemetry", None)
    except Exception:
        _push = None

    while True:
        stop = False
        read_cache: Dict[str, Any] = {}  # one read per channel per tick
        for stage in stages:
            args = []
            err: Optional[_NodeError] = None
            for kind, key, *ck in stage["inputs"]:
                if kind == "const":
                    args.append(key)
                    continue
                if key in read_cache:
                    val = read_cache[key]
                else:
                    val = chan(key, ck[0] if ck else "obj").read()
                    if ck and ck[0] == "device":
                        val = _to_edge_device(val, ck[1])
                    read_cache[key] = val
                if isinstance(val, _Stop):
                    stop = True
                if isinstance(val, _NodeError):
                    err = val
                args.append(val)
            out = chan(stage["out"], stage.get("out_kind", "obj"))
            if stop:
                out.write(_Stop())
                continue
            if err is not None:
                out.write(err)   # propagate upstream failure
                continue
            try:
                method = getattr(instance, stage["method"])
                if tracing.tracing_enabled():
                    with tracing.span("dag::stage",
                                      {"method": stage["method"]}):
                        result = method(*args)
                else:
                    result = method(*args)
                out.write(result)
            except BaseException as e:  # noqa: BLE001 — shipped to driver
                out.write(_NodeError(e, stage["method"]))
        if stop:
            return executed
        executed += 1
        if _push is not None:
            try:
                _push()
            except Exception:
                pass


def _to_edge_device(val: Any, hint_device: Optional[str]) -> Any:
    """A tensor-edge input where its stage takes it: the hint's device, else
    ``cuda`` where this process has a card, else the CPU view of the slot.
    ``torch.cuda.is_available()`` initialises no CUDA context (workers run
    with ``PYTORCH_NVML_BASED_CUDA_CHECK=1``)."""
    if not isinstance(val, torch.Tensor):
        return val
    device = hint_device
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return val if device == "cpu" else val.to(device)


class CompiledDAGFuture:
    """Result handle for one ``execute()``. FIFO delivery: this future
    resolves to the result of ITS invocation; getting futures out of
    submission order buffers the earlier results into their futures.
    Awaitable (``await fut`` / ``await fut.get_async()``) for asyncio
    drivers — the blocking wait runs on the loop's default executor."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._done = False
        self._result: Any = None
        self._error: Optional[BaseException] = None

    def _settle(self, val: Any) -> None:
        self._done = True
        if isinstance(val, _NodeError):
            self._error = DAGExecutionError(
                f"compiled DAG node {val.node_repr!r} failed")
            self._error.__cause__ = val.err
        elif isinstance(val, _Stop):
            self._error = DAGExecutionError("compiled DAG was torn down")
        else:
            self._result = val

    def _resolve(self):
        if self._error is not None:
            raise self._error
        return self._result

    def get(self, timeout: Optional[float] = 60.0) -> Any:
        """Default bounds the wait (a wedged-but-alive stage never trips
        the death detector); pass ``timeout=None`` to wait forever."""
        if not self._done:
            self._dag._drain_until(self, timeout)
        return self._resolve()

    async def get_async(self, timeout: Optional[float] = 60.0) -> Any:
        import asyncio

        return await asyncio.get_running_loop().run_in_executor(
            None, self.get, timeout)

    def __await__(self):
        return self.get_async().__await__()


class CompiledDAG:
    def __init__(self, output_node: DAGNode,
                 buffer_size_bytes: int = 1 << 20,
                 max_in_flight: Optional[int] = None):
        if max_in_flight is None:
            from ray_tpu_torch import config

            max_in_flight = int(config.get("dag_max_in_flight"))
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        self._output_node = output_node
        self._buffer = buffer_size_bytes
        self._max_in_flight = int(max_in_flight)
        self._channels: List[Channel] = []
        self._input_channel: Optional[Channel] = None
        self._output_channel: Optional[Channel] = None
        self._loop_refs: List[Any] = []
        # channels each ACTOR writes, keyed by loop-ref index — teardown
        # force-stops a dead actor's downstream by writing _Stop there
        self._writer_channels: Dict[int, List[Channel]] = {}
        self._torn_down = False
        self._broken: Optional[str] = None
        # admitted-but-unresolved futures in submission order; all
        # admission/drain bookkeeping happens under _drive_lock (one
        # drainer reads the output channel at a time)
        self._pending: "List[CompiledDAGFuture]" = []
        self._exec_seq = 0
        self._drive_lock = threading.Lock()
        self._compile()

    # -- compilation ------------------------------------------------------

    def _compile(self) -> None:
        order = self._output_node.topo_sort()
        inputs = [n for n in order if isinstance(n, InputNode)]
        if len(inputs) != 1:
            raise ValueError("compiled DAG needs exactly one InputNode")
        for n in order:
            if not isinstance(n, (InputNode, ClassMethodNode)):
                raise TypeError(
                    f"compiled DAGs support actor-method nodes only, got {n!r}")
            if isinstance(n, ClassMethodNode) and not n._upstream():
                raise ValueError(
                    f"{n!r} has no upstream nodes; compiled stages must be "
                    "driven by the input (teardown could never reach it)")
            if getattr(n, "kwargs", None):
                # checked before any channel exists, so none is left behind
                raise TypeError("compiled DAGs do not support kwargs binds")
        # channel names carry the session so a crashed/unclean driver's
        # leftovers are sweepable at shutdown (rtpu-chan-<session>-*)
        try:
            from ray_tpu_torch.core.runtime import _get_runtime

            uid = f"{_get_runtime().session}-{uuid.uuid4().hex[:8]}"
        except Exception:
            uid = uuid.uuid4().hex[:8]

        # one ring channel per node output, max_in_flight + 1 slots so
        # admission never blocks on the ring itself; DeviceTensorType-
        # hinted edges get the raw device-tensor channel (reference
        # NCCL-channel role)
        nslots = self._max_in_flight + 1
        chan_name: Dict[int, str] = {}
        chan_kind: Dict[int, str] = {}
        chan_by_node: Dict[int, Channel] = {}
        for i, n in enumerate(order):
            name = f"{uid}-{i}"
            chan_name[id(n)] = name
            kind = ("device" if isinstance(getattr(n, "_type_hint", None),
                                           DeviceTensorType) else "obj")
            chan_kind[id(n)] = kind
            cls = DeviceChannel if kind == "device" else Channel
            ch = cls(name, capacity=self._buffer, create=True, slots=nslots)
            self._channels.append(ch)
            chan_by_node[id(n)] = ch
            if isinstance(n, InputNode):
                self._input_channel = ch
        self._output_channel = chan_by_node[id(self._output_node)]

        # group stages by actor, preserving topo order
        by_actor: Dict[Any, List[Dict[str, Any]]] = {}
        writer_chans: Dict[Any, List[Channel]] = {}
        for n in order:
            if isinstance(n, InputNode):
                continue
            inputs_desc = []
            for a in n.args:
                if isinstance(a, DAGNode):
                    inputs_desc.append(("chan", chan_name[id(a)],
                                        chan_kind[id(a)],
                                        getattr(a._type_hint, "device",
                                                None)))
                else:
                    inputs_desc.append(("const", a))
            by_actor.setdefault(n.actor, []).append({
                "method": n.method_name,
                "inputs": inputs_desc,
                "out": chan_name[id(n)],
                "out_kind": chan_kind[id(n)],
            })
            writer_chans.setdefault(n.actor, []).append(chan_by_node[id(n)])

        for actor, stages in by_actor.items():
            idx = len(self._loop_refs)
            self._loop_refs.append(
                actor.__rtpu_call__.remote(_dag_exec_loop, stages))
            self._writer_channels[idx] = writer_chans.get(actor, [])

    # -- invocation -------------------------------------------------------

    def execute(self, input_value: Any,
                timeout: Optional[float] = None) -> CompiledDAGFuture:
        """Admit one invocation; returns its FIFO future. With
        ``max_in_flight`` invocations already admitted, blocks until one
        completes (its result is buffered into its future) — bounded by
        ``timeout``, raising :class:`DAGBackpressureError` on expiry."""
        from ray_tpu_torch.util import tracing

        if not tracing.tracing_enabled():
            return self._execute_inner(input_value, timeout)
        with tracing.span("dag::execute", {"seq": self._exec_seq}):
            return self._execute_inner(input_value, timeout)

    def _execute_inner(self, input_value: Any,
                       timeout: Optional[float]) -> CompiledDAGFuture:
        deadline = None if timeout is None else time.monotonic() + timeout
        # admission loop: each iteration holds the drive lock for at most
        # one bounded drain slice (~0.2s), so concurrent getters — and a
        # teardown() from another thread — always get their turn
        while True:
            with self._drive_lock:
                self._raise_if_unusable()
                if len(self._pending) < self._max_in_flight:
                    fut = CompiledDAGFuture(self, self._exec_seq)
                    self._exec_seq += 1
                    self._pending.append(fut)
                    # ring slots cover max_in_flight + 1 values, so with
                    # admission bounded above this write never blocks on a
                    # healthy pipeline; the bounded timeout is a safety
                    # valve for a wedged one
                    try:
                        self._input_channel.write(input_value, timeout=60.0)
                    except Exception:
                        self._pending.remove(fut)
                        raise
                    try:
                        # inflight moves by DELTAS: several DAGs in one
                        # process share the gauge, so set() would clobber
                        m = _dag_metrics()
                        m["execs"].inc()
                        m["inflight"].inc()
                    except Exception:
                        pass
                    return fut
                # pipeline full: drain the oldest pending result into its
                # future (keeps FIFO), freeing one admission slot
                if deadline is not None and time.monotonic() > deadline:
                    raise DAGBackpressureError(
                        f"compiled DAG has {self._max_in_flight} "
                        f"invocations in flight and none completed within "
                        f"{timeout}s (max_in_flight={self._max_in_flight})")
                self._drain_step()

    async def execute_async(self, input_value: Any,
                            timeout: Optional[float] = None
                            ) -> CompiledDAGFuture:
        """``execute()`` for asyncio callers (serve replicas): admission —
        which may block on backpressure — runs on the loop's default
        executor; the returned future is awaitable."""
        import asyncio

        return await asyncio.get_running_loop().run_in_executor(
            None, self.execute, input_value, timeout)

    # -- result draining (FIFO) ------------------------------------------

    def _raise_if_unusable(self) -> None:
        if self._torn_down:
            raise DAGExecutionError("DAG already torn down")
        if self._broken:
            raise DAGExecutionError(self._broken)

    def _drain_until(self, fut: CompiledDAGFuture,
                     timeout: Optional[float]) -> None:
        """Block until ``fut`` is settled, draining output values FIFO.
        Concurrent getters cooperate: whoever holds the drive lock drains
        one bounded slice for everyone, then releases; the rest re-check
        their future between attempts."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not fut._done:
            acquired = self._drive_lock.acquire(timeout=0.1)
            if not acquired:
                if deadline is not None and time.monotonic() > deadline:
                    raise DAGExecutionError(
                        f"compiled DAG result not available after "
                        f"{timeout}s")
                continue
            try:
                if fut._done:
                    return
                if self._torn_down or self._broken:
                    # settle instead of raising the generic torn-down
                    # error: the future may never get another chance
                    fut._settle(_Stop() if self._broken is None
                                else _NodeError(
                                    DAGExecutionError(self._broken),
                                    "pipeline"))
                    return
                if deadline is not None and time.monotonic() > deadline:
                    raise DAGExecutionError(
                        f"compiled DAG result not available after "
                        f"{timeout}s")
                self._drain_step()
            finally:
                self._drive_lock.release()

    def _drain_step(self) -> None:
        """ONE bounded (~0.2s) drain slice, caller holds the drive lock:
        read the next output value if it arrives, settle the oldest
        pending future, and check the exec-loop refs on an empty slice so
        a participating actor's death is detected promptly instead of
        timing out on the channel. Bounded so the lock churns and other
        getters / teardown() interleave."""
        if not self._pending:
            return
        from ray_tpu_torch.experimental.channel import ChannelTimeoutError

        try:
            val = self._output_channel.read(timeout=0.2)
        except ChannelTimeoutError:
            self._check_loop_refs()
            return
        if (isinstance(self._output_channel, DeviceChannel)
                and isinstance(val, torch.Tensor)):
            # the read aliases a ring slot that a later result reuses
            val = val.clone()
        fut = self._pending.pop(0)
        fut._settle(val)
        try:
            _dag_metrics()["inflight"].dec()
        except Exception:
            pass

    def _check_loop_refs(self) -> None:
        """A loop ref resolving mid-run means its actor died (the loop
        only returns at teardown): mark the DAG broken and surface
        promptly — never let a dead stage read as a get() timeout."""
        import ray_tpu_torch

        try:
            ready, _ = ray_tpu_torch.wait(self._loop_refs,
                                    num_returns=len(self._loop_refs),
                                    timeout=0)
        except Exception:
            return
        if not ready:
            return
        detail = "a participating actor's exec loop ended mid-run"
        for ref in ready:
            try:
                ray_tpu_torch.get(ref, timeout=1)
            except Exception as e:  # noqa: BLE001 — diagnostic only
                detail = f"participating actor died mid-DAG: {e!r}"
                break
        self._broken = detail
        broken_err = DAGExecutionError(detail)
        for fut in self._pending:
            fut._done = True
            fut._error = broken_err
        try:
            _dag_metrics()["inflight"].dec(len(self._pending))
        except Exception:
            pass
        self._pending = []
        raise broken_err

    # -- teardown ---------------------------------------------------------

    def teardown(self, timeout: float = 10.0) -> None:
        if self._torn_down:
            return
        # flag FIRST: concurrent getters observe it between drain slices,
        # settle their futures as torn-down, and release the drive lock —
        # which this method then takes so its output-ring drain never
        # interleaves with a getter's cursor
        self._torn_down = True
        import ray_tpu_torch

        with self._drive_lock:
            self._teardown_locked(timeout, ray_tpu_torch)

    def _teardown_locked(self, timeout: float, ray_tpu_torch) -> None:
        deadline = time.monotonic() + timeout
        stop_sent = False
        try:
            self._input_channel.write(_Stop(), timeout=2.0)
            stop_sent = True
        except Exception:
            pass
        # Drain the output so stalled rings free up and _Stop can flow
        # (retrying the input _Stop while draining — a full input ring
        # un-fills as stages progress); force-stop channels whose writer
        # actor is already gone (their loop ref is resolved, so writing
        # from here cannot race them).
        pending = list(range(len(self._loop_refs)))
        while pending and time.monotonic() < deadline:
            if not stop_sent:
                try:
                    self._input_channel.write(_Stop(), timeout=0.1)
                    stop_sent = True
                except Exception:
                    pass
            try:
                self._output_channel.read(timeout=0.2)
                continue  # drained one buffered value; keep going
            except Exception:
                pass
            still = []
            for i in pending:
                try:
                    ready, _ = ray_tpu_torch.wait([self._loop_refs[i]],
                                            timeout=0)
                except Exception:
                    ready = [self._loop_refs[i]]  # runtime gone: stop waiting
                if ready:
                    for ch in self._writer_channels.get(i, []):
                        try:
                            ch.write(_Stop(), timeout=0.5)
                        except Exception:
                            pass
                else:
                    still.append(i)
            pending = still
        try:
            ray_tpu_torch.get(self._loop_refs,
                        timeout=max(0.5, deadline - time.monotonic()))
        except Exception:
            pass
        for ch in self._channels:
            ch.unlink()
        try:
            _dag_metrics()["inflight"].dec(len(self._pending))
        except Exception:
            pass
        self._pending = []

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass
