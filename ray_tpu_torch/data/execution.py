"""Streaming execution of logical plans over the task runtime (a copy of
``ray_tpu/data/execution.py``).

Role analog: ``python/ray/data/_internal/execution/streaming_executor.py:48``
and its Topology loop (``streaming_executor_state.py``). Same ideas, compact
form: logical map-ish operators are **fused** into one task per block
(reference optimizer's fusion rule), blocks flow through the fused pipeline
as object refs with a bounded number of in-flight tasks (backpressure), and
all-to-all ops (shuffle/sort/repartition/groupby) are barriers that
materialize their input refs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    Block,
    block_num_rows,
    block_slice,
)


# ---------------------------------------------------------------------------
# Logical operators
# ---------------------------------------------------------------------------

@dataclass
class MapOp:
    """Block -> List[Block] transform; fusible with neighbors.

    ``compute``: None runs each block as a task; an ActorPoolStrategy
    runs blocks on a warm autoscaling actor pool (expensive per-block
    setup like model weights loads once per actor)."""

    name: str
    fn: Callable[[Block], List[Block]]
    compute: Optional["ActorPoolStrategy"] = None


@dataclass
class ActorPoolStrategy:
    """Reference ``ActorPoolMapOperator`` role: min_size warm actors,
    growing to max_size while the input queue is deep."""

    min_size: int = 1
    max_size: int = 4
    max_tasks_in_flight_per_actor: int = 2


@dataclass
class AllToAllOp:
    """Barrier op consuming all blocks at once (driver-side; only for
    custom user fns — the built-in exchanges use ShuffleOp)."""

    name: str
    fn: Callable[[List[Block]], List[Block]]


@dataclass
class ShuffleOp:
    """Distributed all-to-all (reference exchange ops under
    ``data/_internal/planner/exchange/``): partition tasks emit one block
    per reducer, reduce tasks consume the refs — block bytes NEVER pass
    through the driver. ``kind``: random_shuffle | repartition | sort."""

    name: str
    kind: str
    args: Dict[str, Any] = field(default_factory=dict)


@dataclass
class LimitOp:
    name: str
    limit: int


LogicalOp = Any  # MapOp | AllToAllOp | ShuffleOp | LimitOp


def fuse_ops(ops: List[LogicalOp]) -> List[LogicalOp]:
    """Merge consecutive MapOps into single fused stages (the reference's
    OperatorFusionRule): one task per block runs the whole chain."""
    fused: List[LogicalOp] = []
    for op in ops:
        if (isinstance(op, MapOp) and fused
                and isinstance(fused[-1], MapOp)
                and fused[-1].compute is op.compute):
            prev = fused[-1]

            def chained(block: Block, _prev=prev.fn, _next=op.fn) -> List[Block]:
                out: List[Block] = []
                for b in _prev(block):
                    out.extend(_next(b))
                return out

            fused[-1] = MapOp(name=f"{prev.name}->{op.name}", fn=chained,
                              compute=prev.compute)
        else:
            fused.append(op)
    return fused


# ---------------------------------------------------------------------------
# Streaming executor
# ---------------------------------------------------------------------------

def _apply_map(fn_blob_fn, block: Block) -> List[Block]:
    return fn_blob_fn(block)


class BackpressurePolicy:
    """Caps a map stage's concurrency (reference
    ``_internal/execution/backpressure_policy/`` role). Policies compose:
    the effective window is the MIN over all policies and the base
    ``max_in_flight``."""

    def max_in_flight(self, op: "MapOp", base: int) -> int:
        raise NotImplementedError


class ConcurrencyCapBackpressurePolicy(BackpressurePolicy):
    """Hard cap on concurrent tasks per stage (reference
    ``concurrency_cap_backpressure_policy.py``)."""

    def __init__(self, cap: int):
        self.cap = int(cap)

    def max_in_flight(self, op: "MapOp", base: int) -> int:
        return self.cap


class StoreMemoryBackpressurePolicy(BackpressurePolicy):
    """Shrinks the window while the local object store is above a
    utilization threshold — in-flight blocks pin store memory, so the
    stage must not outrun the consumer when the store is tight."""

    def __init__(self, threshold: float = 0.8, ttl_s: float = 0.5):
        self.threshold = threshold
        self.ttl_s = ttl_s
        self._cached = (0.0, 0.0)  # (monotonic ts, utilization)

    def _utilization(self) -> float:
        # store_bytes() scans /dev/shm — far too heavy for the per-dispatch
        # window check (object_store.py's own O(1)-per-put rule); sample it
        # on a short TTL instead
        import time as _time

        ts, util = self._cached
        now = _time.monotonic()
        if now - ts < self.ttl_s:
            return util
        util = 0.0
        try:
            # public API only (ML libraries never touch
            # runtime/store internals)
            import ray_tpu_torch

            mem = ray_tpu_torch.object_store_memory()
            if mem["capacity_bytes"]:
                util = mem["used_bytes"] / mem["capacity_bytes"]
        except Exception:
            pass
        self._cached = (now, util)
        return util

    def max_in_flight(self, op: "MapOp", base: int) -> int:
        if self._utilization() > self.threshold:
            return max(1, base // 4)
        return base


@dataclass
class ExecutionOptions:
    max_in_flight: int = 8       # per map stage (backpressure window)
    preserve_order: bool = True
    # None -> the default rule-based optimizer (data/optimizer.py)
    optimizer: Optional[Any] = None
    backpressure_policies: Tuple[BackpressurePolicy, ...] = ()

    def effective_in_flight(self, op: "MapOp") -> int:
        out = self.max_in_flight
        for p in self.backpressure_policies:
            out = min(out, p.max_in_flight(op, self.max_in_flight))
        return max(1, out)


def execute_streaming(
    source: Iterator[Any],         # iterator of ObjectRef[Block] or Blocks
    ops: List[LogicalOp],
    options: Optional[ExecutionOptions] = None,
) -> Iterator[Any]:
    """Run the plan, yielding ObjectRefs of output blocks as they're ready.

    Consecutive (post-fusion) map operators — task OR actor-pool — run as
    ONE per-operator topology (:class:`TopologyExecutor`): each op keeps
    its own input/in-flight/output queues and a select-operator-to-run
    chooser advances whichever op has headroom, so a slow card-ingest
    stage and a fast CPU-decode stage genuinely overlap instead of the
    fast stage running ahead unboundedly or the chain serializing
    (reference ``streaming_executor_state.py:503``). All-to-all ops
    remain barriers between topology segments.
    """
    options = options or ExecutionOptions()
    if options.optimizer is None:
        from ray_tpu_torch.data.optimizer import Optimizer

        ops = Optimizer().optimize(ops)
    else:
        ops = options.optimizer.optimize(ops)
    stream: Iterator[Any] = (_ensure_ref(x) for x in source)
    segment: List[MapOp] = []

    def flush_segment(stream, segment):
        if segment:
            stream = TopologyExecutor(stream, list(segment), options).run()
            segment.clear()
        return stream

    for op in ops:
        if isinstance(op, MapOp):
            segment.append(op)
        elif isinstance(op, ShuffleOp):
            stream = flush_segment(stream, segment)
            stream = _run_shuffle(stream, op)
        elif isinstance(op, AllToAllOp):
            stream = flush_segment(stream, segment)
            stream = _run_all_to_all(stream, op)
        elif isinstance(op, LimitOp):
            stream = flush_segment(stream, segment)
            stream = _run_limit(stream, op.limit)
        else:
            raise TypeError(f"unknown op {op!r}")
    return _unmark_on_yield(flush_segment(stream, segment))


def _unmark_on_yield(stream: Iterator[Any]) -> Iterator[Any]:
    """Refs escaping to the caller lose executor ownership: a later plan
    consuming them (e.g. sort over a materialized dataset) must never
    free the user's blocks."""
    for ref in stream:
        unmark_ephemeral(ref)
        yield ref


#: ids of refs OWNED by the executor (raw source blocks it put itself):
#: the streaming exchange may free these eagerly once consumed — user-held
#: refs are never marked, and refs yielded back to the caller are unmarked
#: first (see execute_streaming's final wrapper)
_EPHEMERAL: set = set()


def mark_ephemeral(ref) -> None:
    if len(_EPHEMERAL) > 100_000:
        # residue from abandoned plans (limit()/take() drop upstream
        # generators with marked refs in flight). Dropping marks is SAFE —
        # an unmarked block merely loses eager freeing and waits for
        # ObjectRef GC — so a rare wholesale clear bounds the set.
        _EPHEMERAL.clear()
    _EPHEMERAL.add(ref.id.binary())


def unmark_ephemeral(ref) -> None:
    _EPHEMERAL.discard(ref.id.binary())


def is_ephemeral(ref) -> bool:
    return ref.id.binary() in _EPHEMERAL


def _ensure_ref(x):
    if isinstance(x, ray_tpu_torch.ObjectRef):
        return x
    ref = ray_tpu_torch.put(x)
    # the caller handed a raw Block: the executor owns this ref and may
    # reclaim it the moment the plan consumed it
    mark_ephemeral(ref)
    return ref


# ---------------------------------------------------------------------------
# Per-operator streaming topology
# ---------------------------------------------------------------------------

class _TaskDispatcher:
    """Dispatch one streaming map task per block."""

    def __init__(self, op: MapOp):
        self._remote = ray_tpu_torch.remote(num_returns="streaming")(
            lambda block, _fn=op.fn: iter(_fn(block)))

    def dispatch(self, ref):
        return self._remote.remote(ref)

    def task_finished(self, gen) -> None:
        pass

    def close(self) -> None:
        pass


class _ActorPoolDispatcher:
    """Reference ``ActorPoolMapOperator`` role: blocks run on warm actors
    (per-actor state loads once); the pool autoscales between min_size
    and max_size when every actor is saturated."""

    def __init__(self, op: MapOp):
        import cloudpickle as _cp

        self._strat = op.compute
        self._fn_blob = _cp.dumps(op.fn)
        self._actor_cls = ray_tpu_torch.remote(_PoolActor)
        self._actors = [self._actor_cls.remote(self._fn_blob)
                        for _ in range(self._strat.min_size)]
        self._load: Dict[int, int] = {i: 0 for i in range(len(self._actors))}
        self._gen_actor: Dict[int, int] = {}  # id(gen) -> actor idx

    def dispatch(self, ref):
        idx = min(self._load, key=self._load.get)
        if (self._load[idx] >= self._strat.max_tasks_in_flight_per_actor
                and len(self._actors) < self._strat.max_size):
            self._actors.append(self._actor_cls.remote(self._fn_blob))
            idx = len(self._actors) - 1
            self._load[idx] = 0
        self._load[idx] += 1
        gen = self._actors[idx].apply.options(
            num_returns="streaming").remote(ref)
        self._gen_actor[id(gen)] = idx
        return gen

    def task_finished(self, gen) -> None:
        idx = self._gen_actor.pop(id(gen), None)
        if idx is not None:
            self._load[idx] -= 1

    def close(self) -> None:
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


class _InFlight:
    """One dispatched streaming task: its generator plus an ordered buffer
    of already-yielded (polled) output refs."""

    __slots__ = ("gen", "buf", "done")

    def __init__(self, gen):
        self.gen = gen
        self.buf: List[Any] = []
        self.done = False


class _OpState:
    """Per-operator queues (reference ``OpState`` in
    ``streaming_executor_state.py``): input refs waiting to dispatch,
    in-flight streaming tasks, and ready output refs."""

    def __init__(self, op: MapOp, options: ExecutionOptions):
        from collections import deque

        self.op = op
        self.options = options
        self._dispatcher = None  # LAZY: actor pools must not spawn until
        # the first block actually reaches this op (and never at all if
        # the plan iterator is dropped unconsumed)
        self.inq: "deque" = deque()
        self.inflight: List[_InFlight] = []
        self.outq: "deque" = deque()
        self.input_done = False
        self.max_inq_seen = 0

    @property
    def dispatcher(self):
        if self._dispatcher is None:
            self._dispatcher = (_ActorPoolDispatcher(self.op)
                                if self.op.compute is not None
                                else _TaskDispatcher(self.op))
        return self._dispatcher

    def close(self) -> None:
        if self._dispatcher is not None:
            self._dispatcher.close()

    # -- scheduling predicates -------------------------------------------

    def window(self) -> int:
        # static capacity math — must not instantiate the dispatcher
        win = self.options.effective_in_flight(self.op)
        strat = self.op.compute
        if strat is not None:
            win = min(win, max(1, strat.max_size
                               * strat.max_tasks_in_flight_per_actor))
        return win

    def can_dispatch(self) -> bool:
        return bool(self.inq) and len(self.inflight) < self.window()

    def dispatch_one(self) -> None:
        ref = self.inq.popleft()
        # consumed by a map stage: no exchange will ever see this ref, so
        # retire its ownership mark (keeps _EPHEMERAL from growing with
        # every intermediate block of map->map chains)
        unmark_ephemeral(ref)
        self.inflight.append(_InFlight(self.dispatcher.dispatch(ref)))

    def poll(self) -> int:
        """Drain ready items from every in-flight task into per-task
        buffers (non-blocking), then move buffered refs to ``outq`` —
        strictly FIFO across tasks when ``preserve_order`` (items within a
        task are ordered by the stream itself). Returns refs moved."""
        for f in self.inflight:
            while not f.done:
                try:
                    ref = f.gen.try_next()
                except StopIteration:
                    f.done = True
                    self.dispatcher.task_finished(f.gen)
                    break
                if ref is None:
                    break
                # map outputs are executor-owned until they escape to the
                # caller (execute_streaming unmarks at the final yield): a
                # downstream exchange may free them the moment they're
                # consumed
                mark_ephemeral(ref)
                f.buf.append(ref)
        moved = 0
        if self.options.preserve_order:
            while self.inflight:
                head = self.inflight[0]
                self.outq.extend(head.buf)
                moved += len(head.buf)
                head.buf.clear()
                if head.done:
                    self.inflight.pop(0)
                else:
                    break
        else:
            for f in list(self.inflight):
                self.outq.extend(f.buf)
                moved += len(f.buf)
                f.buf.clear()
                if f.done:
                    self.inflight.remove(f)
        return moved

    def exhausted(self) -> bool:
        return (self.input_done and not self.inq and not self.inflight
                and not self.outq)

    def watch_refs(self) -> List[Any]:
        """Refs to park on when the whole topology is idle: each live
        stream's next item + its completion sentinel."""
        out = []
        for f in self.inflight:
            if not f.done:
                out.append(f.gen.next_item_ref())
                out.append(f.gen.completed())
        return out


class TopologyExecutor:
    """select-operator-to-run loop over a chain of map operators
    (reference ``streaming_executor_state.py:503``).

    Every iteration: poll all streams (non-blocking), move outputs
    downstream under a bounded per-op input queue, then dispatch ONE task
    for the runnable op with the least buffered output — draining toward
    the consumer first keeps total buffered blocks bounded while letting
    fast and slow stages run concurrently. When nothing is runnable and
    nothing moved, park on the union of next-item/sentinel refs (no
    busy-wait, no per-stream blocking)."""

    def __init__(self, source: Iterator[Any], ops: List[MapOp],
                 options: ExecutionOptions):
        self.source = source
        self.options = options
        self.states = [_OpState(op, options) for op in ops]
        # bounded inter-op queue: a fast producer may run at most this far
        # ahead of its consumer (reference outqueue memory gating role)
        self.max_queued = max(2, 2 * options.max_in_flight)
        self.stats: Dict[str, Any] = {"max_inq": {}, "dispatches": {}}

    # -- plumbing ---------------------------------------------------------

    def _pull_source(self) -> None:
        first = self.states[0]
        while not first.input_done and len(first.inq) < self.max_queued:
            try:
                first.inq.append(next(self.source))
            except StopIteration:
                first.input_done = True
        first.max_inq_seen = max(first.max_inq_seen, len(first.inq))

    def _transfer(self) -> int:
        """outq[i] -> inq[i+1] under the bound; marks input_done edges."""
        moved = 0
        for i, st in enumerate(self.states[:-1]):
            nxt = self.states[i + 1]
            while st.outq and len(nxt.inq) < self.max_queued:
                nxt.inq.append(st.outq.popleft())
                moved += 1
            nxt.max_inq_seen = max(nxt.max_inq_seen, len(nxt.inq))
            if st.exhausted():
                nxt.input_done = True
        return moved

    def _select_op_to_run(self) -> Optional[_OpState]:
        """Runnable op with the least buffered output (its outq plus the
        downstream inq it feeds) — the reference's resource-aware choice,
        reduced to block counts."""
        best, best_score = None, None
        for i, st in enumerate(self.states):
            if not st.can_dispatch():
                continue
            downstream = (len(self.states[i + 1].inq)
                          if i + 1 < len(self.states) else 0)
            if i + 1 < len(self.states) and \
                    len(self.states[i + 1].inq) >= self.max_queued:
                continue  # downstream full: dispatching only buffers more
            score = len(st.outq) + downstream
            if best_score is None or score < best_score:
                best, best_score = st, score
        return best

    # -- main loop --------------------------------------------------------

    def run(self) -> Iterator[Any]:
        states = self.states
        last = states[-1]
        try:
            while True:
                self._pull_source()
                progressed = sum(st.poll() for st in states)
                progressed += self._transfer()
                st = self._select_op_to_run()
                if st is not None:
                    st.dispatch_one()
                    name = st.op.name
                    self.stats["dispatches"][name] = \
                        self.stats["dispatches"].get(name, 0) + 1
                    progressed += 1
                while last.outq:
                    yield last.outq.popleft()
                if all(s.exhausted() for s in states):
                    break
                if not progressed:
                    # idle: park until ANY stream produces or completes
                    watch = [r for s in states for r in s.watch_refs()]
                    if watch:
                        ray_tpu_torch.wait(watch, num_returns=1, timeout=10)
        finally:
            for s in states:
                s.close()
            self.stats["max_inq"] = {s.op.name: s.max_inq_seen
                                     for s in states}
            _LAST_TOPOLOGY_STATS.clear()
            _LAST_TOPOLOGY_STATS.update(self.stats)


#: instrumentation for tests/debugging: queue-depth + dispatch counts of
#: the most recently finished topology segment
_LAST_TOPOLOGY_STATS: Dict[str, Any] = {}


def _run_all_to_all(stream: Iterator[Any], op: AllToAllOp) -> Iterator[Any]:
    blocks = []
    for r in stream:
        unmark_ephemeral(r)  # consumed here, never by an exchange
        blocks.append(ray_tpu_torch.get(r))
    for out in op.fn(blocks):
        yield ray_tpu_torch.put(out)


# ---------------------------------------------------------------------------
# Distributed shuffle (map/reduce exchange)
# ---------------------------------------------------------------------------

def _partition_rows(block: Block, assign: np.ndarray,
                    n_red: int) -> List[Block]:
    """Split ``block`` into ``n_red`` blocks by per-row reducer index."""
    out = []
    for j in range(n_red):
        idx = np.flatnonzero(assign == j)
        out.append({k: v[idx] for k, v in block.items()})
    return out


def _shuffle_partition(block: Block, n_red: int, kind: str, args: dict,
                       part_idx: int) -> List[Block]:
    n = block_num_rows(block)
    if kind == "random_shuffle":
        rng = np.random.default_rng(
            None if args.get("seed") is None
            else (int(args["seed"]) * 1000003 + part_idx))
        assign = rng.integers(0, n_red, size=n)
    elif kind == "sort":
        key = args["key"]
        bounds = np.asarray(args["boundaries"])
        assign = np.searchsorted(bounds, block[key], side="right")
        if args.get("descending"):
            assign = (n_red - 1) - assign
    elif kind == "repartition":
        # rows [global_start, global_start+n) cut into equal global ranges
        start = int(args["global_start"])
        size = max(1, int(args["target_size"]))
        assign = np.minimum((start + np.arange(n)) // size, n_red - 1)
    else:
        raise ValueError(kind)
    return _partition_rows(block, assign, n_red)


def _run_shuffle(stream: Iterator[Any], op: ShuffleOp) -> Iterator[Any]:
    """Distributed exchange through the streaming engine
    (``data/streaming.py``): bounded blocks-in-flight, reducer actors,
    spill-absorbed memory pressure, no global barrier. The reference's
    one-shot task exchange behind ``RTPU_DATA_STREAMING_EXCHANGE=0`` is
    not ported."""
    from ray_tpu_torch.data.streaming import run_exchange

    return run_exchange(op.kind, dict(op.args), stream)


def sample_sort_boundaries(refs: List[Any], key: str, descending: bool,
                           n_red: int) -> Dict[str, Any]:
    """Sample per-block quantiles and derive reducer key boundaries
    (index-based selection, not np.quantile: works for any sortable
    dtype, strings included). Barrier on refs only."""
    @ray_tpu_torch.remote
    def _sample(block, k=key):
        vals = block[k]
        if len(vals) == 0:
            return np.asarray([])
        take = min(32, len(vals))
        idx = np.linspace(0, len(vals) - 1, take).astype(np.int64)
        return np.sort(vals)[idx]

    samples = np.concatenate(
        [np.asarray(s) for s in
         ray_tpu_torch.get([_sample.remote(r) for r in refs])] or
        [np.asarray([])])
    if len(samples) == 0:
        bounds = np.asarray([])
    else:
        ss = np.sort(samples)
        idxs = (np.linspace(0, 1, n_red + 1)[1:-1]
                * (len(ss) - 1)).astype(np.int64)
        bounds = ss[idxs]
    return {"boundaries": bounds, "descending": descending}


def repartition_layout(refs: List[Any], n_red: int):
    """(target_size, per-block global row offsets) for an equal-range
    repartition."""
    @ray_tpu_torch.remote
    def _count(block):
        return block_num_rows(block)

    counts = ray_tpu_torch.get([_count.remote(r) for r in refs])
    total = int(sum(counts))
    target_size = max(1, (total + n_red - 1) // n_red)
    offsets = (list(np.concatenate(
        [[0], np.cumsum(counts)[:-1]]).astype(np.int64))
        if counts else [])
    return target_size, offsets


# ---------------------------------------------------------------------------
# Actor-pool map stage
# ---------------------------------------------------------------------------

class _PoolActor:
    """One warm actor of an actor-pool map stage."""

    def __init__(self, fn_blob: bytes):
        import cloudpickle as _cp

        self._fn = _cp.loads(fn_blob)

    def apply(self, block):
        for out in self._fn(block):
            yield out


def _run_limit(stream: Iterator[Any], limit: int) -> Iterator[Any]:
    remaining = limit
    for ref in stream:
        if remaining <= 0:
            return
        block = ray_tpu_torch.get(ref)
        n = block_num_rows(block)
        if n <= remaining:
            remaining -= n
            yield ref
        else:
            yield ray_tpu_torch.put(block_slice(block, 0, remaining))
            remaining = 0
            return


