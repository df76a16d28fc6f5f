"""Streaming all-to-all exchange engine for ray_tpu_torch.data (a copy of
``ray_tpu/data/streaming.py``).

Role analog: the reference's push-based shuffle / exchange operators
(``python/ray/data/_internal/planner/exchange/`` executed by the streaming
executor) — the piece that lets sort/shuffle/repartition/groupby run over
datasets LARGER than the object store. A one-shot exchange that
dispatches every partition task at once holds the whole partitioned
dataset in the store simultaneously; this engine is a pipeline instead
(the port keeps no such one-shot exchange):

- **map side**: one partition task per input block emits one block per
  logical reduce partition (``num_returns=n_red``), dispatched under a
  bounded blocks-in-flight window;
- **scheduler** (driver side): as each partition task finishes, its
  per-partition blocks are forwarded to reducer ACTORS as actor calls (the
  block travels by ref; the runtime resolves it on the reducer's node) and
  the source blocks are freed (:func:`ray_tpu_torch.free`) the moment every
  reducer acked — exchange intermediates never accumulate;
- **reduce side**: each reducer actor owns ``n_red / R`` logical
  partitions. Sort reducers buffer rows and flush SORTED RUNS to the
  object store when the buffer passes ``data_exchange_run_bytes`` (the
  store's spill path moves runs to disk under memory pressure) and
  k-way-merge the runs at finish; shuffle/repartition reducers stage
  incoming blocks back into the store and only materialize their own
  partition at finish; combinable groupby aggregations fold into per-key
  accumulators and never materialize at all.

Backpressure: at most ``data_exchange_inflight`` partition-output blocks
are unconsumed (not yet acked by a reducer) at any moment; the scheduler
stops dispatching partition tasks while over the bound. There is no global
barrier for random_shuffle/groupby; sort and repartition take a barrier on
input REFS only (sample boundaries / row offsets), never on block bytes.

Everything here uses the public task/actor/object API only,
including :func:`ray_tpu_torch.free` for eager intermediate reclamation.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch import config
from ray_tpu_torch.data.block import (
    Block,
    block_num_rows,
    block_size_bytes,
    block_slice,
    block_take,
    concat_blocks,
)

#: instrumentation for tests/debugging: counters of the most recently
#: finished exchange (max blocks in flight seen, parts, bytes, ...)
_LAST_EXCHANGE_STATS: Dict[str, Any] = {}


def _exchange_metrics():
    """Engine metrics (reference data-metrics role), defined centrally in
    util/metric_defs.py; registered on first exchange so a /metrics
    scrape during a run shows the live values. metric_defs.get caches
    and survives clear_registry, so the accessor just rebuilds."""
    from ray_tpu_torch.util import metric_defs as md

    return {
        "in_flight": md.get("rtpu_data_exchange_blocks_in_flight"),
        "queue_depth": md.get("rtpu_data_exchange_reducer_queue_depth"),
        "bytes": md.get("rtpu_data_exchange_bytes_total"),
        "blocks": md.get("rtpu_data_exchange_blocks_total"),
    }


# ---------------------------------------------------------------------------
# map side: partition functions (run as tasks)
# ---------------------------------------------------------------------------

def _exchange_partition(block: Block, n_red: int, kind: str, args: dict,
                        part_idx: int) -> List[Block]:
    """Split one input block into ``n_red`` per-partition blocks."""
    from ray_tpu_torch.util import tracing

    # map-stage span: with tracing armed, each exchange stage shows up on
    # the unified timeline as map -> (forwarded actor calls) -> reduce
    with tracing.span("data.exchange::map",
                      {"kind": kind, "part": part_idx}):
        if kind.startswith("groupby"):
            from ray_tpu_torch.data.grouped import _partition_by_key

            return _partition_by_key(block, args["key"], n_red)
        from ray_tpu_torch.data.execution import _shuffle_partition

        return _shuffle_partition(block, n_red, kind, args, part_idx)


# ---------------------------------------------------------------------------
# reduce side: the reducer actor
# ---------------------------------------------------------------------------

def _copy_block(block: Block) -> Block:
    """Deep-copy a block out of its zero-copy shm views — buffered rows
    must not pin the source segment (the whole point is freeing it)."""
    return {k: np.array(v, copy=True) for k, v in block.items()}


def _chunk_rows(blocks: List[Block], target_rows: int) -> Iterator[Block]:
    """Re-chunk a sequence of blocks into ~target_rows output blocks."""
    carry: List[Block] = []
    rows = 0
    for b in blocks:
        n = block_num_rows(b)
        if not n:
            continue
        carry.append(b)
        rows += n
        while rows >= target_rows:
            merged = concat_blocks(carry)
            yield block_slice(merged, 0, target_rows)
            rest = block_slice(merged, target_rows, rows)
            carry = [rest] if block_num_rows(rest) else []
            rows -= target_rows
    if rows:
        yield concat_blocks(carry)


def _merge_sorted_blocks(blocks: List[Block], key: str,
                         window: int = 65536) -> Iterator[Block]:
    """K-way merge of ascending-sorted blocks, vectorized: each step picks
    the smallest "window-end key" (pivot) across live runs, consumes every
    row <= pivot from every run (searchsorted), and sorts that bounded
    slice. Peak memory is O(runs * window), never the partition size."""
    blocks = [b for b in blocks if block_num_rows(b)]
    cursors = [0] * len(blocks)
    sizes = [block_num_rows(b) for b in blocks]
    while True:
        live = [i for i in range(len(blocks)) if cursors[i] < sizes[i]]
        if not live:
            return
        if len(live) == 1:
            i = live[0]
            yield block_slice(blocks[i], cursors[i], sizes[i])
            cursors[i] = sizes[i]
            continue
        pivot = min(blocks[i][key][min(cursors[i] + window, sizes[i]) - 1]
                    for i in live)
        parts = []
        for i in live:
            keys = blocks[i][key]
            hi = cursors[i] + int(np.searchsorted(
                keys[cursors[i]:sizes[i]], pivot, side="right"))
            if hi > cursors[i]:
                parts.append(block_slice(blocks[i], cursors[i], hi))
                cursors[i] = hi
        merged = concat_blocks(parts)
        order = np.argsort(merged[key], kind="stable")
        yield block_take(merged, order)


# combinable groupby aggregations: (op, col, out_name) specs fold into
# tiny per-key accumulators, so an aggregation over any dataset size runs
# in O(distinct keys) reducer memory
_COMBINABLE_OPS = ("count", "sum", "min", "max", "mean", "std")


def _acc_update(op: str, cur, sub: Block, col: Optional[str]):
    n = block_num_rows(sub)
    v = sub[col] if col else None
    if op == "count":
        return (cur or 0) + n
    if op == "sum":
        return (cur or 0.0) + float(v.sum())
    if op == "min":
        m = float(v.min())
        return m if cur is None else min(cur, m)
    if op == "max":
        m = float(v.max())
        return m if cur is None else max(cur, m)
    if op == "mean":
        c = cur or (0, 0.0)
        return (c[0] + n, c[1] + float(v.sum()))
    if op == "std":
        c = cur or (0, 0.0, 0.0)
        v64 = v.astype(np.float64)
        return (c[0] + n, c[1] + float(v64.sum()),
                c[2] + float((v64 * v64).sum()))
    raise ValueError(op)


def _acc_finalize(op: str, cur):
    if op == "count":
        return int(cur or 0)
    if op == "sum":
        return float(cur or 0.0)
    if op in ("min", "max"):
        return cur
    if op == "mean":
        return cur[1] / max(cur[0], 1)
    if op == "std":
        n, s, ss = cur
        mean = s / max(n, 1)
        return float(np.sqrt(max(ss / max(n, 1) - mean * mean, 0.0)))
    raise ValueError(op)


class _ExchangeReducer:
    """One reducer actor owning several logical reduce partitions.

    ``add_block`` receives partition blocks BY VALUE (the runtime resolves
    the forwarded ref on this node) and either folds them (combinable
    groupby), buffers copies + flushes sorted runs to the store (sort), or
    stages them back into the store as refs (shuffle/repartition/generic
    groupby) so its own heap stays bounded until ``finish``. ``finish`` is
    a streaming generator: output blocks flow to consumers as they are
    produced."""

    def __init__(self, kind: str, args_blob: bytes):
        import cloudpickle as _cp

        self._kind = kind
        self._args = _cp.loads(args_blob)
        self._parts: Dict[int, dict] = {}
        self._run_bytes = int(config.get("data_exchange_run_bytes"))
        self._target_rows = int(config.get("data_exchange_target_rows"))

    def _state(self, part: int) -> dict:
        st = self._parts.get(part)
        if st is None:
            st = {"runs": [], "held": [], "buf": [], "buf_bytes": 0,
                  "accs": {}}
            self._parts[part] = st
        return st

    # -- streaming ingest -------------------------------------------------

    def add_block(self, part: int, order_key: int,
                  block: Block) -> Tuple[int, int]:
        """Consume one partition block; returns (rows, bytes) as the ack
        the scheduler's backpressure window waits on."""
        from ray_tpu_torch.util import tracing

        with tracing.span("data.exchange::reduce",
                          {"kind": self._kind, "part": part}):
            return self._add_block_inner(part, order_key, block)

    def _add_block_inner(self, part: int, order_key: int,
                         block: Block) -> Tuple[int, int]:
        st = self._state(part)
        rows = block_num_rows(block)
        nbytes = block_size_bytes(block)
        if rows == 0:
            return 0, 0
        if self._kind == "sort":
            st["buf"].append(_copy_block(block))
            st["buf_bytes"] += nbytes
            if st["buf_bytes"] >= self._run_bytes:
                self._flush_run(st)
        elif self._kind == "groupby_agg":
            from ray_tpu_torch.data.grouped import _group_block

            for kv, sub in _group_block(block, self._args["key"]):
                accs = st["accs"].setdefault(
                    kv, [None] * len(self._args["specs"]))
                for si, (op, col, _name) in enumerate(self._args["specs"]):
                    accs[si] = _acc_update(op, accs[si], sub, col)
        else:
            # shuffle/repartition/groupby_fn/groupby_groups: stage the
            # block back into the store (it spills under pressure) and
            # keep only the ref; (order_key, ref) lets finish reassemble
            # in INPUT order, which repartition's order-preservation and
            # seeded shuffles' determinism both need
            st["held"].append((order_key, ray_tpu_torch.put(_copy_block(block))))
        return rows, nbytes

    def _flush_run(self, st: dict) -> None:
        merged = concat_blocks(st["buf"])
        st["buf"] = []
        st["buf_bytes"] = 0
        order = np.argsort(merged[self._args["key"]], kind="stable")
        st["runs"].append(ray_tpu_torch.put(block_take(merged, order)))

    def _assemble(self, st: dict) -> Block:
        """Materialize this partition (and only this partition) in input
        order; frees the staged refs as it goes."""
        held = sorted(st["held"], key=lambda t: t[0])
        st["held"] = []
        blocks = []
        for _, ref in held:
            blocks.append(_copy_block(ray_tpu_torch.get(ref)))
            ray_tpu_torch.free(ref)
        return concat_blocks(blocks)

    # -- finish: stream this partition's output ---------------------------

    def finish(self, part: int):
        st = self._state(part)
        kind = self._kind
        if kind == "sort":
            yield from self._finish_sort(st)
        elif kind == "random_shuffle":
            merged = self._assemble(st)
            n = block_num_rows(merged)
            if n:
                seed = self._args.get("seed")
                rng = np.random.default_rng(
                    None if seed is None else int(seed) * 9176 + part)
                merged = block_take(merged, rng.permutation(n))
                yield from _chunk_rows([merged], self._target_rows)
        elif kind == "repartition":
            # exactly one output block per logical partition: the
            # num_blocks contract
            merged = self._assemble(st)
            yield merged
        elif kind == "groupby_agg":
            key = self._args["key"]
            rows = []
            for kv, accs in st["accs"].items():
                row = {key: kv}
                for (op, _col, name), acc in zip(self._args["specs"], accs):
                    row[name] = _acc_finalize(op, acc)
                rows.append(row)
            yield rows
        elif kind == "groupby_fn":
            import cloudpickle as _cp

            from ray_tpu_torch.data.grouped import _group_block

            cols_fn = _cp.loads(self._args["cols_fn_blob"])
            key = self._args["key"]
            merged = self._assemble(st)
            yield [{key: kv, **cols_fn(kv, sub)}
                   for kv, sub in _group_block(merged, key)]
        elif kind == "groupby_groups":
            import cloudpickle as _cp

            from ray_tpu_torch.data.grouped import _group_block

            fn = _cp.loads(self._args["fn_blob"])
            merged = self._assemble(st)
            for _kv, sub in _group_block(merged, self._args["key"]):
                yield fn(sub)
        else:
            raise ValueError(kind)
        self._parts.pop(part, None)

    def _finish_sort(self, st: dict):
        if st["buf"]:
            self._flush_run(st)
        runs = st["runs"]
        st["runs"] = []
        key = self._args["key"]
        blocks = [ray_tpu_torch.get(r) for r in runs]
        merge = _chunk_rows(_merge_sorted_blocks(blocks, key),
                            self._target_rows)
        if not self._args.get("descending"):
            for out in merge:
                yield out
        else:
            # runs are stored ascending (searchsorted needs that, and it
            # stays dtype-generic — strings sort too); a descending
            # partition is the ascending merge emitted back-to-front, so
            # stage the merged chunks as refs and replay them reversed
            staged = [ray_tpu_torch.put(out) for out in merge]
            for ref in reversed(staged):
                b = ray_tpu_torch.get(ref)
                yield {k: v[::-1].copy() for k, v in b.items()}
                ray_tpu_torch.free(ref)
        del blocks
        if runs:
            ray_tpu_torch.free(runs)


# ---------------------------------------------------------------------------
# driver-side scheduler
# ---------------------------------------------------------------------------

class _PendingPart:
    __slots__ = ("refs", "input_ref", "idx", "forwarded", "unacked")

    def __init__(self, refs, input_ref, idx):
        self.refs = refs
        self.input_ref = input_ref
        self.idx = idx
        self.forwarded = False
        self.unacked = 0


def run_exchange(kind: str, args: Dict[str, Any],
                 stream: Iterator[Any]) -> Iterator[Any]:
    """Execute one streaming exchange; yields output refs (sort: globally
    ordered across partitions; repartition: exactly ``num_blocks`` blocks;
    groupby kinds: one ref per reduce partition / group)."""
    yield from _ExchangeScheduler(kind, dict(args)).run(stream)


class _ExchangeScheduler:
    def __init__(self, kind: str, args: Dict[str, Any]):
        self.kind = kind
        self.args = args
        self.max_inflight = max(1, int(config.get("data_exchange_inflight")))
        self.max_reducers = max(1, int(config.get("data_exchange_reducers")))
        self.stats = {"kind": kind, "parts": 0, "blocks": 0, "bytes": 0,
                      "max_in_flight_seen": 0, "partitions": 0,
                      "reducers": 0}
        self._reducers: List[Any] = []

    # -- prologues --------------------------------------------------------

    def _prologue(self, stream):
        """Kind-specific setup. Sort and repartition need a barrier on
        input REFS (boundary sampling / global row offsets) — block bytes
        stay distributed; random_shuffle and groupby start partitioning
        the moment the first upstream block lands."""
        from ray_tpu_torch.data.execution import (repartition_layout,
                                            sample_sort_boundaries)

        args = self.args
        if self.kind == "sort":
            refs = list(stream)
            self.n_red = self._n_red_for(len(refs))
            args.update(sample_sort_boundaries(
                refs, args["key"], bool(args.get("descending")),
                self.n_red))
            self.offsets = None
            return iter(refs)
        if self.kind == "repartition":
            refs = list(stream)
            self.n_red = max(1, int(args.get("num_blocks") or len(refs) or 1))
            args["target_size"], self.offsets = repartition_layout(
                refs, self.n_red)
            return iter(refs)
        # streaming kinds: partition count fixed up front, input unknown
        if self.kind == "random_shuffle":
            self.n_red = max(1, int(args.get("num_blocks")
                                    or self.max_reducers))
        else:  # groupby_*
            self.n_red = max(1, int(args.get("num_partitions")
                                    or 2 * self.max_reducers))
        self.offsets = None
        return stream

    def _n_red_for(self, n_inputs: int) -> int:
        return max(1, int(self.args.get("num_blocks") or n_inputs or 1))

    # -- scheduling loop --------------------------------------------------

    def run(self, stream: Iterator[Any]) -> Iterator[Any]:
        from ray_tpu_torch.data import execution as _ex

        stream = self._prologue(stream)
        n_red = self.n_red
        self.stats["partitions"] = n_red
        m = _exchange_metrics()

        if n_red > 1:
            part_task = ray_tpu_torch.remote(
                num_returns=n_red)(_exchange_partition)
        else:
            part_task = ray_tpu_torch.remote(
                lambda b, n, k, a, i: _exchange_partition(b, n, k, a, i)[0])

        pending: deque = deque()      # dispatched partition tasks
        acks: Dict[Any, tuple] = {}   # ack ref -> (_PendingPart, owner idx)
        per_owner_depth: Dict[int, int] = {}
        exhausted = False
        input_idx = 0
        max_part_tasks = max(2, self.max_inflight // max(1, n_red))

        def in_flight() -> int:
            return (n_red * sum(1 for p in pending if not p.forwarded)
                    + sum(p.unacked for p in pending))

        def dispatch_one() -> bool:
            nonlocal exhausted, input_idx
            if exhausted:
                return False
            try:
                ref = next(stream)
            except StopIteration:
                exhausted = True
                return False
            a = dict(self.args)
            if self.offsets is not None:
                a["global_start"] = int(self.offsets[input_idx])
            out = part_task.remote(ref, n_red, self.kind, a, input_idx)
            refs = out if n_red > 1 else [out]
            pending.append(_PendingPart(refs, ref, input_idx))
            input_idx += 1
            self.stats["parts"] += 1
            return True

        def forward(p: _PendingPart) -> None:
            self._ensure_reducers()
            for j, r in enumerate(p.refs):
                owner = j % len(self._reducers)
                ack = self._reducers[owner].add_block.remote(j, p.idx, r)
                acks[ack] = (p, owner)
                per_owner_depth[owner] = per_owner_depth.get(owner, 0) + 1
                m["queue_depth"].set(per_owner_depth[owner],
                                     {"reducer": str(owner)})
            p.forwarded = True
            p.unacked = len(p.refs)

        def retire_ack(ack) -> None:
            from ray_tpu_torch.util import failpoints

            p, owner = acks.pop(ack)
            # chaos site: ack retirement — delay throttles the window
            # (backpressure under a slow driver); raise simulates a
            # reducer-side ingest failure surfacing here
            failpoints.hit("data.exchange.ack", owner)
            rows, nbytes = ray_tpu_torch.get(ack)  # raises on reducer error
            self.stats["blocks"] += 1
            self.stats["bytes"] += nbytes
            m["blocks"].inc(tags={"kind": self.kind})
            if nbytes:
                m["bytes"].inc(nbytes, tags={"kind": self.kind})
            per_owner_depth[owner] -= 1
            m["queue_depth"].set(per_owner_depth[owner],
                                 {"reducer": str(owner)})
            p.unacked -= 1
            if p.unacked == 0:
                # every reducer consumed its slice: reclaim the exchange
                # intermediates now (and the input block too when the
                # executor owns it)
                ray_tpu_torch.free(p.refs)
                if _ex.is_ephemeral(p.input_ref):
                    _ex.unmark_ephemeral(p.input_ref)
                    ray_tpu_torch.free(p.input_ref)
                p.refs = []
                p.input_ref = None
                pending.remove(p)

        def sample_gauges() -> None:
            fl = in_flight()
            self.stats["max_in_flight_seen"] = max(
                self.stats["max_in_flight_seen"], fl)
            m["in_flight"].set(fl)
            # spill_dir_bytes is NOT sampled here: the StoreClient
            # collector owns that gauge and runs right before every
            # snapshot, so a second writer could never be observed

        try:
            while True:
                progressed = 0
                # dispatch partition tasks under both windows (always let
                # one run when the pipe is empty, else n_red > window
                # would deadlock)
                while ((in_flight() + n_red <= self.max_inflight
                        or not pending)
                       and sum(1 for p in pending
                               if not p.forwarded) < max_part_tasks
                       and dispatch_one()):
                    progressed += 1
                # forward completed partition tasks
                waitable = [p.refs[0] for p in pending if not p.forwarded]
                if waitable:
                    ready, _ = ray_tpu_torch.wait(
                        waitable, num_returns=len(waitable), timeout=0)
                    ready_set = set(ready)
                    for p in list(pending):
                        if not p.forwarded and p.refs[0] in ready_set:
                            forward(p)
                            progressed += 1
                # retire ready acks
                if acks:
                    ready, _ = ray_tpu_torch.wait(list(acks), timeout=0,
                                            num_returns=len(acks))
                    for ack in ready:
                        retire_ack(ack)
                        progressed += 1
                sample_gauges()
                if exhausted and not pending:
                    break
                if not progressed:
                    watch = [p.refs[0] for p in pending
                             if not p.forwarded] + list(acks)
                    if watch:
                        ray_tpu_torch.wait(watch, num_returns=1, timeout=5)
            # reduce epilogue: stream every partition's output in
            # partition order (sort's global order depends on it); all
            # generators are kicked off first so reducers run concurrently
            if self._reducers:
                gens = []
                for j in range(n_red):
                    owner = self._reducers[j % len(self._reducers)]
                    gens.append(owner.finish.options(
                        num_returns="streaming").remote(j))
                for gen in gens:
                    for ref in gen:
                        yield ref
        finally:
            m["in_flight"].set(0)
            for i in range(len(self._reducers)):
                m["queue_depth"].set(0, {"reducer": str(i)})
            for red in self._reducers:
                try:
                    ray_tpu_torch.kill(red)
                except Exception:
                    pass
            self.stats["reducers"] = len(self._reducers)
            _LAST_EXCHANGE_STATS.clear()
            _LAST_EXCHANGE_STATS.update(self.stats)

    def _ensure_reducers(self) -> None:
        if self._reducers:
            return
        import cloudpickle as _cp

        blob = _cp.dumps(self.args)
        cls = ray_tpu_torch.remote(_ExchangeReducer)
        n = min(self.max_reducers, self.n_red)
        # num_cpus=0: reducers are mostly-idle accumulators; holding a CPU
        # slot each would starve the partition tasks on small boxes
        self._reducers = [cls.options(num_cpus=0).remote(self.kind, blob)
                          for _ in range(n)]
