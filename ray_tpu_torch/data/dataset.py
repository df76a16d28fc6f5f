"""Dataset: lazy logical plan over blocks, streaming-executed (a copy of
``ray_tpu/data/dataset.py``).

Role analog: ``python/ray/data/dataset.py`` + the logical-operator layer
(``data/_internal/logical/``). A Dataset is (source refs, list of logical
ops); every transform appends an op and returns a new Dataset; execution
happens on iteration/consumption through the streaming executor.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    Block,
    batch_to_block,
    block_from_rows,
    block_metadata,
    block_num_rows,
    block_slice,
    block_to_batch,
    block_to_rows,
    concat_blocks,
)
from ray_tpu_torch.data.execution import (
    ActorPoolStrategy,
    AllToAllOp,
    ExecutionOptions,
    LimitOp,
    MapOp,
    ShuffleOp,
    execute_streaming,
)


class Dataset:
    def __init__(self, source_refs: Any, ops: Optional[List[Any]] = None,
                 options: Optional[ExecutionOptions] = None):
        # source: a list of block refs, OR a zero-arg callable returning an
        # iterator of raw Blocks (lazy datasource, ``read_api`` ``lazy=``):
        # lazy blocks are generated + put per execution and the streaming
        # exchange frees them once consumed, so a dataset bigger than the
        # object store can flow through a shuffle without ever being
        # materialized up front
        self._source = (source_refs if callable(source_refs)
                        else list(source_refs))
        self._ops = list(ops or [])
        self._options = options or ExecutionOptions()

    # -- plan building ----------------------------------------------------

    def _with_op(self, op) -> "Dataset":
        return Dataset(self._source, self._ops + [op], self._options)

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        fn_kwargs: Optional[Dict[str, Any]] = None,
        compute: Optional["ActorPoolStrategy"] = None,
        fn_constructor_args: tuple = (),
        **_ignored,
    ) -> "Dataset":
        kwargs = fn_kwargs or {}
        is_class = isinstance(fn, type)
        if is_class and compute is None:
            compute = ActorPoolStrategy()  # classes imply actor compute

        def _map(block: Block, _state: Dict[str, Any] = {}) -> List[Block]:
            call = fn
            if is_class:
                # per-actor (or per-task) stateful callable: construct once
                if "obj" not in _state:
                    _state["obj"] = fn(*fn_constructor_args)
                call = _state["obj"]
            out: List[Block] = []
            n = block_num_rows(block)
            size = batch_size or n or 1
            for i in range(0, max(n, 1), size):
                piece = block_slice(block, i, min(i + size, n))
                if block_num_rows(piece) == 0 and n > 0:
                    continue
                res = call(block_to_batch(piece, batch_format), **kwargs)
                out.append(batch_to_block(res))
            return out

        return self._with_op(MapOp(name="map_batches", fn=_map,
                                   compute=compute))

    def map(self, fn: Callable[[Dict[str, Any]], Dict[str, Any]]) -> "Dataset":
        def _map(block: Block) -> List[Block]:
            return [block_from_rows([fn(r) for r in block_to_rows(block)])]

        return self._with_op(MapOp(name="map", fn=_map))

    def flat_map(self, fn: Callable[[Dict[str, Any]], List[Dict[str, Any]]]
                 ) -> "Dataset":
        def _map(block: Block) -> List[Block]:
            rows: List[Dict[str, Any]] = []
            for r in block_to_rows(block):
                rows.extend(fn(r))
            return [block_from_rows(rows)] if rows else []

        return self._with_op(MapOp(name="flat_map", fn=_map))

    def filter(self, fn: Callable[[Dict[str, Any]], bool]) -> "Dataset":
        def _map(block: Block) -> List[Block]:
            keep = [r for r in block_to_rows(block) if fn(r)]
            return [block_from_rows(keep)] if keep else []

        return self._with_op(MapOp(name="filter", fn=_map))

    def add_column(self, name: str, fn: Callable[[Block], np.ndarray]
                   ) -> "Dataset":
        def _map(block: Block) -> List[Block]:
            out = dict(block)
            out[name] = np.asarray(fn(block))
            return [out]

        return self._with_op(MapOp(name="add_column", fn=_map))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def _map(block: Block) -> List[Block]:
            return [{k: v for k, v in block.items() if k not in cols}]

        return self._with_op(MapOp(name="drop_columns", fn=_map))

    def select_columns(self, cols: List[str]) -> "Dataset":
        def _map(block: Block) -> List[Block]:
            return [{k: block[k] for k in cols}]

        return self._with_op(MapOp(name="select_columns", fn=_map))

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        def _map(block: Block) -> List[Block]:
            return [{mapping.get(k, k): v for k, v in block.items()}]

        return self._with_op(MapOp(name="rename_columns", fn=_map))

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        return self._with_op(ShuffleOp("random_shuffle", "random_shuffle",
                                       {"seed": seed,
                                        "num_blocks": num_blocks}))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with_op(ShuffleOp("repartition", "repartition",
                                       {"num_blocks": num_blocks}))

    def sort(self, key: str, descending: bool = False,
             num_blocks: Optional[int] = None) -> "Dataset":
        """Global sort. ``num_blocks`` sets the number of reduce
        partitions (each streaming reducer materializes at most one
        partition — more partitions = flatter per-worker memory for
        out-of-core sorts); default one per input block."""
        return self._with_op(ShuffleOp("sort", "sort",
                                       {"key": key,
                                        "descending": descending,
                                        "num_blocks": num_blocks}))

    def limit(self, n: int) -> "Dataset":
        return self._with_op(LimitOp("limit", n))

    def union(self, *others: "Dataset") -> "Dataset":
        # materialize each side's plan into refs, then concatenate sources
        refs = list(self.iter_block_refs())
        for o in others:
            refs.extend(o.iter_block_refs())
        return Dataset(refs)

    def zip(self, other: "Dataset") -> "Dataset":
        left = concat_blocks([ray_tpu_torch.get(r) for r in self.iter_block_refs()])
        right = concat_blocks([ray_tpu_torch.get(r) for r in other.iter_block_refs()])
        if block_num_rows(left) != block_num_rows(right):
            raise ValueError("zip requires equal row counts")
        merged = dict(left)
        for k, v in right.items():
            merged[k if k not in merged else f"{k}_1"] = v
        return Dataset([ray_tpu_torch.put(merged)])

    def groupby(self, key: str) -> "GroupedData":
        from ray_tpu_torch.data.grouped import GroupedData

        return GroupedData(self, key)

    # -- execution --------------------------------------------------------

    def iter_block_refs(self) -> Iterator[Any]:
        return self._iter_with_recovery()

    def _iter_with_recovery(self) -> Iterator[Any]:
        """Execute the plan, re-executing it from lineage when an exchange
        reducer (or map-pool) actor dies before ANY output block was
        consumed. The plan's sources survive every execution — only
        ephemeral intermediates are freed — so a fresh run reproduces the
        result; past the first yield a failure must surface (a partially
        consumed stream cannot be transparently respliced)."""
        from ray_tpu_torch import config as _config
        from ray_tpu_torch.core.exceptions import ActorDiedError

        retries = int(_config.get("data_exchange_retries"))
        attempt = 0
        while True:
            source = (self._source() if callable(self._source)
                      else iter(self._source))
            stream = execute_streaming(source, self._ops, self._options)
            try:
                first = next(stream)
            except StopIteration:
                return
            except ActorDiedError:
                if attempt >= retries:
                    raise
                attempt += 1
                continue
            yield first
            yield from stream
            return

    def iter_blocks(self) -> Iterator[Block]:
        for ref in self.iter_block_refs():
            yield ray_tpu_torch.get(ref)

    def materialize(self) -> "Dataset":
        return Dataset(list(self.iter_block_refs()))

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for block in self.iter_blocks():
            yield from block_to_rows(block)

    def iter_batches(
        self,
        *,
        batch_size: int = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        prefetch_batches: int = 1,
    ) -> Iterator[Any]:
        from ray_tpu_torch.data.iterator import iter_batches_from_blocks

        return iter_batches_from_blocks(
            self.iter_blocks(), batch_size=batch_size,
            batch_format=batch_format, drop_last=drop_last,
            prefetch_batches=prefetch_batches)

    def iterator(self) -> "DataIterator":
        from ray_tpu_torch.data.iterator import DataIterator

        return DataIterator(self)

    def streaming_split(self, n: int, *, equal: bool = True
                        ) -> List["DataIterator"]:
        """Split into n iterators for n training workers (reference
        ``Dataset.streaming_split`` used by Train's DataConfig)."""
        from ray_tpu_torch.data.iterator import DataIterator

        return [DataIterator(self, split_index=i, num_splits=n)
                for i in range(n)]

    def split(self, n: int) -> List["Dataset"]:
        blocks = list(self.iter_block_refs())
        whole = concat_blocks([ray_tpu_torch.get(r) for r in blocks])
        total = block_num_rows(whole)
        size = (total + n - 1) // n
        return [Dataset([ray_tpu_torch.put(block_slice(whole, i * size,
                                                 min((i + 1) * size, total)))])
                for i in range(n)]

    # -- consumption ------------------------------------------------------

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(block_num_rows(b) for b in self.iter_blocks())

    def schema(self) -> Optional[Dict[str, str]]:
        for block in self.iter_blocks():
            if block:
                return {k: str(v.dtype) for k, v in block.items()}
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s) if s else []

    def num_blocks(self) -> int:
        return sum(1 for _ in self.iter_block_refs())

    def size_bytes(self) -> int:
        return sum(block_metadata(b).size_bytes for b in self.iter_blocks())

    def to_pandas(self):
        from ray_tpu_torch.data.block import block_to_pandas

        return block_to_pandas(concat_blocks(list(self.iter_blocks())))

    def to_arrow(self):
        """One pyarrow Table over all blocks (reference
        ``Dataset.to_arrow_refs`` role, materialized). Tensor columns
        (ndim > 1) become arrow list columns, matching write_parquet."""
        import pyarrow as pa

        block = concat_blocks(list(self.iter_blocks()))
        return pa.table({k: pa.array(list(v) if getattr(v, "ndim", 1) > 1
                                     else v)
                         for k, v in block.items()})

    def sum(self, col: str) -> float:
        return float(sum(b[col].sum() for b in self.iter_blocks() if col in b))

    def min(self, col: str) -> float:
        return float(min(b[col].min() for b in self.iter_blocks() if col in b))

    def max(self, col: str) -> float:
        return float(max(b[col].max() for b in self.iter_blocks() if col in b))

    def mean(self, col: str) -> float:
        total, count = 0.0, 0
        for b in self.iter_blocks():
            if col in b:
                total += float(b[col].sum())
                count += len(b[col])
        return total / max(count, 1)

    # -- writes -----------------------------------------------------------

    def write_parquet(self, path: str) -> None:
        import os

        import pyarrow as pa
        import pyarrow.parquet as pq

        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self.iter_blocks()):
            table = pa.table({k: list(v) if v.ndim > 1 else v
                              for k, v in block.items()})
            pq.write_table(table, f"{path}/part-{i:05d}.parquet")

    def write_csv(self, path: str) -> None:
        import os

        os.makedirs(path, exist_ok=True)
        from ray_tpu_torch.data.block import block_to_pandas

        for i, block in enumerate(self.iter_blocks()):
            block_to_pandas(block).to_csv(f"{path}/part-{i:05d}.csv",
                                          index=False)

    def write_json(self, path: str) -> None:
        import os

        os.makedirs(path, exist_ok=True)
        from ray_tpu_torch.data.block import block_to_pandas

        for i, block in enumerate(self.iter_blocks()):
            block_to_pandas(block).to_json(f"{path}/part-{i:05d}.json",
                                           orient="records", lines=True)

    def __repr__(self):
        ops = " -> ".join(op.name for op in self._ops) or "source"
        src = ("lazy source" if callable(self._source)
               else f"{len(self._source)} source blocks")
        return f"Dataset({src}, plan: {ops})"
