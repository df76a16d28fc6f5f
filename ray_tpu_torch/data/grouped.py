"""GroupedData: groupby + aggregations (a copy of
``ray_tpu/data/grouped.py``).

Role analog: ``python/ray/data/grouped_data.py``. Aggregation is a
DISTRIBUTED hash-partitioned exchange through the streaming engine
(``data/streaming.py``): partition tasks hash rows by key to reducer
actors, each reducer groups + aggregates its partition, and only the
(small) aggregated rows return to the driver — block bytes never
materialize there (the round-2 version concatenated the whole dataset in
the driver process).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, block_num_rows, block_take


def _hash_assign(keys: np.ndarray, n_red: int) -> np.ndarray:
    """Per-row reducer assignment, identical in EVERY process. Python's
    ``hash()`` is salted per interpreter (workers are separate
    executables), which would scatter one key across reducers and return
    duplicate, split groups — use a keyed-nothing blake2 digest instead."""
    import hashlib

    if keys.dtype.kind in "iub":
        return (keys.astype(np.int64) % n_red + n_red) % n_red
    return np.asarray(
        [int.from_bytes(hashlib.blake2b(str(k).encode(),
                                        digest_size=8).digest(),
                        "little") % n_red
         for k in keys.tolist()], dtype=np.int64)


def _group_block(block: Block, key: str) -> List[tuple]:
    """(key value, sub-block) pairs of one partition, sorted by key."""
    if not block or block_num_rows(block) == 0:
        return []
    keys = block[key]
    order = np.argsort(keys, kind="stable")
    sorted_block = block_take(block, order)
    sorted_keys = sorted_block[key]
    out = []
    starts = np.flatnonzero(
        np.concatenate([[True], sorted_keys[1:] != sorted_keys[:-1]]))
    ends = np.concatenate([starts[1:], [len(sorted_keys)]])
    for start, end in zip(starts, ends):
        kv = sorted_keys[start]
        out.append((kv.item() if hasattr(kv, "item") else kv,
                    {k: v[start:end] for k, v in sorted_block.items()}))
    return out


def _partition_by_key(block: Block, key: str, n_red: int) -> List[Block]:
    n = block_num_rows(block)
    if n == 0:
        return [{} for _ in range(n_red)]
    assign = _hash_assign(block[key], n_red)
    return [{k: v[np.flatnonzero(assign == j)] for k, v in block.items()}
            for j in range(n_red)]


def _exchange_refs_with_recovery(kind: str, args: dict, dataset) -> List[Any]:
    """Drive one streaming groupby exchange to completion; a reducer-actor
    death re-runs the WHOLE exchange from the dataset's lineage (same
    recovery contract as ``Dataset._iter_with_recovery`` — the groupby
    entry points consume fully, so a restart can never duplicate output)."""
    from ray_tpu_torch import config
    from ray_tpu_torch.core.exceptions import ActorDiedError
    from ray_tpu_torch.data.streaming import run_exchange

    retries = int(config.get("data_exchange_retries"))
    for attempt in range(retries + 1):
        try:
            return list(run_exchange(kind, dict(args),
                                     dataset.iter_block_refs()))
        except ActorDiedError:
            if attempt >= retries:
                raise
    raise AssertionError("unreachable")


class GroupedData:
    def __init__(self, dataset, key: str):
        self._dataset = dataset
        self._key = key

    def _agg_rows(self, kind: str, args: dict):
        """Run a streaming groupby exchange; only the (small) aggregated
        rows ever return to the driver."""
        from ray_tpu_torch.data.block import block_from_rows
        from ray_tpu_torch.data.dataset import Dataset

        rows: List[Dict[str, Any]] = []
        for ref in _exchange_refs_with_recovery(kind, args, self._dataset):
            rows.extend(ray_tpu_torch.get(ref))
        rows.sort(key=lambda r: r[self._key])
        return Dataset([ray_tpu_torch.put(block_from_rows(rows))])

    def _agg_specs(self, specs: List[tuple]):
        """Built-in aggregations as COMBINABLE (op, col, out_name) specs:
        the streaming reducer folds them into per-key accumulators, so the
        aggregation runs in O(distinct keys) memory at any dataset size."""
        return self._agg_rows("groupby_agg",
                              {"key": self._key, "specs": specs})

    def count(self):
        return self._agg_specs([("count", None, "count()")])

    def sum(self, col: str):
        return self._agg_specs([("sum", col, f"sum({col})")])

    def mean(self, col: str):
        return self._agg_specs([("mean", col, f"mean({col})")])

    def min(self, col: str):
        return self._agg_specs([("min", col, f"min({col})")])

    def max(self, col: str):
        return self._agg_specs([("max", col, f"max({col})")])

    def std(self, col: str):
        return self._agg_specs([("std", col, f"std({col})")])

    def aggregate(self, name: str, fn: Callable[[Block], Any]):
        """Arbitrary per-group aggregation — not combinable, so the
        streaming reducer materializes each hash partition (only its own)
        at finish."""
        import cloudpickle as _cp

        blob = _cp.dumps(lambda k, b, _fn=fn, _n=name: {_n: _fn(b)})
        return self._agg_rows("groupby_fn",
                              {"key": self._key, "cols_fn_blob": blob})

    def map_groups(self, fn: Callable[[Block], Block]):
        import cloudpickle as _cp

        from ray_tpu_torch.data.dataset import Dataset

        refs = _exchange_refs_with_recovery(
            "groupby_groups", {"key": self._key, "fn_blob": _cp.dumps(fn)},
            self._dataset)
        return Dataset(refs)
