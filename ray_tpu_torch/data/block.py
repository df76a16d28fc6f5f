"""Blocks: the unit of data movement in ray_tpu_torch.data (a copy of
``ray_tpu/data/block.py``).

Role analog: ``python/ray/data/block.py`` — a Dataset is a list of object
refs to Blocks. The reference standardizes on Arrow tables; here a block is
a dict of numpy arrays ("column batch") — the natural interchange for
torch (zero-copy into tensors, no Arrow dependency on the hot path)
— with pandas/arrow conversion at the edges.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

import numpy as np

Block = Dict[str, np.ndarray]


@dataclass
class BlockMetadata:
    num_rows: int
    size_bytes: int
    schema: Optional[Dict[str, str]] = None


def block_from_rows(rows: Iterable[Mapping[str, Any]]) -> Block:
    rows = list(rows)
    if not rows:
        return {}
    if not isinstance(rows[0], Mapping):
        rows = [{"item": r} for r in rows]
    cols: Dict[str, List[Any]] = {k: [] for k in rows[0]}
    for r in rows:
        for k in cols:
            cols[k].append(r[k])
    return {k: np.asarray(v) for k, v in cols.items()}


def block_to_rows(block: Block) -> List[Dict[str, Any]]:
    if not block:
        return []
    keys = list(block)
    n = len(block[keys[0]])
    return [{k: block[k][i] for k in keys} for i in range(n)]


def block_num_rows(block: Block) -> int:
    if not block:
        return 0
    return len(next(iter(block.values())))


def block_size_bytes(block: Block) -> int:
    return sum(v.nbytes for v in block.values() if hasattr(v, "nbytes"))


def block_metadata(block: Block) -> BlockMetadata:
    return BlockMetadata(
        num_rows=block_num_rows(block),
        size_bytes=block_size_bytes(block),
        schema={k: str(v.dtype) for k, v in block.items()},
    )


def block_slice(block: Block, start: int, end: int) -> Block:
    return {k: v[start:end] for k, v in block.items()}


def block_take(block: Block, indices: np.ndarray) -> Block:
    return {k: v[indices] for k, v in block.items()}


def concat_blocks(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if block_num_rows(b)]
    if not blocks:
        return {}
    keys = list(blocks[0])
    return {k: np.concatenate([b[k] for b in blocks]) for k in keys}


def block_to_pandas(block: Block):
    import pandas as pd

    return pd.DataFrame({k: list(v) if v.ndim > 1 else v
                         for k, v in block.items()})


def block_from_pandas(df) -> Block:
    return {str(c): df[c].to_numpy() for c in df.columns}


def block_to_batch(block: Block, batch_format: str = "numpy"):
    if batch_format in ("numpy", "default"):
        return block
    if batch_format == "pandas":
        return block_to_pandas(block)
    if batch_format == "arrow":
        import pyarrow as pa

        return pa.table({k: v for k, v in block.items()})
    raise ValueError(f"unknown batch_format {batch_format!r}")


def batch_to_block(batch: Union[Block, Any]) -> Block:
    if isinstance(batch, dict):
        return {k: np.asarray(v) for k, v in batch.items()}
    # arrow check must precede pandas: pyarrow.Table has .columns too
    if hasattr(batch, "column_names"):  # arrow
        return {name: batch[name].to_numpy(zero_copy_only=False)
                for name in batch.column_names}
    if hasattr(batch, "columns"):  # pandas
        return block_from_pandas(batch)
    raise TypeError(f"cannot convert {type(batch)} to a block")
