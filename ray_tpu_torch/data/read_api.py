"""Datasource read/from_* APIs (a copy of ``ray_tpu/data/read_api.py``).

Role analog: ``python/ray/data/read_api.py`` + ``data/datasource/``. Reads
are lazy in the reference via read tasks; here the file listing happens
eagerly (cheap) and per-file parsing runs as map tasks in the streaming
plan, which preserves the "read is parallelized over files" property.
"""

from __future__ import annotations

import builtins
import glob
import os
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, block_from_rows
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data.execution import MapOp


def _paths(path_or_paths, suffix: str) -> List[str]:
    paths = ([path_or_paths] if isinstance(path_or_paths, str)
             else list(path_or_paths))
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, f"*{suffix}"))))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {path_or_paths!r}")
    return out


def _file_dataset(files: List[str], parse) -> Dataset:
    """One source block of file paths; parsing fans out as map tasks."""
    path_blocks = [{"__path": np.asarray([f], dtype=object)} for f in files]

    def _parse(block: Block) -> List[Block]:
        return [parse(str(block["__path"][0]))]

    refs = [ray_tpu_torch.put(b) for b in path_blocks]
    return Dataset(refs, [MapOp(name="read", fn=_parse)])


# -- in-memory sources ------------------------------------------------------

def range(n: int, *, parallelism: int = 8,  # noqa: A001
          lazy: bool = False) -> Dataset:
    """Integer range dataset. ``lazy=True`` defers block creation to
    execution time: blocks are generated + put as the plan pulls them and
    the streaming exchange frees each one once consumed, so a range far
    larger than the object store can flow through a sort/shuffle without
    ever being materialized at once (map-only plans still retain their
    output blocks — only exchanges reclaim eagerly)."""
    parallelism = max(1, min(parallelism, n or 1))
    size = (n + parallelism - 1) // parallelism

    def gen():
        if not n:
            yield {}
            return
        for i in builtins.range(0, n, size):
            yield {"id": np.arange(i, min(i + size, n), dtype=np.int64)}

    if lazy:
        return Dataset(gen)
    return Dataset([ray_tpu_torch.put(b) for b in gen()])


def range_tensor(n: int, *, shape=(1,), parallelism: int = 8) -> Dataset:
    parallelism = max(1, min(parallelism, n or 1))
    size = (n + parallelism - 1) // parallelism
    blocks = []
    for i in builtins.range(0, n, size):
        ids = np.arange(i, min(i + size, n), dtype=np.int64)
        data = np.broadcast_to(ids.reshape((-1,) + (1,) * len(shape)),
                               (len(ids),) + tuple(shape)).copy()
        blocks.append({"data": data})
    return Dataset([ray_tpu_torch.put(b) for b in (blocks or [{}])])


def from_items(items: List[Any], *, parallelism: int = 8,
               lazy: bool = False) -> Dataset:
    n = len(items)
    parallelism = max(1, min(parallelism, n or 1))
    size = (n + parallelism - 1) // parallelism

    def gen():
        blocks = [block_from_rows(items[i:i + size])
                  for i in builtins.range(0, n, size)]
        yield from (blocks or [{}])

    if lazy:
        return Dataset(gen)
    return Dataset([ray_tpu_torch.put(b) for b in gen()])


def from_numpy(arr: np.ndarray, *, column: str = "data",
               parallelism: int = 8) -> Dataset:
    n = len(arr)
    parallelism = max(1, min(parallelism, n or 1))
    size = (n + parallelism - 1) // parallelism
    blocks = [{column: arr[i:i + size]}
              for i in builtins.range(0, n, size)]
    return Dataset([ray_tpu_torch.put(b) for b in (blocks or [{}])])


def from_pandas(df) -> Dataset:
    from ray_tpu_torch.data.block import block_from_pandas

    return Dataset([ray_tpu_torch.put(block_from_pandas(df))])


def from_arrow(table) -> Dataset:
    from ray_tpu_torch.data.block import batch_to_block

    return Dataset([ray_tpu_torch.put(batch_to_block(table))])


# -- file sources -----------------------------------------------------------

def read_parquet(path, **kw) -> Dataset:
    def parse(f: str) -> Block:
        import pyarrow.parquet as pq

        from ray_tpu_torch.data.block import batch_to_block

        return batch_to_block(pq.read_table(f))

    return _file_dataset(_paths(path, ".parquet"), parse)


def read_csv(path, **kw) -> Dataset:
    def parse(f: str) -> Block:
        import pandas as pd

        from ray_tpu_torch.data.block import block_from_pandas

        return block_from_pandas(pd.read_csv(f))

    return _file_dataset(_paths(path, ".csv"), parse)


def read_json(path, **kw) -> Dataset:
    def parse(f: str) -> Block:
        import pandas as pd

        from ray_tpu_torch.data.block import block_from_pandas

        return block_from_pandas(pd.read_json(f, orient="records", lines=True))

    return _file_dataset(_paths(path, ".json"), parse)


def read_numpy(path, **kw) -> Dataset:
    def parse(f: str) -> Block:
        return {"data": np.load(f)}

    return _file_dataset(_paths(path, ".npy"), parse)


def read_images(path, *, size=None, mode: str = "RGB", **kw) -> Dataset:
    """Image files -> tensor column (reference ``data/datasource``
    image reader role). ``size=(H, W)`` resizes so blocks stack into one
    [N, H, W, C] array (the ingest-friendly layout); without it each
    image keeps its own shape in an object column."""
    def parse(f: str) -> Block:
        from PIL import Image

        img = Image.open(f).convert(mode)
        if size is not None:
            img = img.resize((size[1], size[0]))
        arr = np.asarray(img)
        if size is not None:
            return {"image": arr[None], "path": np.asarray([f], object)}
        boxed = np.empty(1, object)
        boxed[0] = arr
        return {"image": boxed, "path": np.asarray([f], object)}

    exts = (".png", ".jpg", ".jpeg", ".bmp", ".gif")
    paths = [p for p in _paths(path, "") if p.lower().endswith(exts)]
    if not paths:
        raise FileNotFoundError(f"no image files under {path!r}")
    return _file_dataset(paths, parse)


def read_text(path, **kw) -> Dataset:
    def parse(f: str) -> Block:
        with open(f) as fh:
            lines = [ln.rstrip("\n") for ln in fh]
        return {"text": np.asarray(lines, dtype=object)}

    return _file_dataset(_paths(path, ""), parse)


def read_binary_files(path, **kw) -> Dataset:
    def parse(f: str) -> Block:
        with open(f, "rb") as fh:
            data = fh.read()
        return {"bytes": np.asarray([data], dtype=object),
                "path": np.asarray([f], dtype=object)}

    return _file_dataset(_paths(path, ""), parse)
