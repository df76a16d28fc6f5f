"""DataIterator: batch iteration with prefetch + device batches (twin of
``ray_tpu/data/iterator.py``).

Role analog: ``python/ray/data/iterator.py`` + the prefetching batcher
(``_internal/block_batching/iter_batches.py``). The reference's
``iter_jax_batches`` becomes :meth:`DataIterator.iter_torch_batches`:
batches as torch tensors on the card (the ingest path of ``TorchTrainer``),
where each host batch is copied once into pinned memory and goes up on a
copy stream one batch ahead of the consumer, so the host-to-device copy of
batch i+1 overlaps the step on batch i. ``device="cpu"`` returns what the
reference's CPU-only ``iter_torch_batches`` returns.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np

from ray_tpu_torch.data.block import (
    Block,
    block_num_rows,
    block_slice,
    block_to_batch,
    concat_blocks,
)

#: pinned staging buffers a device iteration cycles through; a buffer is
#: reused only once the copy that read it has finished (its event)
PINNED_SLOTS = 3


def iter_batches_from_blocks(
    blocks: Iterator[Block],
    *,
    batch_size: int = 256,
    batch_format: str = "numpy",
    drop_last: bool = False,
    prefetch_batches: int = 1,
) -> Iterator[Any]:
    """Re-chunk a block stream into exact-size batches; prefetch on a thread."""

    def batcher() -> Iterator[Block]:
        carry: Optional[Block] = None
        for block in blocks:
            merged = concat_blocks([carry, block]) if carry else block
            n = block_num_rows(merged)
            i = 0
            while n - i >= batch_size:
                yield block_slice(merged, i, i + batch_size)
                i += batch_size
            carry = block_slice(merged, i, n) if i < n else None
        if carry and not drop_last and block_num_rows(carry):
            yield carry

    source = batcher()
    if prefetch_batches <= 0:
        for b in source:
            yield block_to_batch(b, batch_format)
        return

    q: "queue.Queue" = queue.Queue(maxsize=prefetch_batches)
    DONE, ERROR = object(), object()

    def producer():
        try:
            for b in source:
                q.put(b)
            q.put(DONE)
        except BaseException as e:  # noqa: BLE001
            q.put((ERROR, e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is DONE:
            return
        if isinstance(item, tuple) and item and item[0] is ERROR:
            raise item[1]
        yield block_to_batch(item, batch_format)


def _host_tensor(v: np.ndarray, dtype):
    """The reference's CPU batch column: ``torch.as_tensor`` of the
    contiguous array, cast to ``dtype`` (a torch or numpy dtype) if given."""
    import torch

    if dtype is not None and not isinstance(dtype, torch.dtype):
        v = v.astype(dtype)
    t = torch.as_tensor(np.ascontiguousarray(v))
    if isinstance(dtype, torch.dtype):
        t = t.to(dtype)
    return t


def _target_dtype(v: np.ndarray, dtype):
    """The torch dtype a column lands in on the card."""
    import torch

    if isinstance(dtype, torch.dtype):
        return dtype
    np_dtype = np.dtype(dtype) if dtype is not None else v.dtype
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def _staging_dtype(v: np.ndarray, target):
    """The torch dtype a column is staged and uploaded in: its own, so the
    copies move the source bytes and the cast runs on the card; the target
    where torch has no counterpart of the source dtype."""
    import torch

    try:
        return torch.from_numpy(np.empty(0, v.dtype)).dtype
    except TypeError:
        return target


def _upload(bufs: Dict[str, Any], stream, dev):
    """Issue the host-to-device copies of one staged batch on ``stream``;
    returns the device tensors and the event that marks their end."""
    import torch

    done = torch.cuda.Event()
    with torch.cuda.stream(stream):
        out = {k: b.to(dev, non_blocking=True) for k, b in bufs.items()}
        done.record(stream)
    return out, done


def _check_mesh(mesh, device) -> None:
    """``mesh=`` is accepted where each process owns one card: every axis
    that is not a data axis is 1 (the batch is this rank's whole shard, as
    ``streaming_split`` hands it), and a ``DeviceMesh`` is over the
    iteration's device type. Anything else needs sharded ingest."""
    from ray_tpu_torch.parallel.mesh import DATA_AXES, mesh_sizes

    sizes = mesh_sizes(mesh)
    sharded = {a: s for a, s in sizes.items()
               if a not in DATA_AXES and s > 1}
    mesh_type = getattr(mesh, "device_type", device.type)
    if sharded or mesh_type != device.type:
        raise NotImplementedError(
            f"iter_torch_batches(mesh=...) over {sizes} on {mesh_type!r}: "
            "batches sharded over cards within a process are not ported "
            "yet (ROADMAP.md queue 1 item 5); each process takes its own "
            "shard through streaming_split")


class _PinnedSlot:
    """One pinned staging buffer per column, and the event of the copy that
    last read it."""

    __slots__ = ("bufs", "event")

    def __init__(self):
        self.bufs: Dict[str, Any] = {}
        self.event = None


class DataIterator:
    """Per-consumer view of a Dataset (reference ``DataIterator``); with
    ``split_index``/``num_splits`` set it consumes a round-robin share of
    blocks (the ``streaming_split`` contract for per-worker ingest)."""

    def __init__(self, dataset, split_index: int = 0, num_splits: int = 1):
        self._dataset = dataset
        self._split = split_index
        self._num_splits = num_splits

    def _blocks(self) -> Iterator[Block]:
        import ray_tpu_torch

        for i, ref in enumerate(self._dataset.iter_block_refs()):
            if self._num_splits <= 1 or i % self._num_splits == self._split:
                yield ray_tpu_torch.get(ref)

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     prefetch_batches: int = 1) -> Iterator[Any]:
        return iter_batches_from_blocks(
            self._blocks(), batch_size=batch_size, batch_format=batch_format,
            drop_last=drop_last, prefetch_batches=prefetch_batches)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        from ray_tpu_torch.data.block import block_to_rows

        for b in self._blocks():
            yield from block_to_rows(b)

    def iter_torch_batches(
        self,
        *,
        batch_size: int = 256,
        dtypes: Optional[Dict[str, Any]] = None,
        device=None,
        drop_last: bool = False,
        prefetch_batches: int = 1,
        mesh=None,
    ) -> Iterator[Dict[str, Any]]:
        """Yield batches as dicts of torch tensors on ``device`` (default
        ``cuda``; raises without a card).

        ``dtypes`` maps a column to the torch (or numpy) dtype it arrives
        in. On the CPU each batch is the reference's ``iter_torch_batches``
        batch. On the card each host batch is copied once into a pinned
        buffer in its own dtype and uploaded with ``non_blocking=True`` on
        a copy stream, one batch ahead of the consumer; the stream current
        at ``next()`` waits on that copy's event, casts to the column's
        dtype there, and each upload is recorded on it, so a batch consumed
        on a side stream is not freed under it. A pinned buffer is reused
        only after the copy that read it has finished.
        """
        from ray_tpu_torch._device import resolve_device

        dev = resolve_device(device)
        if mesh is not None:
            _check_mesh(mesh, dev)
        host = self.iter_batches(batch_size=batch_size, batch_format="numpy",
                                 drop_last=drop_last,
                                 prefetch_batches=prefetch_batches)
        if dev.type == "cpu":
            return ({k: _host_tensor(v, (dtypes or {}).get(k))
                     for k, v in batch.items()} for batch in host)
        if dev.type != "cuda":
            raise ValueError(f"iter_torch_batches: device {dev} is neither "
                             "the CPU nor a CUDA card")
        return self._iter_cuda(host, dtypes or {}, dev)

    def _iter_cuda(self, host: Iterator[Block], dtypes: Dict[str, Any],
                   dev) -> Iterator[Dict[str, Any]]:
        import torch

        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.Stream(dev)
        slots = [_PinnedSlot() for _ in range(PINNED_SLOTS)]

        def stage(batch: Block, slot: _PinnedSlot):
            """The host copy into ``slot``'s pinned buffers, then the upload
            on the copy stream; returns the device tensors, the dtypes they
            are cast to on the card and the upload's event."""
            if slot.event is not None:
                slot.event.synchronize()      # its last upload has read it
            casts = {}
            for k, v in batch.items():
                casts[k] = _target_dtype(v, dtypes.get(k))
                dtype = _staging_dtype(v, casts[k])
                buf = slot.bufs.get(k)
                if (buf is None or buf.dtype != dtype
                        or tuple(buf.shape) != v.shape):
                    buf = torch.empty(v.shape, dtype=dtype, pin_memory=True)
                    slot.bufs[k] = buf
                try:
                    np.copyto(buf.numpy(), v, casting="unsafe")
                except TypeError:              # a dtype numpy has not
                    buf.copy_(torch.as_tensor(np.ascontiguousarray(v)))
            out, done = _upload({k: slot.bufs[k] for k in batch}, stream,
                                dev)
            slot.event = done
            return out, casts, done

        def hand_over(staged):
            """Make the consumer's current stream wait on the upload, keep
            the uploads alive for it and cast there."""
            out, casts, done = staged
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            batch = {}
            for k, t in out.items():
                t.record_stream(consumer)
                batch[k] = t if t.dtype == casts[k] else t.to(casts[k])
            return batch

        it = iter(host)
        try:
            first = next(it)
        except StopIteration:
            return
        pending = stage(first, slots[0])
        for i, batch in enumerate(it, start=1):
            ahead = stage(batch, slots[i % PINNED_SLOTS])
            yield hand_over(pending)
            pending = ahead
        yield hand_over(pending)

    def materialize(self):
        return self._dataset.materialize()

    def stats(self) -> str:
        return repr(self._dataset)
