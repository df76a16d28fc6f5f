"""Object serialization: pickle protocol 5 with out-of-band buffers.

Role analog: reference ``python/ray/_private/serialization.py``
(``SerializationContext``, msgpack + cloudpickle + zero-copy numpy readers).

Layout written into an object-store buffer::

    u64 magic | u64 n_buffers | u64 pickle_len | [u64 buf_len]*n  |
    pickle bytes | padding-to-64 | buf0 | padding-to-64 | buf1 | ...

Large contiguous payloads (numpy arrays, bytes) travel out-of-band so that
``get`` can reconstruct them as zero-copy views over shared memory.

torch tensors, at any depth of the value (a params dict, a ``KVExport``),
travel the same way: their storage bytes go out of band as raw bytes with a
dtype and shape tag (numpy has no bfloat16, so a tensor never becomes a numpy
array of its own dtype), and ``get`` rebuilds a CPU tensor that views the
buffer without a copy. A CUDA tensor is copied to the host on ``put`` and
comes back on the CPU, as a device array does in the reference: no process
ever touches the card because it read an object. Tensors that are not plain
strided dense ones (sparse, quantized, meta) keep torch's own pickling.
"""

from __future__ import annotations

import pickle
import struct
import sys
from typing import Any, List, Optional, Tuple

import cloudpickle

MAGIC = 0x52415954505500  # "RAYTPU"
_ALIGN = 64
_HDR = struct.Struct("<QQQ")
#: buffers at least this large travel out of band
_OOB_MIN = 512


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _tensor_bytes(t) -> pickle.PickleBuffer:
    """A dense tensor's bytes, on the host and contiguous, as a 1-D uint8
    buffer (no copy when it already is both)."""
    import torch

    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    flat = t.contiguous().reshape(-1)
    if flat.dtype != torch.uint8:
        flat = flat.view(torch.uint8)
    return pickle.PickleBuffer(flat.numpy())


def _rebuild_tensor(buf, dtype: str, shape: tuple, requires_grad: bool,
                    parameter: bool):
    """The inverse of ``_reduce_tensor``: a CPU tensor over ``buf``'s bytes,
    no copy. A store buffer is read-only, as a numpy array from ``get``
    is: write to a ``.clone()``."""
    import warnings

    import numpy as np
    import torch

    raw = np.frombuffer(buf, dtype=np.uint8)
    with warnings.catch_warnings():
        # torch warns once that the array is not writable
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(raw)
    t = t.view(getattr(torch, dtype)).reshape(shape)
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    if requires_grad:
        t.requires_grad_(True)
    return t


def _reduce_tensor(torch, obj):
    """``reducer_override`` for torch tensors: dense strided tensors (and
    parameters) travel as raw bytes + tag; anything else is left to torch."""
    if (type(obj) not in (torch.Tensor, torch.nn.Parameter)
            or obj.layout != torch.strided or obj.is_quantized
            or obj.is_meta):
        return NotImplemented
    return (_rebuild_tensor,
            (_tensor_bytes(obj), str(obj.dtype).replace("torch.", ""),
             tuple(obj.shape), bool(obj.requires_grad),
             type(obj) is torch.nn.Parameter))


class _TensorPickler(cloudpickle.Pickler):
    """cloudpickle with the tensor reducer in front of its own."""

    def reducer_override(self, obj):
        out = _reduce_tensor(sys.modules["torch"], obj)
        if out is NotImplemented:
            return super().reducer_override(obj)
        return out


class _PlainTensorPickler(pickle.Pickler):
    """The plain-pickle fallback, with the same tensor reducer."""

    def reducer_override(self, obj):
        return _reduce_tensor(sys.modules["torch"], obj)


def _dumps(pickler_cls, value: Any, cb) -> bytes:
    import io

    f = io.BytesIO()
    pickler_cls(f, protocol=5, buffer_callback=cb).dump(value)
    return f.getvalue()


def serialize(value: Any) -> Tuple[bytes, List[pickle.PickleBuffer]]:
    """Returns (pickle_bytes, out_of_band_buffers)."""
    buffers: List[pickle.PickleBuffer] = []

    def cb(buf: pickle.PickleBuffer):
        # Only send large buffers out-of-band; small ones inline pickle.
        if buf.raw().nbytes >= _OOB_MIN:
            buffers.append(buf)
            return False  # out-of-band
        return True  # serialize in-band

    # cloudpickle, not plain pickle: plain pickle serializes __main__-defined
    # functions/classes BY REFERENCE (succeeds locally, AttributeError in the
    # worker whose __main__ is the worker entrypoint). cloudpickle serializes
    # those by value and delegates everything else to the C pickler, so the
    # data path cost is unchanged (reference: Ray's SerializationContext is
    # cloudpickle-based too, python/ray/_private/serialization.py:111).
    # Where torch was never imported no value can hold a tensor, and the
    # stock picklers run.
    with_torch = "torch" in sys.modules
    try:
        if with_torch:
            data = _dumps(_TensorPickler, value, cb)
        else:
            data = cloudpickle.dumps(value, protocol=5, buffer_callback=cb)
    except Exception:
        buffers.clear()
        if with_torch:
            data = _dumps(_PlainTensorPickler, value, cb)
        else:
            data = pickle.dumps(value, protocol=5, buffer_callback=cb)
    return data, buffers


def serialized_size(data: bytes, buffers: List[pickle.PickleBuffer]) -> int:
    n = len(buffers)
    off = _HDR.size + 8 * n
    off = _pad(off + len(data))
    for b in buffers:
        off = _pad(off + b.raw().nbytes)
    return off


#: lazy state for the native multi-threaded copy path (r14 data plane):
#: slices at or above RTPU_STORE_PARALLEL_COPY_BYTES go through
#: _native.parallel_copy (N slicing threads, GIL released), targeting the
#: measured single-thread memcpy ceiling in aggregate. 0 threshold or a
#: missing .so disables it; the fallback is the plain slice assignment.
_pcopy_min: Optional[int] = None
_pcopy_threads = 0
_pcopy_fn = None
_pcopy_metrics = None


def _parallel_copy_setup():
    global _pcopy_min, _pcopy_threads, _pcopy_fn
    from ray_tpu_torch import config

    _pcopy_min = int(config.get("store_parallel_copy_bytes"))
    _pcopy_threads = int(config.get("store_copy_threads"))
    if _pcopy_min > 0:
        try:
            from ray_tpu_torch import _native

            if _native.pipe_engine_available():
                _pcopy_fn = _native.parallel_copy
            else:
                _pcopy_min = 0
        except Exception:
            _pcopy_min = 0
    return _pcopy_min


def _blit(mv: memoryview, off: int, raw) -> None:
    """One serialized-buffer copy into the store segment; large slices
    ride the native multi-threaded memcpy."""
    nb = raw.nbytes
    src = raw.cast("B") if raw.format != "B" or raw.ndim != 1 else raw
    limit = _pcopy_min if _pcopy_min is not None else _parallel_copy_setup()
    if limit and nb >= limit:
        global _pcopy_metrics
        try:
            import time as _time

            t0 = _time.perf_counter()
            _pcopy_fn(mv[off:off + nb], src, _pcopy_threads)
            dt = _time.perf_counter() - t0
            if _pcopy_metrics is None:
                from ray_tpu_torch.util import metric_defs as _md

                _pcopy_metrics = (
                    _md.get(
                        "rtpu_object_store_parallel_copy_bytes_total"),
                    _md.get("rtpu_object_store_parallel_copy_seconds"))
            _pcopy_metrics[0].inc(nb)
            _pcopy_metrics[1].observe(dt)
            return
        except Exception:
            pass  # any native hiccup falls back to the plain copy
    mv[off:off + nb] = src


def write_into(mv: memoryview, data: bytes, buffers: List[pickle.PickleBuffer]) -> int:
    """Writes the serialized object into ``mv``; returns bytes written."""
    n = len(buffers)
    _HDR.pack_into(mv, 0, MAGIC, n, len(data))
    off = _HDR.size
    for b in buffers:
        struct.pack_into("<Q", mv, off, b.raw().nbytes)
        off += 8
    mv[off : off + len(data)] = data
    off = _pad(off + len(data))
    for b in buffers:
        raw = b.raw()
        nb = raw.nbytes
        _blit(mv, off, raw)
        off = _pad(off + nb)
    return off


def iter_serialized_blocks(data: bytes, buffers: List[pickle.PickleBuffer],
                           block_size: int):
    """Yield the exact ``write_into`` layout as successive bytes chunks of
    ``block_size`` (last may be short) WITHOUT materializing the whole
    object — the spill-write path streams these through the codec, so a
    multi-GB spill's peak extra heap is one block, not the object
    (the restore side has honored that bound all along)."""
    n = len(buffers)
    head = bytearray(_HDR.size + 8 * n)
    _HDR.pack_into(head, 0, MAGIC, n, len(data))
    off = _HDR.size
    for b in buffers:
        struct.pack_into("<Q", head, off, b.raw().nbytes)
        off += 8
    pos = len(head) + len(data)

    def pieces():
        yield memoryview(head)
        yield memoryview(data)
        p = pos
        yield memoryview(b"\x00" * (_pad(p) - p))
        p = _pad(p)
        for b in buffers:
            raw = b.raw()
            yield (raw.cast("B")
                   if raw.format != "B" or raw.ndim != 1 else raw)
            p += raw.nbytes
            yield memoryview(b"\x00" * (_pad(p) - p))
            p = _pad(p)

    block = bytearray()
    for mv in pieces():
        o = 0
        ln = len(mv)
        while o < ln:
            take = min(block_size - len(block), ln - o)
            block += mv[o:o + take]
            o += take
            if len(block) == block_size:
                yield bytes(block)
                block.clear()
    if block:
        yield bytes(block)


def read_from(mv: memoryview) -> Any:
    """Reconstructs an object from a store buffer.

    Out-of-band buffers are zero-copy views into ``mv`` — the caller must
    keep the backing segment alive as long as the value (the object store
    client pins segments per ref).
    """
    magic, n, plen = _HDR.unpack_from(mv, 0)
    if magic != MAGIC:
        raise ValueError("corrupt object buffer (bad magic)")
    off = _HDR.size
    sizes = []
    for _ in range(n):
        (sz,) = struct.unpack_from("<Q", mv, off)
        sizes.append(sz)
        off += 8
    data = bytes(mv[off : off + plen])
    off = _pad(off + plen)
    bufs = []
    for sz in sizes:
        bufs.append(mv[off : off + sz])
        off = _pad(off + sz)
    return pickle.loads(data, buffers=bufs)


def dumps_oob(value: Any) -> bytes:
    """One-shot serialize to a contiguous bytes blob (for pipe transport)."""
    data, buffers = serialize(value)
    size = serialized_size(data, buffers)
    out = bytearray(size)
    write_into(memoryview(out), data, buffers)
    return bytes(out)


def loads_oob(blob: bytes) -> Any:
    return read_from(memoryview(blob))
