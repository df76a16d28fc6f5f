"""Tensor channels (twin of ``ray_tpu/experimental/device_channel.py``).

Role analog: the reference's NCCL channels for DAG edges
(``python/ray/experimental/channel/torch_tensor_nccl_channel.py:29``)
typed by ``TorchTensorType``. Here:

- a value that is ONE torch tensor moves through the channel's ring slot
  RAW: its bytes land 64-byte aligned behind a small dtype / shape header,
  never pickled. A CUDA tensor is written with one device-to-host copy,
  straight into the slot (pageable memory: ~the PCIe rate at best), after
  a device-wide ``torch.cuda.synchronize``: the writer cannot know which
  stream produced the tensor, and the slot is published only once the
  copy is complete (``copy_`` into pageable host memory returns when its
  bytes have landed). The synchronize also waits for unrelated work queued
  on the card;
- the reader gets a CPU tensor that ALIASES the slot (``torch.frombuffer``
  over the mapping): no copy at all. Where it must live on a card, the
  consumer moves it there (one host-to-device copy: cross-process device
  memory is not shared through host shm);
- a :class:`TensorWithMeta` (a small picklable dict beside one tensor, the
  KV-block shipping shape) is read as a COPY: the consumer uses it after
  the reader's cursor has moved on;
- any other value (control values, sentinels) falls back to pickle.

Zero-copy safety: the ring's backpressure means a slot is only
overwritten ``nslots`` values later, so a reader that is done with a
bare tensor before it reads ``nslots - 1`` more values never sees it
clobbered.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, Optional

import torch

from ray_tpu_torch.experimental.channel import Channel

_KIND_PICKLE = 0
_KIND_TENSOR = 1
_KIND_META_TENSOR = 2
_PREFIX = struct.Struct("<BIH")  # (kind, header_size, body_pad)
_ALIGN = 64  # tensor bodies start 64-byte aligned in the mapped file


class TensorWithMeta:
    """Channel payload pairing a small picklable ``meta`` dict with ONE
    tensor whose bytes ride the ring slot raw (64-byte aligned, like the
    bare-tensor kind): meta carries request identity / geometry, the tensor
    the block batch, and neither side pickles the tensor body. The reader
    gets the tensor as a COPY (KV adoption scatters it on the decode
    engine's loop thread, possibly after this reader moved past ``nslots``
    more values)."""

    __slots__ = ("meta", "tensor")

    def __init__(self, meta: dict, tensor):
        self.meta = meta
        self.tensor = tensor


class DeviceTensorType:
    """Edge type hint: the value is a tensor to ship raw (reference
    ``TorchTensorType`` role)."""

    def __init__(self, device: Optional[str] = None):
        self.device = device  # None -> consumer's default device

    def __repr__(self):
        return f"DeviceTensorType(device={self.device!r})"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".", 1)[1]


def _dtype_of(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a torch dtype: {name!r}")
    return dtype


def _slot_view(mm, dtype: torch.dtype, shape, offset: int) -> torch.Tensor:
    """The tensor of ``dtype`` / ``shape`` whose bytes start at ``offset``
    of the mapping, aliasing it."""
    n = 1
    for d in shape:
        n *= int(d)
    if n == 0:  # frombuffer refuses an empty view
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.frombuffer(mm, dtype=dtype, count=n,
                            offset=offset).view(tuple(shape))


class DeviceChannel(Channel):
    """Channel whose payloads are torch tensors moved as raw bytes."""

    def _encode(self, value: Any):
        if isinstance(value, TensorWithMeta):
            t = torch.as_tensor(value.tensor).detach()
            header = pickle.dumps((value.meta, _dtype_name(t.dtype),
                                   tuple(t.shape)))
            return self._encode_parts(_KIND_META_TENSOR, header, t)
        if not isinstance(value, torch.Tensor):
            body = pickle.dumps(value)
            return self._encode_parts(_KIND_PICKLE, b"", body)
        t = value.detach()
        header = pickle.dumps((_dtype_name(t.dtype), tuple(t.shape)))
        return self._encode_parts(_KIND_TENSOR, header, t)

    def _encode_parts(self, kind: int, header: bytes, body):
        # pad so the body lands 64B-aligned in the mapped file whichever
        # slot it goes to (slot payload offsets are 64-aligned)
        pad = (-(_PREFIX.size + len(header))) % _ALIGN
        nbytes = (len(body) if isinstance(body, bytes)
                  else body.numel() * body.element_size())
        total = _PREFIX.size + len(header) + pad + nbytes

        def fill(mm, off):
            _PREFIX.pack_into(mm, off, kind, len(header), pad)
            o = off + _PREFIX.size
            mm[o:o + len(header)] = header
            o += len(header) + pad
            if isinstance(body, bytes):
                mm[o:o + nbytes] = body
            elif nbytes:
                # one copy into the slot, from the host or (a CUDA
                # tensor) from the card, whatever the strides; the
                # producer may have run on any stream
                if body.is_cuda:
                    torch.cuda.synchronize(body.device)
                dst = _slot_view(mm, body.dtype, body.shape, o)
                dst.copy_(body)
                del dst

        return total, fill

    def read(self, timeout: Optional[float] = None) -> Any:
        off, size = self._wait_slot(timeout)
        value = self._decode(off, size)
        self._advance()
        return value

    def _decode(self, off: int, size: int):
        kind, hsize, pad = _PREFIX.unpack_from(self._mm, off)
        o = off + _PREFIX.size
        header = bytes(self._mm[o:o + hsize])
        o += hsize + pad
        body_size = size - _PREFIX.size - hsize - pad
        if kind == _KIND_PICKLE:
            return pickle.loads(bytes(self._mm[o:o + body_size]))
        if kind == _KIND_META_TENSOR:
            meta, dtype, shape = pickle.loads(header)
            # copy out of the mapped slot: the consumer (KV adoption) uses
            # the tensor after this reader's cursor moves on
            return TensorWithMeta(
                meta, _slot_view(self._mm, _dtype_of(dtype), shape,
                                 o).clone())
        dtype, shape = pickle.loads(header)
        # zero-copy: the tensor aliases the slot (backpressure keeps the
        # writer off it for the next nslots - 1 values)
        return _slot_view(self._mm, _dtype_of(dtype), shape, o)

    def __reduce__(self):
        return (_attach_device_channel, (self.name,))


def _attach_device_channel(name: str) -> "DeviceChannel":
    return DeviceChannel(name, create=False)
