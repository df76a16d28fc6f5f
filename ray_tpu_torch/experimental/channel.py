"""Mutable shared-memory ring channels (twin of
``ray_tpu/experimental/channel.py``): the data plane of compiled DAGs
(``dag/compiled_dag.py``) and of disaggregated serving's KV shipping
(``serve/kv_transfer.py``).

Role analog: the reference's mutable plasma objects backing accelerated
DAGs (``src/ray/core_worker/experimental_mutable_object_manager.h:37`` +
``python/ray/experimental/channel/shared_memory_channel.py``). A channel
is one fixed shm segment reused for every value — no per-call
allocation, no scheduler on the data path.

A bounded RING of ``slots`` seq-numbered slots, so ``slots - 1`` values
can be in flight at once. Layout::

    header   write_seq | nslots | slot_size | nreaders
    cursors  reader_cursor[_MAX_READERS]     (values consumed per reader)
    slots    nslots x (slot_seq | size | payload[slot_size])

Synchronization stays lock-free:

- ONE writer publishes value ``k`` (0-based) into slot ``k % nslots``:
  invalidate the slot's seq, write size+payload, publish ``seq = k + 1``.
- Readers register a shm cursor once (flock-serialized) and then wait for
  slot ``r % nslots`` to carry ``seq == r + 1``; consuming advances the
  cursor — a single aligned 8-byte store.
- Backpressure: the writer blocks (bounded) while
  ``write_seq - min(reader cursors) >= nslots`` — it can never lap an
  unconsumed value, which is also what makes the device channel's
  zero-copy reads safe.

Polling backs off from spin to short sleeps. Waits that actually back off
feed the ``rtpu_channel_{read,write}_wait_seconds`` histograms. Segments
are ``/dev/shm/rtpu-chan-<name>``; a name that starts with the runtime's
session id is swept by that runtime's shutdown.
"""

from __future__ import annotations

import mmap
import os
import struct
import time
from typing import Any, Optional

from ray_tpu_torch.core import serialization

_HDR = struct.Struct("<QQQQ")   # (write_seq, nslots, slot_size, nreaders)
_U64 = struct.Struct("<Q")
_SLOT_HDR = struct.Struct("<QQ")  # (slot_seq = 1-based value index, size)
_MAX_READERS = 8
_CURSORS_OFF = _HDR.size
# slots start 64-aligned and each slot's PAYLOAD starts 64 bytes past the
# slot header, with slot sizes rounded to 64 — so payload offsets are
# 64-aligned in the file for every slot (the device channel aligns tensor
# bodies absolutely, so a tensor read in place is 64-byte aligned)
_SLOTS_OFF = 128
_SLOT_PAYLOAD_OFF = 64
#: cursor sentinel a closing reader stores so it stops gating the writer
_DETACHED = (1 << 64) - 1
_SHM_DIR = "/dev/shm"

# lazily-bound wait histograms (defs in util/metric_defs); never allowed
# to fail a channel op, observed only when a wait actually backed off
_m = {"read": None, "write": None}


def _observe_wait(kind: str, seconds: float) -> None:
    try:
        m = _m[kind]
        if m is None:
            from ray_tpu_torch.util import metric_defs

            m = _m[kind] = metric_defs.get(
                f"rtpu_channel_{kind}_wait_seconds")
        m.observe(seconds)
    except Exception:
        pass


class ChannelFullError(RuntimeError):
    pass


class ChannelTimeoutError(TimeoutError):
    pass


class Channel:
    """Single-writer multi-reader mutable shm ring channel."""

    def __init__(self, name: str, capacity: int = 1 << 20,
                 create: bool = False, slots: int = 2):
        self.name = name
        self.path = os.path.join(_SHM_DIR, f"rtpu-chan-{name}")
        if create:
            if slots < 1:
                raise ValueError("channel needs at least one slot")
            self.nslots = int(slots)
            self.slot_size = (int(capacity) + 63) // 64 * 64
            total = _SLOTS_OFF + self.nslots * (_SLOT_PAYLOAD_OFF
                                                + self.slot_size)
            fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, total)
                self._mm = mmap.mmap(fd, total)
            finally:
                os.close(fd)
            _HDR.pack_into(self._mm, 0, 0, self.nslots, self.slot_size, 0)
        else:
            # attach: wait briefly for the creator
            deadline = time.monotonic() + 10.0
            while True:
                try:
                    fd = os.open(self.path, os.O_RDWR)
                    break
                except FileNotFoundError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.001)
            try:
                size = os.fstat(fd).st_size
                self._mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
            _, self.nslots, self.slot_size, _ = _HDR.unpack_from(self._mm, 0)
        self.capacity = self.slot_size  # back-compat alias (per-value cap)
        self._stride = _SLOT_PAYLOAD_OFF + self.slot_size
        # values consumed by THIS handle; the shm cursor mirrors it once
        # the handle registers as a reader (lazily, on first read)
        self._cursor = 0
        self._reader_idx: Optional[int] = None

    # -- reader registration ---------------------------------------------

    def _register_reader(self) -> None:
        """Claim a shm cursor slot (flock-serialized; registration is a
        once-per-reader cold path). New readers start at cursor 0 and see
        the full un-lapped backlog — backpressure guarantees nothing they
        are entitled to was overwritten."""
        import fcntl

        fd = os.open(self.path, os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            (n,) = _U64.unpack_from(self._mm, 24)
            if n >= _MAX_READERS:
                raise RuntimeError(
                    f"channel {self.name}: more than {_MAX_READERS} readers")
            _U64.pack_into(self._mm, _CURSORS_OFF + _U64.size * n,
                           self._cursor)
            _U64.pack_into(self._mm, 24, n + 1)
            self._reader_idx = n
        finally:
            os.close(fd)  # close releases the flock

    def _store_cursor(self) -> None:
        _U64.pack_into(self._mm, _CURSORS_OFF + _U64.size * self._reader_idx,
                       self._cursor)

    # -- writer -----------------------------------------------------------

    def _min_consumed(self) -> int:
        (n,) = _U64.unpack_from(self._mm, 24)
        if n == 0:
            return 0  # no reader yet: the ring itself is the only bound
        low = _DETACHED
        for i in range(n):
            (c,) = _U64.unpack_from(self._mm, _CURSORS_OFF + _U64.size * i)
            if c < low:
                low = c
        if low == _DETACHED:   # every reader detached: nothing gates us
            (seq,) = _U64.unpack_from(self._mm, 0)
            return seq
        return low

    def _wait_writable(self, seq: int, timeout: Optional[float]) -> None:
        if seq - self._min_consumed() < self.nslots:
            return
        t0 = time.monotonic()
        deadline = None if timeout is None else t0 + timeout
        while True:
            time.sleep(0.0002)
            if seq - self._min_consumed() < self.nslots:
                _observe_wait("write", time.monotonic() - t0)
                return
            if deadline is not None and time.monotonic() > deadline:
                _observe_wait("write", time.monotonic() - t0)
                raise ChannelFullError(
                    f"channel {self.name} ring full ({self.nslots} slots, "
                    f"slowest reader at {self._min_consumed()}) for "
                    f"{timeout}s")

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        """Publish the next value. Blocks while the ring is full (bounded
        by ``timeout``; ``None`` waits forever) — the writer never laps an
        unconsumed slot."""
        size, fill = self._encode(value)
        if size > self.slot_size:
            raise ChannelFullError(
                f"payload {size}B exceeds channel slot capacity "
                f"{self.slot_size}B")
        (seq,) = _U64.unpack_from(self._mm, 0)
        self._wait_writable(seq, timeout)
        off = _SLOTS_OFF + (seq % self.nslots) * self._stride
        # publish order matters: invalidate the slot FIRST (readers back
        # off), then size+payload, then the new slot seq
        _SLOT_HDR.pack_into(self._mm, off, 0, size)
        fill(self._mm, off + _SLOT_PAYLOAD_OFF)
        _U64.pack_into(self._mm, off, seq + 1)
        _U64.pack_into(self._mm, 0, seq + 1)

    def _encode(self, value: Any):
        """(size, fill(mm, off)) for the generic pickle payload; the
        device channel overrides this with the raw-tensor layout."""
        data, buffers = serialization.serialize(value)
        size = serialization.serialized_size(data, buffers)

        def fill(mm, off):
            serialization.write_into(
                memoryview(mm)[off:off + size], data, buffers)

        return size, fill

    # -- reader -----------------------------------------------------------

    def _wait_slot(self, timeout: Optional[float]):
        """Block until the next unconsumed value is published; returns
        (payload_offset, size). Registers this handle's shm cursor on
        first use."""
        if self._reader_idx is None:
            self._register_reader()
        expect = self._cursor + 1
        off = _SLOTS_OFF + (self._cursor % self.nslots) * self._stride
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = 0
        t0 = 0.0
        while True:
            sseq, size = _SLOT_HDR.unpack_from(self._mm, off)
            if sseq == expect:
                if t0:
                    _observe_wait("read", time.monotonic() - t0)
                return off + _SLOT_PAYLOAD_OFF, size
            spins += 1
            if spins < 1000:
                continue
            if not t0:
                t0 = time.monotonic()
            if deadline is not None and time.monotonic() > deadline:
                _observe_wait("read", time.monotonic() - t0)
                raise ChannelTimeoutError(
                    f"channel {self.name} read timed out after {timeout}s")
            time.sleep(0.0002)

    def _advance(self) -> None:
        self._cursor += 1
        self._store_cursor()

    def read(self, timeout: Optional[float] = None) -> Any:
        """Block until a value newer than the last read is available."""
        off, size = self._wait_slot(timeout)
        # copy BEFORE deserializing: backpressure means the writer cannot
        # overwrite an unconsumed slot, so no seqlock re-validation is
        # needed — the copy just keeps the deserializer off live shm
        payload = bytes(self._mm[off:off + size])
        value = serialization.read_from(memoryview(payload))
        self._advance()
        return value

    def poll(self) -> bool:
        off = _SLOTS_OFF + (self._cursor % self.nslots) * self._stride
        (sseq,) = _U64.unpack_from(self._mm, off)
        return sseq == self._cursor + 1

    def close(self) -> None:
        if self._reader_idx is not None:
            try:
                # stop gating the writer: a closed reader's cursor parks
                # at the detached sentinel
                _U64.pack_into(self._mm,
                               _CURSORS_OFF + _U64.size * self._reader_idx,
                               _DETACHED)
            except (ValueError, IndexError):
                pass
            self._reader_idx = None
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass

    def unlink(self) -> None:
        self.close()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    def __reduce__(self):
        # channels travel to actors by name; they attach on arrival
        return (_attach_channel, (self.name,))


def _attach_channel(name: str) -> "Channel":
    return Channel(name, create=False)
