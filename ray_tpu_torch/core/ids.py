"""Binary IDs for tasks, objects, actors, nodes, placement groups.

Role analog: reference ``src/ray/common/id.h`` (28-byte binary IDs). We use
16 random bytes — uniqueness within a cluster lifetime is all the runtime
needs, and shorter ids keep message payloads small.
"""

from __future__ import annotations

import os
import threading

_ID_LEN = 16

_local = threading.local()

#: per-thread buffered entropy: os.urandom is a getrandom(2) syscall, and
#: on the containers this runs in it profiles at 20-80 µs — two calls per
#: submitted task made it one of the largest driver-CPU line items (r14).
#: A 4 KiB refill amortizes the syscall over 256 ids; thread-local state
#: needs no lock. fork safety: workers are separate executables (never
#: os.fork of the driver mid-run), and the zygote fork-server itself
#: never generates ids, so no child can inherit a partially-used pool.
_POOL_LEN = _ID_LEN * 256


def _rand_bytes() -> bytes:
    buf = getattr(_local, "pool", None)
    off = getattr(_local, "pool_off", 0)
    if buf is None or off >= _POOL_LEN:
        buf = _local.pool = os.urandom(_POOL_LEN)
        off = 0
    _local.pool_off = off + _ID_LEN
    return buf[off:off + _ID_LEN]


class BaseID:
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if not isinstance(id_bytes, bytes) or len(id_bytes) != _ID_LEN:
            raise ValueError(f"expected {_ID_LEN} raw bytes, got {id_bytes!r}")
        self._bytes = id_bytes
        self._hash = None

    @classmethod
    def from_random(cls):
        return cls(_rand_bytes())

    @classmethod
    def from_hex(cls, h: str):
        return cls(bytes.fromhex(h))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * _ID_LEN)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * _ID_LEN

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        # cached: ids key hot dicts (directory, wait sets) and the tuple
        # hash showed up as 3s of a 2000-task profile
        h = self._hash
        if h is None:
            h = self._hash = hash((type(self).__name__, self._bytes))
        return h

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class ObjectID(BaseID):
    pass


class TaskID(BaseID):
    pass


class ActorID(BaseID):
    pass


class NodeID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class JobID(BaseID):
    pass
