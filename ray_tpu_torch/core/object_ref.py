"""ObjectRef — a future for a value in the object store.

Role analog: reference ``python/ray/includes/object_ref.pxi:36``.
"""

from __future__ import annotations

from ray_tpu_torch.core.ids import ObjectID

# Process-local reference hook (reference ReferenceCounter,
# ``src/ray/core_worker/reference_count.h:61`` role): every live ObjectRef
# instance counts as one local reference. The driver runtime / worker
# installs (on_add, on_del); processes that never handle refs (GCS) keep
# the no-op default. Distributed liveness: local 0<->1 transitions become
# node-level pins at the cluster directory.
_ref_hook = None


def set_ref_hook(on_add, on_del) -> None:
    global _ref_hook
    _ref_hook = (on_add, on_del)


def clear_ref_hook() -> None:
    global _ref_hook
    _ref_hook = None


# Serialization-time ref collection: while a collector list is active on
# this thread, every ObjectRef that gets pickled records its id. Task-arg
# encoding uses this to pin refs NESTED inside inline values (the
# reference's "borrowed references in serialized arguments").
import threading as _threading

_collect = _threading.local()


class collect_serialized_refs:
    def __enter__(self):
        self.prev = getattr(_collect, "refs", None)
        _collect.refs = []
        return _collect.refs

    def __exit__(self, *exc):
        _collect.refs = self.prev
        return False


class ObjectRef:
    __slots__ = ("id", "owner", "_task_id", "_counted")

    def __init__(self, object_id: ObjectID, owner: str = "", task_id=None):
        self.id = object_id
        self.owner = owner
        self._task_id = task_id
        self._counted = False
        hook = _ref_hook
        if hook is not None:
            try:
                hook[0](object_id.binary())
                self._counted = True
            except Exception:
                pass

    def __del__(self):
        if self._counted:
            hook = _ref_hook
            if hook is not None:
                try:
                    hook[1](self.id.binary())
                except Exception:
                    pass

    def binary(self) -> bytes:
        return self.id.binary()

    def hex(self) -> str:
        return self.id.hex()

    def task_id(self):
        return self._task_id

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"

    def __reduce__(self):
        refs = getattr(_collect, "refs", None)
        if refs is not None:
            refs.append(self.id.binary())
        return (ObjectRef, (self.id, self.owner, self._task_id))

    # ``await ref`` support inside async actors / drivers.
    def __await__(self):
        import asyncio

        loop = asyncio.get_event_loop()

        def _get():
            from ray_tpu_torch.core.runtime import get

            return get(self)

        return loop.run_in_executor(None, _get).__await__()


class ObjectRefGenerator:
    """Iterator over the yields of a ``num_returns="streaming"`` task.

    Role analog: reference ``ObjectRefGenerator`` (``_raylet.pyx:273``).
    Each ``__next__`` returns the next item's :class:`ObjectRef` as soon as
    the producer yields it — consumers overlap with the still-running
    producer. The task's declared return object is the END SENTINEL: it
    resolves to the total item count when the generator completes (or to
    the task's error).

    Item ids are derived deterministically from the task id
    (:func:`ray_tpu_torch.core.task_spec.streaming_return_id`).
    """

    def __init__(self, task_id: bytes, sentinel: "ObjectRef",
                 backpressured: bool = False,
                 owner: "Optional[bytes]" = None):
        self._task_id = task_id
        self._sentinel = sentinel
        self._index = 0
        self._count = None  # known once the sentinel resolves
        self._bp = backpressured
        # node that submitted the stream: a consumer on a THIRD node routes
        # its acks there (the owner holds the producer's forward route)
        self._owner = owner
        self._handed_off = False  # serialized to another consumer

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        while True:
            out = self._advance(timeout=None)
            if out is not None:
                return out

    def _advance(self, timeout):
        """One consumption attempt, the SHARED core of the blocking
        (``__next__``, timeout=None) and polling (``try_next``, timeout=0)
        paths: returns the next item's ref, ``None`` when not ready within
        ``timeout``, raises ``StopIteration`` at stream end."""
        from ray_tpu_torch.core.runtime import _get_runtime

        rt = _get_runtime()
        item = self.next_item_ref()
        if self._count is None:
            ready, _ = rt.wait([item, self._sentinel], num_returns=1,
                               timeout=timeout)
            if item in ready:
                self._index += 1
                self._ack(rt)
                return item
            if self._sentinel in ready:
                # completion (count) or task error
                self._count = rt.get([self._sentinel], timeout=0)[0]
            else:
                return None
        if self._index >= self._count:
            raise StopIteration
        # count known -> the item was definitely produced
        self._index += 1
        self._ack(rt)
        return item

    def _ack(self, rt) -> None:
        """Report consumption so a backpressured producer may continue.

        Skipped entirely for unthrottled streams (no per-item IPC on the
        hot path) and once the producer finished (nobody is waiting)."""
        if not self._bp or self._count is not None:
            return
        try:
            rt.stream_consumed(self._task_id, self._index,
                               owner=self._owner)
        except Exception:
            pass

    def next_item_ref(self) -> "ObjectRef":
        """The ref the NEXT ``__next__``/``try_next`` would return, without
        consuming it. Waitable: ``ray_tpu_torch.wait([g.next_item_ref(), ...])``
        wakes a scheduler the moment any stream has a ready item (the
        per-operator data executor's idle wait). Past the end it is the
        never-resolving ref after the last item — pair with
        :meth:`completed` when waiting."""
        from ray_tpu_torch.core import task_spec as ts
        from ray_tpu_torch.core.ids import ObjectID

        return ObjectRef(ObjectID(ts.streaming_return_id(self._task_id,
                                                         self._index)))

    def try_next(self):
        """Non-blocking :meth:`__next__`: the next item's ref if the
        producer has yielded it, ``None`` if not yet, ``StopIteration``
        raised when the stream is exhausted. Lets a scheduler poll many
        streams without parking on any one (reference
        ``streaming_executor_state`` polls op outqueues the same way)."""
        return self._advance(timeout=0)

    def close(self) -> None:
        """Abandon the stream: release any backpressured producer (it runs
        to completion; surplus items are dropped with the task)."""
        try:
            from ray_tpu_torch.core.runtime import _get_runtime

            _get_runtime().stream_consumed(self._task_id, 1 << 60,
                                           owner=self._owner)
        except Exception:
            pass

    def __del__(self):
        # release a parked producer ONLY when this was the sole consumer:
        # a serialized copy (handed to another task) owns consumption now
        if self._bp and self._count is None and not self._handed_off:
            self.close()

    def __len__(self):
        if self._count is None:
            raise TypeError("generator still running; length unknown")
        return self._count

    def completed(self) -> "ObjectRef":
        """The end-sentinel ref (resolves to the item count)."""
        return self._sentinel

    def __reduce__(self):
        self._handed_off = True
        return (ObjectRefGenerator,
                (self._task_id, self._sentinel, self._bp, self._owner))
