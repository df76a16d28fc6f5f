"""GC-safe reference bookkeeping helpers shared by driver and worker.

``ObjectRef.__del__`` can fire at ANY allocation point via cycle
collection — including on a thread that already holds the process's ref
lock or a transport send lock — so the __del__ hook must take no locks and
do no IO. Both runtimes follow the same shape (advisor r3):

- the hook only appends the dropped oid to a plain deque
  (``deque.append`` is atomic, lock-free);
- normal code paths call :meth:`DeferredDrops.drain`, which applies the
  queued drops under the owner's lock and then flushes casts;
- 0<->1 pin transitions are recorded IN ORDER under the owner's lock into
  an :class:`OrderedCastFlusher`, and shipped outside it (network/pipe IO
  under the ref lock widened the deadlock window).

Role analog: reference ``ReferenceCounter`` (``reference_count.h:61``)
does this with re-entrancy-safe C++ locks; Python finalizers need the
queue-and-drain shape instead.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable


class OrderedCastFlusher:
    """Ship queued items with a single active flusher, preserving order.

    ``append`` must be called under the owner's ref lock so the queue order
    matches transition order. ``flush`` is called OUTSIDE that lock: the
    try-lock makes one thread the flusher; a loser's freshly-appended items
    are picked up by the winner's outer re-check loop (after the winner
    releases, it re-checks the queue; a loser that failed the try-lock
    appended strictly before the winner's release), so nothing strands.
    """

    def __init__(self, send: Callable, batch: bool = False):
        self._q: deque = deque()
        self._flush_lock = threading.Lock()
        # batch=False: ``send`` is called once per item.
        # batch=True:  ``send`` receives the LIST of items drained in one
        # pass — the worker ships refpin transitions as a single
        # ``refpins`` cast instead of one pipe message per transition
        # (r13 control-message coalescing; order inside the list is the
        # transition order).
        self._send = send  # exceptions swallowed
        self._batch = batch

    def append(self, item) -> None:
        self._q.append(item)

    def clear(self) -> None:
        self._q.clear()

    def flush(self) -> None:
        while self._q:
            if not self._flush_lock.acquire(blocking=False):
                return
            try:
                if self._batch:
                    items = []
                    while True:
                        try:
                            items.append(self._q.popleft())
                        except IndexError:
                            break
                    if items:
                        try:
                            self._send(items)
                        except Exception:
                            pass
                    continue
                while True:
                    try:
                        item = self._q.popleft()
                    except IndexError:
                        break
                    try:
                        self._send(item)
                    except Exception:
                        pass
            finally:
                self._flush_lock.release()


class DeferredDrops:
    """Drain-queue for ref drops queued by ``ObjectRef.__del__``.

    ``append`` (the __del__ hook) is the bare deque append. ``drain``
    applies each queued oid via ``apply_locked`` under ``lock``, then calls
    ``after`` (typically the cast flusher) outside it.
    """

    def __init__(self, lock: threading.Lock, apply_locked: Callable,
                 after: Callable):
        self._q: deque = deque()
        self._lock = lock
        self._apply_locked = apply_locked
        self._after = after

    @property
    def append(self) -> Callable:
        return self._q.append

    def drain(self) -> None:
        while self._q:
            with self._lock:
                while True:
                    try:
                        b = self._q.popleft()
                    except IndexError:
                        break
                    self._apply_locked(b)
            self._after()
