"""@serve.batch — dynamic request batching.

Role analog: ``python/ray/serve/batching.py``. Concurrent calls to the
decorated async method are queued; a flush runs the underlying function on
the whole batch when ``max_batch_size`` accumulate or ``batch_wait_timeout_s``
elapses. On a TPU replica this is what keeps the MXU fed: many small
requests become one batched jitted call.
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, List, Optional


class _BatchQueue:
    def __init__(self, fn, max_batch_size: int, timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_s
        self.pending: List = []   # list of (arg, future)
        self._flush_task: Optional[asyncio.TimerHandle] = None
        self._lock = asyncio.Lock()

    async def submit(self, arg) -> Any:
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        async with self._lock:
            self.pending.append((arg, fut))
            if len(self.pending) >= self.max_batch_size:
                await self._flush()
            elif len(self.pending) == 1:
                loop.create_task(self._timer_flush())
        return await fut

    async def _timer_flush(self):
        await asyncio.sleep(self.timeout_s)
        async with self._lock:
            await self._flush()

    async def _flush(self):
        if not self.pending:
            return
        batch, self.pending = self.pending, []
        args = [a for a, _ in batch]
        futs = [f for _, f in batch]
        try:
            results = self.fn(args)
            if asyncio.iscoroutine(results):
                results = await results
            if len(results) != len(args):
                raise ValueError(
                    f"batched fn returned {len(results)} results for "
                    f"{len(args)} inputs")
            for f, r in zip(futs, results):
                if not f.done():
                    f.set_result(r)
        except BaseException as e:  # noqa: BLE001
            for f in futs:
                if not f.done():
                    f.set_exception(e)


def batch(fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorate ``async def method(self, batch_of_args)`` (or a free async
    fn taking a list) so callers invoke it with single items."""

    def wrap(f):
        queues = {}  # per-instance (or module) queue

        @functools.wraps(f)
        async def wrapper(*args):
            if len(args) == 2:           # bound method: (self, item)
                owner, item = args
                key = id(owner)
                bound = functools.partial(f, owner)
            else:                        # free function: (item,)
                (item,) = args
                key = id(f)
                bound = f
            q = queues.get(key)
            if q is None:
                q = queues[key] = _BatchQueue(bound, max_batch_size,
                                              batch_wait_timeout_s)
            return await q.submit(item)

        wrapper._is_serve_batch = True
        return wrapper

    if fn is None:
        return wrap
    return wrap(fn)
