"""Shared transient-error retry helper (the conftest ``poll_until`` idiom,
available to library code; twin of ``ray_tpu/util/retry.py``).

Under load on a 2-vCPU box, cluster RPC calls show ~1 random transient
``ConnectionError``/``TimeoutError`` per full-suite run that always
succeeds on retry. Library polls that ride the
GCS (node views, death-subscription state reads) must absorb those instead
of surfacing them as spurious failures — the elastic-training membership
probe (``train/backend_executor.py``) was the call site that made this a
shared helper instead of one more inline ``try/except`` copy.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Tuple, Type, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")

#: the transient family the conftest ``poll_until`` retries: connection
#: drops, RPC timeouts, and the OSError umbrella (EPIPE/ECONNRESET land
#: there when a peer restarts mid-call)
TRANSIENT_ERRORS: Tuple[Type[BaseException], ...] = (
    ConnectionError, TimeoutError, OSError)


def retry_transient(fn: Callable[[], T], *, attempts: int = 5,
                    delay: float = 0.2,
                    transient: Tuple[Type[BaseException], ...] = None,
                    desc: str = "") -> T:
    """Call ``fn()`` retrying transient errors with a fixed short delay.

    The LAST attempt's exception propagates — this absorbs blips, it does
    not mask a genuinely dead peer. ``desc`` names the call in the debug
    log so a retried probe is attributable.
    """
    if transient is None:
        transient = TRANSIENT_ERRORS
    last: BaseException = None
    for attempt in range(max(int(attempts), 1)):
        try:
            return fn()
        except transient as e:  # noqa: PERF203 — retry loop by design
            last = e
            logger.debug("transient error in %s (attempt %d/%d): %r",
                         desc or getattr(fn, "__name__", "call"),
                         attempt + 1, attempts, e)
            time.sleep(delay)
    raise last
