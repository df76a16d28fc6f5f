"""MemoryMonitor: host-RAM pressure detection + worker-killing policy.

Role analog: ``src/ray/common/memory_monitor.h:52`` plus the raylet's
retriable-first worker-killing policies (``worker_killing_policy*.h``). A
background thread samples /proc/meminfo; past the usage threshold it asks
the runtime to kill the most recently started retriable task's worker
(RetriableFIFO-lite: retriable first, newest first — the victim retries
from lineage, so work is delayed, not lost).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


def system_memory() -> dict:
    """{'total': bytes, 'available': bytes, 'used_fraction': float}."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            parts = line.split()
            if parts[0] in ("MemTotal:", "MemAvailable:"):
                info[parts[0][:-1]] = int(parts[1]) * 1024
    total = info.get("MemTotal", 1)
    avail = info.get("MemAvailable", total)
    return {
        "total": total,
        "available": avail,
        "used_fraction": 1.0 - avail / total,
    }


class MemoryMonitor:
    def __init__(
        self,
        usage_threshold: float = 0.95,
        poll_interval_s: float = 1.0,
        on_pressure: Optional[Callable[[dict], None]] = None,
    ):
        self.usage_threshold = usage_threshold
        self.poll_interval_s = poll_interval_s
        self.on_pressure = on_pressure
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.num_pressure_events = 0

    def check(self) -> bool:
        """One sample; fires the callback if over threshold."""
        mem = system_memory()
        if mem["used_fraction"] >= self.usage_threshold:
            self.num_pressure_events += 1
            if self.on_pressure is not None:
                self.on_pressure(mem)
            return True
        return False

    def start(self) -> "MemoryMonitor":
        def loop():
            while not self._stop.wait(self.poll_interval_s):
                try:
                    self.check()
                except Exception:
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="rtpu_memory_monitor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()


def kill_retriable_policy(runtime) -> Callable[[dict], None]:
    """Build the default pressure handler for a DriverRuntime: kill the
    newest busy pool worker whose task has retries left."""

    def handler(mem: dict) -> None:
        import logging

        # Select AND terminate under the runtime lock: dropping it between
        # the two would let the worker finish its retriable task and pick
        # up a non-retriable one before the SIGTERM lands.
        with runtime.lock:
            candidates = [
                ws for ws in runtime.workers.values()
                if ws.kind == "pool" and ws.status == "busy"
                and ws.current and ws.current.get("retries_left", 0) > 0
            ]
            # newest TASK first (retriable FIFO): losing the least work
            victim = max(
                candidates,
                key=lambda w: runtime._task_start_ts.get(
                    w.current["task_id"], 0.0),
                default=None)
            if victim is not None:
                try:
                    victim.proc.terminate()
                except Exception:
                    victim = None
        if victim is None:
            logging.getLogger(__name__).warning(
                "memory pressure (%.0f%% used) but no retriable task to "
                "kill", mem["used_fraction"] * 100)
            return
        logging.getLogger(__name__).warning(
            "memory pressure (%.0f%% used): killed retriable task on "
            "worker %s", mem["used_fraction"] * 100,
            victim.worker_id.hex()[:8])

    return handler
