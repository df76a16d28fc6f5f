"""SLO-gated admission control for the LLM serving tier (a copy of
``ray_tpu/serve/admission.py``).

Role analog: the reference has no admission layer (Serve sheds only via
``max_ongoing_requests`` backpressure); production LLM serving needs one
because decode is a shared resource — one over-admitted prompt inflates
EVERY in-flight stream's time-per-output-token. The controller projects
a new request's time-to-first-token from the engine's measured step
latency and the work already queued ahead of it; a request whose
projection breaches the declared SLO (or its own deadline) is SHED at
submission — a fast, honest 503 instead of a slow timeout — and the
decision is counted by reason.

The TTFT/TPOT reservoirs double as the latency-percentile surface the
replay load generator and the ``/metrics`` histograms report.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional


class RequestShedError(RuntimeError):
    """Raised at submission when projected latency breaches the SLO (the
    serving tier's 503). Carries ``reason`` for shed-rate accounting and
    a machine-readable ``error_type`` that survives ``TaskError``
    wrapping across process boundaries."""

    error_type = "shed"

    def __init__(self, msg: str, reason: str = "slo"):
        super().__init__(msg)
        self.reason = reason

    def __reduce__(self):  # keep .reason across process boundaries
        return (RequestShedError, (self.args[0], self.reason))


class DeadlineExceededError(TimeoutError):
    """A request's own ``deadline_s`` elapsed — in the admission queue,
    waiting for its first token, or mid-stream."""

    error_type = "deadline"


@dataclass
class SLOConfig:
    """Declared service-level objectives for one LLM deployment.

    ``None`` disables a gate. ``ttft_s``: shed when projected
    time-to-first-token exceeds this. ``tpot_s``: target time per output
    token; new work is shed while the engine's measured decode step is
    slower than this (admitting more would push every live stream
    further over). ``max_queue_s``: bound on projected admission-queue
    wait alone. ``headroom``: projection safety factor (>1 sheds
    earlier)."""

    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    max_queue_s: Optional[float] = None
    headroom: float = 1.0


def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(math.ceil(q * len(sorted_vals))) - 1)
    return sorted_vals[max(idx, 0)]


class AdmissionController:
    """Latency bookkeeping + shed decisions for one engine.

    Thread-safe: ``submit`` (caller threads) consults it while the decode
    loop feeds observations. All state is scalar EWMAs and bounded
    reservoirs — a decision is a handful of float ops, never a scan of
    per-request history.
    """

    def __init__(self, slo: Optional[SLOConfig] = None,
                 reservoir: int = 1024):
        self.slo = slo or SLOConfig()
        self._lock = threading.Lock()
        self._step_ewma: Optional[float] = None  # seconds per engine step
        self._ttft = deque(maxlen=reservoir)
        self._tpot = deque(maxlen=reservoir)
        self.sheds: Dict[str, int] = {}
        self.admitted = 0

    # -- observations (decode-loop thread) ---------------------------------

    def observe_step(self, dt_s: float) -> None:
        with self._lock:
            self._step_ewma = (dt_s if self._step_ewma is None
                               else 0.8 * self._step_ewma + 0.2 * dt_s)

    def observe_ttft(self, t_s: float) -> None:
        with self._lock:
            self._ttft.append(t_s)

    def observe_tpot(self, t_s: float) -> None:
        with self._lock:
            self._tpot.append(t_s)

    @property
    def step_s(self) -> float:
        """Current step-latency estimate (0 before the first step — an
        idle engine projects optimistically and lets measurement correct
        it; a cold engine must not shed its warm-up traffic)."""
        return self._step_ewma or 0.0

    # -- projection + decision (submit threads) ----------------------------

    def project_ttft(self, prompt_tokens: int, queued_requests: int,
                     queued_prompt_tokens: int, prefill_chunk: int,
                     free_slots: int) -> float:
        """Projected TTFT for a request joining NOW: the queue ahead must
        drain through the free slots, then its own prompt prefills in
        ``prefill_chunk``-token steps. Deliberately first-order — the SLO
        gate needs the right ORDER of magnitude fast, and headroom plus
        the EWMA absorb the modelling error."""
        step = self.step_s
        chunk = max(prefill_chunk, 1)
        own_steps = math.ceil(max(prompt_tokens, 1) / chunk)
        queue_steps = (math.ceil(queued_prompt_tokens / chunk)
                       + queued_requests) / max(free_slots, 1)
        return step * (own_steps + queue_steps) * self.slo.headroom

    def check_admit(self, prompt_tokens: int, queued_requests: int,
                    queued_prompt_tokens: int, prefill_chunk: int,
                    free_slots: int, active_slots: int,
                    deadline_s: Optional[float] = None) -> None:
        """Raise :class:`RequestShedError` when this request should not
        even join the queue; return silently to admit/queue it."""
        slo = self.slo
        projected = self.project_ttft(prompt_tokens, queued_requests,
                                      queued_prompt_tokens, prefill_chunk,
                                      free_slots)
        if slo.max_queue_s is not None:
            queue_wait = self.step_s * queued_requests * slo.headroom
            if queue_wait > slo.max_queue_s:
                self._shed("queue", f"projected queue wait "
                           f"{queue_wait:.3f}s > max_queue_s "
                           f"{slo.max_queue_s:.3f}s")
        if slo.ttft_s is not None and projected > slo.ttft_s:
            self._shed("ttft", f"projected TTFT {projected:.3f}s > "
                       f"ttft_s {slo.ttft_s:.3f}s")
        if (slo.tpot_s is not None and active_slots > 0
                and self.step_s > slo.tpot_s):
            self._shed("tpot", f"decode step {self.step_s:.3f}s already "
                       f"over tpot_s {slo.tpot_s:.3f}s")
        if deadline_s is not None and projected > deadline_s:
            self._shed("deadline", f"projected TTFT {projected:.3f}s > "
                       f"request deadline {deadline_s:.3f}s")
        with self._lock:
            self.admitted += 1

    def _shed(self, reason: str, msg: str):
        with self._lock:
            self.sheds[reason] = self.sheds.get(reason, 0) + 1
        raise RequestShedError(f"request shed ({reason}): {msg}",
                               reason=reason)

    # -- reporting ---------------------------------------------------------

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            ttft = sorted(self._ttft)
            tpot = sorted(self._tpot)
            sheds = dict(self.sheds)
            admitted = self.admitted
        return {
            "step_ewma_s": self.step_s,
            "ttft_p50_s": _percentile(ttft, 0.50),
            "ttft_p99_s": _percentile(ttft, 0.99),
            "tpot_p50_s": _percentile(tpot, 0.50),
            "tpot_p99_s": _percentile(tpot, 0.99),
            "admitted": admitted,
            "shed": sum(sheds.values()),
            "shed_by_reason": sheds,
        }
