"""Train-step telemetry: step time / tokens-per-s / MFU / compile events
/ device-memory gauges as first-class metrics (twin of
``ray_tpu/train/telemetry.py``, with the same metric names).

Everything lands in the process-local metrics registry
(:mod:`ray_tpu_torch.util.metrics`), which federates to the head
``/metrics`` endpoint like any other process's samples.

Wired in three places:
- ``ray_tpu_torch.train.report(...)`` (the user loop's once-per-step
  barrier) feeds :func:`on_report` — inter-report wall time becomes the
  step time, and well-known keys (``tokens_per_s``/``tokens``/``mfu``/
  ``loss``) are forwarded when present;
- the port's builds and captures before a first use record compile
  events: ``ops/_build.py`` (``nvcc`` of a kernel's source) and
  ``util/device_plane.py`` (a ``registered_graph`` capture);
- a train loop records its measured step time / tokens / FLOPs.

MFU is taken against the card's dense bf16 peak
(``accelerators/gpu.py`` ``peak_flops()``); on a card the table does not
know, or in a process that has not used a card, it is None. The memory
gauges keep the reference's ``rtpu_tpu_hbm_*`` names and read the card's
allocator (``torch.cuda.memory_allocated`` / ``mem_get_info``).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Dict, Optional


def _card_in_use() -> bool:
    """Whether this process has made its CUDA context (asking initialises
    nothing)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def device_memory() -> Optional[Dict[str, int]]:
    """``{"bytes_in_use", "bytes_limit"}`` of this process's card: the
    caching allocator's allocated bytes and the card's total memory; None
    where the process has used no card."""
    if not _card_in_use():
        return None
    import torch

    _, total = torch.cuda.mem_get_info()
    return {"bytes_in_use": int(torch.cuda.memory_allocated()),
            "bytes_limit": int(total)}


class StepTelemetry:
    """Records per-step training telemetry into the metrics registry.

    Thread-safe; metrics are created lazily on first record so importing
    this module costs nothing. ``snapshot()`` returns the last recorded
    values."""

    _HBM_SAMPLE_EVERY = 10  # mem_get_info() is a driver query

    def __init__(self, component: str = "train"):
        self.component = component
        self._lock = threading.Lock()
        self._m: Optional[Dict[str, Any]] = None
        self._last: Dict[str, Any] = {}
        self._steps = 0
        self._last_report_t: Optional[float] = None
        #: peak override (FLOP/s of this process's devices): lets MFU
        #: attribution run off the card (parity tests, CPU rehearsal)
        self.peak_flops: Optional[float] = None

    def _metrics(self) -> Dict[str, Any]:
        if self._m is None:
            from ray_tpu_torch.util import metric_defs as md

            self._m = {
                "step_time": md.get("rtpu_train_step_seconds"),
                "steps": md.get("rtpu_train_steps_total"),
                "tokens_per_s": md.get("rtpu_train_tokens_per_s"),
                "mfu": md.get("rtpu_train_mfu"),
                "loss": md.get("rtpu_train_loss"),
                "compiles": md.get("rtpu_train_compile_total"),
                "compile_time": md.get("rtpu_train_compile_seconds"),
                "hbm_used": md.get("rtpu_tpu_hbm_used_bytes"),
                "hbm_limit": md.get("rtpu_tpu_hbm_limit_bytes"),
            }
        return self._m

    # -- recording -------------------------------------------------------

    def record_step(self, step_time_s: float, *, tokens: Optional[float] = None,
                    flops: Optional[float] = None,
                    mfu: Optional[float] = None,
                    loss: Optional[float] = None, steps: int = 1,
                    program: Optional[str] = None) -> None:
        """Record ``steps`` optimizer steps that took ``step_time_s`` each.

        ``tokens``: tokens consumed per step (tokens/s is derived).
        ``mfu``: measured utilization; when absent but ``flops`` (FLOPs
        per step, this process's) is given and a card the peak table
        knows is in use (or ``peak_flops`` is set), it is computed against
        the card's dense bf16 peak.
        ``program``: a device-plane registry name — when given and
        ``flops`` is absent, per-step FLOPs come from the registered
        program's static cost analysis (cost-model-driven attribution;
        util/device_plane.py) instead of a hand-maintained formula."""
        try:
            if flops is None and program is not None:
                from ray_tpu_torch.util import device_plane

                flops = device_plane.program_flops_per_step(program)
            m = self._metrics()
            with self._lock:
                for _ in range(max(1, int(steps))):
                    m["step_time"].observe(step_time_s)
                m["steps"].inc(max(1, int(steps)))
                self._steps += max(1, int(steps))
                self._last["step_time_s"] = step_time_s
                if tokens is not None and step_time_s > 0:
                    tps = tokens / step_time_s
                    m["tokens_per_s"].set(tps)
                    self._last["tokens_per_s"] = round(tps, 1)
                if flops is not None and step_time_s > 0:
                    self._set_achieved_flops(flops / step_time_s, program)
                if mfu is None and flops is not None and step_time_s > 0:
                    mfu = self._mfu_from_flops(flops, step_time_s)
                if mfu is not None:
                    m["mfu"].set(float(mfu))
                    self._last["mfu"] = round(float(mfu), 4)
                if loss is not None:
                    m["loss"].set(float(loss))
                    self._last["loss"] = float(loss)
                sample_hbm = self._steps % self._HBM_SAMPLE_EVERY in (0, 1)
            if sample_hbm:
                self.sample_hbm()
            # trace plane: the step also lands as a span, so step
            # telemetry joins the driver's unified Perfetto timeline
            from ray_tpu_torch.util import tracing

            if tracing.tracing_enabled():
                end = time.time_ns()
                attrs: Dict[str, Any] = {"steps": max(1, int(steps))}
                if tokens is not None:
                    attrs["tokens"] = float(tokens)
                if mfu is not None:
                    attrs["mfu"] = float(mfu)
                tracing.record_span(
                    "train::step",
                    end - int(step_time_s * max(1, int(steps)) * 1e9),
                    end, attrs)
        except Exception:
            pass  # telemetry must never fail a train step

    def _mfu_from_flops(self, flops: float,
                        step_time_s: float) -> Optional[float]:
        try:
            peak = self.peak_flops
            if peak is None:
                if not _card_in_use():
                    return None
                from ray_tpu_torch.accelerators.gpu import peak_flops

                peak = peak_flops()
            return flops / (step_time_s * peak) if peak else None
        except Exception:
            return None

    def _set_achieved_flops(self, flops_per_s: float,
                            program: Optional[str]) -> None:
        try:
            from ray_tpu_torch.util import metric_defs as md

            md.get("rtpu_device_achieved_flops_per_s").set(
                flops_per_s,
                tags={"program": program or self.component})
            self._last["flops_per_s"] = round(flops_per_s, 1)
        except Exception:
            pass

    def record_compile(self, seconds: float) -> None:
        try:
            m = self._metrics()
            m["compiles"].inc()
            m["compile_time"].observe(seconds)
            with self._lock:
                self._last["compiles"] = (self._last.get("compiles", 0) + 1)
                self._last["last_compile_s"] = round(seconds, 3)
            from ray_tpu_torch.util import tracing

            if tracing.tracing_enabled():
                end = time.time_ns()
                tracing.record_span("train::compile",
                                    end - int(seconds * 1e9), end)
        except Exception:
            pass

    def sample_hbm(self) -> Optional[Dict[str, int]]:
        """Refresh the device-memory gauges from this process's card
        (no-op where it has used none). Returns the sample when
        available."""
        try:
            usage = device_memory()
            if usage is None:
                return None
            m = self._metrics()
            m["hbm_used"].set(usage["bytes_in_use"])
            m["hbm_limit"].set(usage["bytes_limit"])
            with self._lock:
                self._last["hbm"] = dict(usage)
            return usage
        except Exception:
            return None

    def on_report(self, metrics: Dict[str, Any]) -> None:
        """Hook for ``ray_tpu_torch.train.report``: each report is one user-loop
        step; inter-report wall time is the step time. Known metric keys
        are forwarded; everything else stays the user's business."""
        now = time.monotonic()
        with self._lock:
            last = self._last_report_t
            self._last_report_t = now
        if last is None:
            return  # first report: no interval yet
        kw: Dict[str, Any] = {}
        for key in ("tokens_per_s", "tokens", "mfu", "loss"):
            v = metrics.get(key)
            if isinstance(v, (int, float)):
                kw[key] = float(v)
        tps = kw.pop("tokens_per_s", None)
        dt = max(1e-9, now - last)
        if tps is not None and "tokens" not in kw:
            kw["tokens"] = tps * dt
        self.record_step(dt, **kw)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"steps": self._steps, **self._last}


_default = StepTelemetry()


def get_step_telemetry() -> StepTelemetry:
    return _default


def record_step(step_time_s: float, **kwargs) -> None:
    _default.record_step(step_time_s, **kwargs)


def record_compile(seconds: float) -> None:
    _default.record_compile(seconds)


def sample_hbm():
    return _default.sample_hbm()


def on_report(metrics: Dict[str, Any]) -> None:
    _default.on_report(metrics)


def snapshot() -> Dict[str, Any]:
    return _default.snapshot()
