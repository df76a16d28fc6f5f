"""Per-node host utilization snapshot (reference dashboard ``reporter``
module role: ``dashboard/modules/reporter/reporter_agent.py`` samples
cpu/mem per node via psutil and ships it to the dashboard).

Here the snapshot rides the existing node heartbeat — no extra agent
process, no extra RPC: the GCS node table carries the latest sample and
``ray_tpu_torch.nodes()`` / the dashboard nodes view expose it.
"""

from __future__ import annotations

from typing import Any, Dict


def host_stats() -> Dict[str, Any]:
    """Cheap (non-blocking) utilization sample for this host."""
    try:
        import psutil
    except Exception:  # pragma: no cover - psutil is in the image
        return {}
    try:
        vm = psutil.virtual_memory()
        return {
            # interval=None: delta since the previous call — free, and
            # the heartbeat cadence gives it a natural window
            "cpu_percent": psutil.cpu_percent(interval=None),
            "mem_used": int(vm.used),
            "mem_total": int(vm.total),
            "mem_percent": vm.percent,
            "load_1m": psutil.getloadavg()[0],
            "num_cpus": psutil.cpu_count(),
        }
    except Exception:  # pragma: no cover - platform quirks
        return {}
