"""Usage stats: opt-out local usage reporting.

Role analog: ``python/ray/_private/usage/usage_lib.py`` — Ray collects
cluster metadata (version, node count, libraries imported) and reports it
unless the user opts out. This build runs in zero-egress environments, so
the collector writes the SAME report shape to a local file
(``<session_dir>/usage_stats.json``); an operator-side shipper (or
nothing) decides what leaves the machine — strictly more conservative
than the reference's HTTP POST.

Opt-out: ``RTPU_USAGE_STATS_ENABLED=0`` (reference
``RAY_USAGE_STATS_ENABLED`` role). Nothing is collected when disabled.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict

_LIBRARIES = ("data", "train", "tune", "serve", "rllib")


def usage_stats_enabled() -> bool:
    return os.environ.get("RTPU_USAGE_STATS_ENABLED", "1") not in (
        "0", "false", "no")


def collect_usage(rt) -> Dict[str, Any]:
    """Build the usage record from a live runtime (cheap: no RPCs beyond
    the cached node view)."""
    from ray_tpu_torch._version import __version__

    libs = [lib for lib in _LIBRARIES
            if f"ray_tpu_torch.{lib}" in sys.modules]
    try:
        n_nodes = 1
        if rt.cluster is not None:
            n_nodes = len([n for n in rt.cluster._nodes() if n["alive"]])
    except Exception:
        n_nodes = 1
    return {
        "schema_version": 1,
        "ray_tpu_version": __version__,
        "python_version": sys.version.split()[0],
        "collected_at": time.time(),
        "session_id": rt.session,
        "num_nodes": n_nodes,
        "total_resources": dict(rt.total),
        "libraries_used": libs,
        "worker_zygote": True,
    }


def write_usage_report(rt) -> str:
    """Write the report under the session dir; returns the path ('' when
    disabled or on failure — usage reporting must never break anything)."""
    if not usage_stats_enabled():
        return ""
    try:
        path = os.path.join(rt.session_dir, "usage_stats.json")
        with open(path, "w") as f:
            json.dump(collect_usage(rt), f, indent=1)
        return path
    except Exception:
        return ""
