"""Node-label wire format: ``k=v,k=v`` env-var round-trip (one place so
spawners and workers can't drift)."""

from __future__ import annotations

from typing import Dict

ENV_VAR = "RTPU_NODE_LABELS"


def parse_labels(raw: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for part in (raw or "").split(","):
        if "=" in part:
            k, _, v = part.partition("=")
            out[k.strip()] = v.strip()
    return out


def format_labels(labels: Dict[str, str]) -> str:
    return ",".join(f"{k}={v}" for k, v in labels.items())
