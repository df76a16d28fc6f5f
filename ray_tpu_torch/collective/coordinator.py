"""Coordinator actor: rendezvous + reduction meeting point for STORE groups
(a copy of ``ray_tpu/collective/coordinator.py``).

Role analog: the reference's named ``Info`` store actor used for NCCL-UID
rendezvous (``nccl_collective_group.py:29`` ``Rendezvous``) — generalized
here to also perform the reductions themselves, which is what makes the
STORE backend a working gloo replacement: ranks post numpy contributions,
the last arriver reduces, everyone polls the result slot.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def _reduce(parts: List[np.ndarray], op: str) -> np.ndarray:
    acc = np.array(parts[0], copy=True)
    for p in parts[1:]:
        if op in ("sum", "mean"):
            acc += p
        elif op == "product":
            acc *= p
        elif op == "max":
            np.maximum(acc, p, out=acc)
        elif op == "min":
            np.minimum(acc, p, out=acc)
        else:
            raise ValueError(f"unknown reduce op {op}")
    if op == "mean":
        acc = acc / len(parts)
    return acc


class CollectiveCoordinator:
    """One instance per named group, created by whoever declares the group.

    Every op is keyed by a per-rank monotonically increasing sequence number
    (ranks must issue collectives in the same order — same contract NCCL
    imposes). Results are kept until every rank has fetched them.
    """

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._pending: Dict[Tuple[str, int], Dict[int, Any]] = {}
        self._results: Dict[Tuple[str, int], Tuple[Any, set]] = {}
        self._p2p: Dict[Tuple[int, int, int], Any] = {}
        self._meta: Dict[str, Any] = {}
        self._meta_ts: Dict[str, float] = {}

    def world(self) -> int:
        return self.world_size

    # -- metadata / rendezvous ------------------------------------------------
    def set_meta(self, key: str, value: Any) -> None:
        import time

        self._meta[key] = value
        self._meta_ts[key] = time.monotonic()

    def get_meta(self, key: str) -> Any:
        return self._meta.get(key)

    def get_meta_fresh(self, key: str, max_age_s: float) -> Any:
        """Value only if set within ``max_age_s`` by THIS actor's clock —
        rendezvous readers use it to reject addresses left behind by a
        crashed previous incarnation of the group."""
        import time

        ts = self._meta_ts.get(key)
        if ts is None or time.monotonic() - ts > max_age_s:
            return None
        return self._meta.get(key)

    # -- collectives ----------------------------------------------------------
    def contribute(self, kind: str, seq: int, rank: int, part: Any,
                   op: str = "sum", root: int = 0) -> Optional[Any]:
        """Post rank's contribution; returns the result if this completes it."""
        key = (kind, seq)
        slot = self._pending.setdefault(key, {})
        slot[rank] = part
        if len(slot) < self.world_size:
            return None
        parts = [slot[r] for r in range(self.world_size)]
        del self._pending[key]
        if kind in ("allreduce", "reduce"):
            result = _reduce([np.asarray(p) for p in parts], op)
        elif kind in ("allgather", "gather"):
            result = parts
        elif kind == "broadcast":
            result = parts[root]
        elif kind == "reducescatter":
            reduced = _reduce([np.asarray(p) for p in parts], op)
            result = np.array_split(reduced, self.world_size, axis=0)
        elif kind == "alltoall":
            # parts[r] is a list of world_size chunks; rank i gets chunk i of each.
            result = [[parts[r][i] for r in range(self.world_size)]
                      for i in range(self.world_size)]
        elif kind == "barrier":
            result = True
        else:
            raise ValueError(f"unknown collective kind {kind}")
        self._results[key] = (result, set())
        return self._take(key, rank)

    def _take(self, key, rank):
        result, taken = self._results[key]
        taken.add(rank)
        kind = key[0]
        if kind in ("reducescatter", "alltoall"):
            out = result[rank]
        elif kind in ("reduce", "gather"):
            out = result  # root-only semantics enforced caller-side
        else:
            out = result
        if len(taken) >= self.world_size:
            del self._results[key]
        return out

    def fetch(self, kind: str, seq: int, rank: int) -> Tuple[bool, Any]:
        key = (kind, seq)
        if key not in self._results:
            return False, None
        return True, self._take(key, rank)

    # -- p2p ------------------------------------------------------------------
    def send(self, src: int, dst: int, seq: int, value: Any) -> None:
        self._p2p[(src, dst, seq)] = value

    def recv(self, src: int, dst: int, seq: int) -> Tuple[bool, Any]:
        key = (src, dst, seq)
        if key in self._p2p:
            return True, self._p2p.pop(key)
        return False, None
