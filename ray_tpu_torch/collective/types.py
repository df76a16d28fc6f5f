"""Collective types — parity with ``python/ray/util/collective/types.py``
(twin of ``ray_tpu/collective/types.py``).

Backends keep the reference package's names and its table of aliases, so
calls carry over: XLA is the device backend (here: collectives over the
cards one process owns, ``torch.cuda.nccl``), XLA_DISTRIBUTED one group
across member processes (a ``torch.distributed`` process group: NCCL on
the card, gloo on the CPU), and STORE the CPU/control backend (reductions
through the shared-memory object store via a coordinator actor — the
gloo-analog that works anywhere, used for rendezvous, metrics, and
small-tensor sync).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class Backend(str, enum.Enum):
    XLA = "xla"
    STORE = "store"
    # one group spanning MULTIPLE member processes, backed by
    # torch.distributed (the reference NCCLGroup's role)
    XLA_DISTRIBUTED = "xla_distributed"

    @classmethod
    def parse(cls, value) -> "Backend":
        if isinstance(value, Backend):
            return value
        v = str(value).lower()
        if v in ("xla", "tpu", "ici"):
            return cls.XLA
        if v in ("xla_distributed", "jax_distributed", "distributed",
                 "multiprocess"):
            return cls.XLA_DISTRIBUTED
        if v in ("store", "cpu", "gloo"):
            return cls.STORE
        if v in ("nccl", "mpi"):
            raise ValueError(
                f"backend {value!r} is GPU/MPI-specific; use 'xla' (device) "
                f"or 'store' (cpu) in ray_tpu_torch"
            )
        raise ValueError(f"unknown collective backend: {value!r}")


class ReduceOp(str, enum.Enum):
    SUM = "sum"
    PRODUCT = "product"
    MAX = "max"
    MIN = "min"
    MEAN = "mean"


@dataclass
class AllReduceOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
    timeout_ms: int = 30000


@dataclass
class BarrierOptions:
    timeout_ms: int = 30000


@dataclass
class ReduceOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
    root_rank: int = 0
    timeout_ms: int = 30000


@dataclass
class BroadcastOptions:
    root_rank: int = 0
    timeout_ms: int = 30000


@dataclass
class AllGatherOptions:
    timeout_ms: int = 30000


@dataclass
class ReduceScatterOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
    timeout_ms: int = 30000


@dataclass
class SendOptions:
    dst_rank: int = 0
    timeout_ms: int = 30000


@dataclass
class RecvOptions:
    src_rank: int = 0
    timeout_ms: int = 30000
