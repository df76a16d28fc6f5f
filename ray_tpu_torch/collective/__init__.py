"""Host-level collective communication (``ray.util.collective`` parity;
twin of ``ray_tpu/collective/``)."""

from ray_tpu_torch.collective.types import (
    Backend,
    ReduceOp,
)
from ray_tpu_torch.collective.collective import (
    init_collective_group,
    create_collective_group,
    destroy_collective_group,
    is_group_initialized,
    get_collective_group,
    get_rank,
    get_collective_group_size,
    allreduce,
    allgather,
    alltoall,
    barrier,
    broadcast,
    reduce,
    reducescatter,
    send,
    recv,
)

__all__ = [
    "Backend", "ReduceOp",
    "init_collective_group", "create_collective_group",
    "destroy_collective_group", "is_group_initialized",
    "get_collective_group", "get_rank", "get_collective_group_size",
    "allreduce", "allgather", "alltoall", "barrier", "broadcast",
    "reduce", "reducescatter", "send", "recv",
]
