"""ray_tpu_torch.dag — lazy DAGs of actor-method calls + compiled execution
(twin of ``ray_tpu/dag``).

Role analog: ``python/ray/dag`` (``dag_node.py``, ``compiled_dag_node.py:278``).
Build a graph with ``InputNode`` and ``ActorMethod.bind``; ``execute`` runs
it as ordinary actor calls; ``experimental_compile`` pre-allocates mutable
shm RING channels per edge (``max_in_flight + 1`` slots) and starts an
exec loop inside each actor, so repeated invocations bypass task
submission entirely — the driver writes the input channel and reads the
output channel, with up to ``max_in_flight`` invocations overlapping and
strict FIFO result delivery. A ``with_tensor_transport()`` edge carries one
torch tensor's raw bytes (``experimental/device_channel.py``).
"""

from ray_tpu_torch.dag.dag_node import (
    DAGNode,
    InputNode,
    ClassMethodNode,
    FunctionNode,
)
from ray_tpu_torch.dag.compiled_dag import (
    CompiledDAG,
    CompiledDAGFuture,
    DAGBackpressureError,
    DAGExecutionError,
)

__all__ = [
    "DAGNode",
    "InputNode",
    "ClassMethodNode",
    "FunctionNode",
    "CompiledDAG",
    "CompiledDAGFuture",
    "DAGBackpressureError",
    "DAGExecutionError",
]
