"""Lazy DAG nodes (twin of ``ray_tpu/dag/dag_node.py``).

Role analog: ``python/ray/dag/{dag_node,input_node,class_node}.py``. A node
is (callable target, upstream args); ``execute`` resolves bottom-up through
ordinary task/actor calls.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


class DAGNode:
    _type_hint = None  # set by with_type_hint / with_tensor_transport

    def with_type_hint(self, hint) -> "DAGNode":
        """Annotate this node's OUTPUT edge (reference
        ``node.with_type_hint(TorchTensorType())``): a
        :class:`~ray_tpu_torch.experimental.device_channel.DeviceTensorType`
        makes the compiled channel carry a torch tensor's raw bytes."""
        self._type_hint = hint
        return self

    def with_tensor_transport(self, device: str = None) -> "DAGNode":
        """Reference ``with_tensor_transport`` sugar for the device type."""
        from ray_tpu_torch.experimental.device_channel import DeviceTensorType

        return self.with_type_hint(DeviceTensorType(device))

    def _upstream(self) -> List["DAGNode"]:
        out = []
        for a in list(getattr(self, "args", ())) + \
                list(getattr(self, "kwargs", {}).values()):
            if isinstance(a, DAGNode):
                out.append(a)
        return out

    def topo_sort(self) -> List["DAGNode"]:
        order: List[DAGNode] = []
        seen = set()

        def visit(n: "DAGNode"):
            if id(n) in seen:
                return
            seen.add(id(n))
            for u in n._upstream():
                visit(u)
            order.append(n)

        visit(self)
        return order

    def execute(self, *input_args) -> Any:
        """Eager execution through normal task/actor submission; returns the
        final ObjectRef (or value for InputNode)."""
        values: Dict[int, Any] = {}
        for node in self.topo_sort():
            if isinstance(node, InputNode):
                values[id(node)] = input_args[0] if len(input_args) == 1 \
                    else input_args
                continue
            args = [values[id(a)] if isinstance(a, DAGNode) else a
                    for a in node.args]
            kwargs = {k: values[id(v)] if isinstance(v, DAGNode) else v
                      for k, v in node.kwargs.items()}
            values[id(node)] = node._invoke(args, kwargs)
        return values[id(self)]

    def experimental_compile(self, **kwargs):
        from ray_tpu_torch.dag.compiled_dag import CompiledDAG

        return CompiledDAG(self, **kwargs)


class InputNode(DAGNode):
    """The DAG's runtime input placeholder. Supports context-manager use
    (reference style: ``with InputNode() as inp: ...``)."""

    args: Tuple = ()
    kwargs: Dict[str, Any] = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class ClassMethodNode(DAGNode):
    def __init__(self, actor_handle, method_name: str,
                 args: Tuple, kwargs: Dict[str, Any]):
        self.actor = actor_handle
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs

    def _invoke(self, args, kwargs):
        return getattr(self.actor, self.method_name).remote(*args, **kwargs)

    def __repr__(self):
        return f"ClassMethodNode({self.method_name} on {self.actor})"


class FunctionNode(DAGNode):
    """A remote-function DAG node (``fn.bind`` analog)."""

    def __init__(self, remote_fn, args: Tuple, kwargs: Dict[str, Any]):
        self.fn = remote_fn
        self.args = args
        self.kwargs = kwargs

    def _invoke(self, args, kwargs):
        return self.fn.remote(*args, **kwargs)

    def __repr__(self):
        return f"FunctionNode({getattr(self.fn, '__name__', self.fn)})"
