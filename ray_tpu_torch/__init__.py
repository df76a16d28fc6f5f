"""ray_tpu_torch: the PyTorch + CUDA port of ray_tpu.

The JAX package ``ray_tpu`` stays the reference; this package mirrors its
layout (``ray_tpu_torch/ops/attention.py`` is the twin of
``ray_tpu/ops/attention.py``, and so on) and imports nothing of it. Every
TPU kernel on a ported path is a kernel written by hand for Hopper under
``ops/csrc/``, built with ``nvcc`` at first use.

The top level is the runtime's public API, as in the reference:
``init`` / ``shutdown`` / ``remote`` / ``get`` / ``put`` / ``wait``, actors,
and the object store (torch tensors travel out of band and come back on the
CPU). ``init(num_gpus=...)`` (default: the cards NVML counts, with no CUDA
context made) is the ``GPU`` resource; workers see no card unless an actor
opts in (``runtime_env={"env_vars": {"CUDA_VISIBLE_DEVICES": "0"}}`` beside
``num_gpus=1``). Subpackages (``serve``, ``models``, ``ops``, ``train``,
``parallel``, ``data``, ``collective``) load on first access; importing this package does not import torch.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
machine with no GPU they raise rather than quietly run on the CPU.
"""

import importlib

from ray_tpu_torch._version import __version__
from ray_tpu_torch.core.actor import ActorClass, ActorHandle
from ray_tpu_torch.core.object_ref import ObjectRef, ObjectRefGenerator
from ray_tpu_torch.core.runtime import (
    available_resources,
    cancel,
    cluster_resources,
    free,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    method,
    nodes,
    object_store_memory,
    put,
    remote,
    shutdown,
    timeline,
    wait,
)
from ray_tpu_torch.core.runtime_context import get_runtime_context

_SUBPACKAGES = ("core", "ops", "models", "train", "serve", "util",
                "accelerators", "parallel", "data", "collective")


def __getattr__(name: str):
    """Lazy subpackage access: ``import ray_tpu_torch;
    ray_tpu_torch.serve.run(...)``."""
    if name in _SUBPACKAGES:
        return importlib.import_module(f"ray_tpu_torch.{name}")
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


__all__ = [
    "__version__",
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "free",
    "get_actor",
    "get_runtime_context",
    "available_resources",
    "object_store_memory",
    "cluster_resources",
    "nodes",
    "method",
    "timeline",
    "ObjectRef",
    "ObjectRefGenerator",
    "ActorClass",
    "ActorHandle",
]
