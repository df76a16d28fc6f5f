"""Backend plugins: per-framework worker-group setup hooks (twin of
``ray_tpu/train/backend.py``).

Role analog: ``Backend``/``BackendConfig`` (``python/ray/train/backend.py``)
and the reference's ``TorchConfig`` (``train/torch/config.py``): on_start
does the rendezvous, on_shutdown cleans up. ``TorchConfig`` stands where the
JAX package's ``JaxConfig`` stands: a ``torch.distributed`` process group in
place of the JAX coordination service.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from ray_tpu_torch.parallel.mesh import MeshConfig


@dataclass
class BackendConfig:
    @property
    def backend_cls(self):
        return Backend


class Backend:
    """Hooks called by the BackendExecutor around the worker group."""

    def on_start(self, worker_group, backend_config: BackendConfig):
        pass

    def on_training_start(self, worker_group, backend_config: BackendConfig):
        pass

    def on_shutdown(self, worker_group, backend_config: BackendConfig):
        pass


@dataclass
class TorchConfig(BackendConfig):
    """PyTorch backend config.

    ``distributed=None`` (auto): start a ``torch.distributed`` process
    group only when the group has more than one worker — a one-worker
    group (one card, CPU tests) needs none. The rendezvous is
    ``tcp://<worker 0's address>:<coordinator_port>`` (default: a port
    worker 0 finds free) with an explicit world size and rank each
    (reference ``_setup_torch_process_group``'s MASTER_ADDR,
    ``train/torch/config.py:65``); NCCL when the workers hold cards, gloo
    on the CPU.
    """

    distributed: Optional[bool] = None
    coordinator_port: Optional[int] = None
    mesh: MeshConfig = field(default_factory=MeshConfig)
    extra_env: Dict[str, str] = field(default_factory=dict)

    @property
    def backend_cls(self):
        return TorchBackend


def _coordinator(port: Optional[int]) -> str:
    """``tcp://<this host's address>:<port>``; a free port when None."""
    import socket

    host = socket.gethostbyname(socket.gethostname())
    if port is None:
        with socket.socket() as s:
            s.bind((host, 0))
            port = s.getsockname()[1]
    return f"tcp://{host}:{port}"


def _init_torch_distributed(init_method: str, world_size: int,
                            rank: int) -> Dict[str, object]:
    import torch
    import torch.distributed as dist

    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(0)    # the one card this worker sees
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return {"backend": backend, "rank": dist.get_rank(),
            "world_size": dist.get_world_size()}


def _shutdown_torch_distributed() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchConfig):
        n = len(worker_group)
        distributed = backend_config.distributed
        if distributed is None:
            distributed = n > 1
        env = dict(backend_config.extra_env)
        if env:
            worker_group.execute(lambda e=env: __import__("os").environ.update(e))
        if distributed:
            init_method = worker_group.execute_single(
                0, _coordinator, backend_config.coordinator_port)
            import ray_tpu_torch

            refs = [
                w.execute.remote(_init_torch_distributed, init_method, n, i)
                for i, w in enumerate(worker_group.workers)
            ]
            ray_tpu_torch.get(refs)

    def on_shutdown(self, worker_group, backend_config: TorchConfig):
        try:
            worker_group.execute(_shutdown_torch_distributed)
        except Exception:
            pass
