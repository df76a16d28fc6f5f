"""WorkerGroup: the gang of train-worker actors (twin of
``ray_tpu/train/worker_group.py``).

Role analog: ``python/ray/train/_internal/worker_group.py`` (``WorkerGroup``
:102, ``RayTrainWorker`` :19). Each worker is one process driving at most
one card. A worker that asks for a ``GPU`` is a ``num_gpus=1`` actor: it
gets a fresh process and opts in to its card through its own
``CUDA_VISIBLE_DEVICES`` (workers start with none visible); worker ``i``
of the group sees card ``i`` of the node, modulo the node's cards.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import TrainContext, _Session, _init_session, \
    _shutdown_session, get_session


class RayTrainWorker:
    """Actor running on each host of the worker group."""

    def __init__(self):
        self._session: Optional[_Session] = None

    # -- environment / metadata ------------------------------------------

    def set_env_vars(self, env: Dict[str, str]) -> None:
        os.environ.update({k: str(v) for k, v in env.items()})

    def get_metadata(self) -> Dict[str, Any]:
        return {
            "hostname": socket.gethostname(),
            "ip": socket.gethostbyname(socket.gethostname()),
            "pid": os.getpid(),
        }

    def get_device_info(self) -> Dict[str, Any]:
        import torch
        import torch.distributed as dist

        cuda = torch.cuda.is_available()
        distributed = dist.is_available() and dist.is_initialized()
        return {
            "backend": "cuda" if cuda else "cpu",
            "device_name": torch.cuda.get_device_name(0) if cuda else None,
            "local_device_count": torch.cuda.device_count() if cuda else 0,
            "world_size": dist.get_world_size() if distributed else 1,
            "rank": dist.get_rank() if distributed else 0,
        }

    def execute(self, fn: Callable, *args, **kwargs):
        """Run an arbitrary function in the worker process."""
        return fn(*args, **kwargs)

    # -- training session -------------------------------------------------

    def start_session(
        self,
        train_fn: Callable,
        context: TrainContext,
        starting_checkpoint_path: Optional[str] = None,
    ) -> None:
        ckpt = (Checkpoint(starting_checkpoint_path)
                if starting_checkpoint_path else None)
        os.makedirs(context.trial_dir, exist_ok=True)
        session = _Session(lambda: train_fn(context.loop_config)
                           if _fn_wants_config(train_fn) else train_fn(),
                           context, ckpt)
        self._session = session
        _init_session(session)
        session.start()

    def next_result(self, timeout: Optional[float] = 60.0):
        assert self._session is not None, "no session running"
        kind, payload, ckpt = self._session.next_result(timeout=timeout)
        if kind == "error":
            raise payload
        return (kind, payload, ckpt)

    def shutdown_session(self) -> None:
        self._session = None
        _shutdown_session()


def _node_cards() -> int:
    """The node's ``GPU`` resource: the cards the runtime counted."""
    return int(ray_tpu_torch.cluster_resources().get("GPU", 0))


def _fn_wants_config(fn: Callable) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return len(sig.parameters) >= 1


class WorkerGroup:
    """Spawns and addresses N RayTrainWorker actors."""

    def __init__(
        self,
        num_workers: int,
        resources_per_worker: Dict[str, float],
        placement_group=None,
    ):
        cls = ray_tpu_torch.remote(RayTrainWorker)
        gpus = resources_per_worker.get("GPU", 0.0)
        n_cards = _node_cards() if gpus else 0
        self.workers: List[Any] = []
        for i in range(num_workers):
            opts: Dict[str, Any] = {
                "num_cpus": resources_per_worker.get("CPU", 1.0),
                "resources": {k: v for k, v in resources_per_worker.items()
                              if k not in ("CPU", "GPU")},
            }
            if gpus:
                opts["num_gpus"] = gpus
                opts["runtime_env"] = {"env_vars": {
                    "CUDA_VISIBLE_DEVICES": str(i % max(n_cards, 1))}}
            if placement_group is not None:
                opts["placement_group"] = placement_group
                opts["placement_group_bundle_index"] = i
            self.workers.append(cls.options(**opts).remote())

    def __len__(self):
        return len(self.workers)

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Run fn on every worker, return all results (ordered by rank)."""
        return ray_tpu_torch.get([w.execute.remote(fn, *args, **kwargs)
                            for w in self.workers])

    def execute_async(self, fn: Callable, *args, **kwargs):
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        return ray_tpu_torch.get(self.workers[rank].execute.remote(fn, *args, **kwargs))

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
