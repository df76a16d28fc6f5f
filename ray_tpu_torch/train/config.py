"""Train/AIR-style run configuration dataclasses (twin of
``ray_tpu/train/config.py``).

Role analogs in the reference: ``ScalingConfig``/``RunConfig``/
``FailureConfig``/``CheckpointConfig`` in ``python/ray/air/config.py`` and
``Result`` in ``python/ray/air/result.py``. A
:class:`ray_tpu_torch.parallel.mesh.MeshConfig` rides inside
``ScalingConfig`` so the parallelism layout is declared where the reference
only declares a worker count. ``use_gpu`` stands where the JAX package's
``use_tpu`` stands: one worker a card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ray_tpu_torch.parallel.mesh import MeshConfig


@dataclass
class ScalingConfig:
    """How many workers (processes) and what each one owns.

    One worker = one process driving at most one card. ``use_gpu`` asks
    for ``{"GPU": 1}`` a worker: the resource ``num_gpus=`` schedules on,
    so each worker is an actor in a fresh process that opts in to its card.
    ``topology`` names a multi-host TPU slice in the JAX package; slices
    and their pod-name resources come with the cluster layer
    (``ROADMAP.md`` queue 1 item 4), so it raises here.
    """

    num_workers: int = 1
    use_gpu: bool = False
    resources_per_worker: Dict[str, float] = field(default_factory=dict)
    placement_strategy: str = "PACK"
    topology: Optional[str] = None
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # Elastic membership: ``min_workers`` turns preemption tolerance
    # on — on worker/node loss the BackendExecutor re-forms the gang at
    # the largest placeable world size in [min_workers, num_workers]
    # instead of failing the run, and re-expands toward ``num_workers``
    # at checkpoint boundaries when capacity returns. None (default)
    # keeps the fixed-size gang: any loss is a group restart that burns a
    # FailureConfig.max_failures attempt. Elastic mode requires the user
    # loop to honor the rescale contract (read get_world_size() fresh
    # every session; see TrainContext.world_epoch).
    min_workers: Optional[int] = None

    def __post_init__(self):
        if self.topology is not None:
            raise NotImplementedError(
                f"ScalingConfig(topology={self.topology!r}): multi-host "
                "slices and their pod-name resources need the cluster "
                "layer, not ported yet (ROADMAP.md queue 1 item 4)")

    @property
    def elastic(self) -> bool:
        return self.min_workers is not None

    def resolved_min_workers(self) -> int:
        if self.min_workers is None:
            return self.num_workers
        return max(1, min(int(self.min_workers), self.num_workers))

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker)
        if "CPU" not in res:
            res["CPU"] = 1.0
        if self.use_gpu and "GPU" not in res:
            res["GPU"] = 1.0
        return res

    def effective_placement_strategy(self) -> str:
        return self.placement_strategy


@dataclass
class FailureConfig:
    """Failure-recovery budget for a training run.

    Group restart (reference ``backend_executor.py:708 _restart``) is now
    the FALLBACK, not the only recovery: with
    ``ScalingConfig.min_workers`` set, a worker/node loss first goes
    through the elastic path — fence the survivors, re-form the gang at
    the largest placeable world size, and resume from the last
    all-ranks-ok checkpoint — WITHOUT consuming a ``max_failures``
    attempt (preemption is weather, not a failure of the job).
    ``max_failures`` attempts are spent only when recovery has to fall
    back to a same-size group restart: elasticity disabled
    (``min_workers=None`` — one lost rank breaks the process group's
    collectives, so fixed-size runs must restart the whole gang), the
    surviving capacity below ``min_workers``, or the re-form loop itself
    failing ``elastic_reform_attempts`` times (double preemption burning
    every candidate world size).
    """

    max_failures: int = 0
    # bound on consecutive fence->re-form->resume attempts per membership
    # change: each attempt re-probes placeable capacity, so a second
    # preemption DURING re-form just shrinks the next attempt's target
    # (convergence), and the bound turns a pathological churn loop into
    # an ordinary group-restart fallback instead of a livelock.
    elastic_reform_attempts: int = 8


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 1
    callbacks: list = field(default_factory=list)   # tune logger callbacks
    stop: Optional[Any] = None                      # Stopper | callable

    def resolved_storage_path(self) -> str:
        return self.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_results")


@dataclass
class Result:
    """What ``Trainer.fit`` returns (reference ``air/result.py``)."""

    metrics: Dict[str, Any]
    checkpoint: Optional[Any]          # ray_tpu_torch.train.Checkpoint
    path: Optional[str] = None
    error: Optional[BaseException] = None
    metrics_dataframe: Optional[Any] = None
    config: Optional[Dict[str, Any]] = None

    @property
    def best_checkpoints(self):
        return getattr(self, "_best_checkpoints", [])
