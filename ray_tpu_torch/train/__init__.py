"""ray_tpu_torch.train — training through the framework (twin of
``ray_tpu/train/__init__.py``, the JAX package's train library).

``TorchTrainer`` stands where ``JaxTrainer`` does: ``fit()`` runs
``train_loop_per_worker`` on a gang of worker actors (a card each with
``ScalingConfig(use_gpu=True)``), with a ``torch.distributed`` process group
between them when there are several; ``report`` / ``get_context`` /
``get_checkpoint`` match ``ray.train.*``; failed workers restart the gang
from the latest complete checkpoint. Inside the loop ``TrainLoopHelper``
runs the step (data parallel over the group), saves crash-atomic
checkpoints in the background and profiles steps. Not ported yet:
``train/pipeline.py`` (``ROADMAP.md`` queue 1 item 7).
"""

from ray_tpu_torch.train.checkpoint import (AsyncSave, Checkpoint,
                                            load_pytree, save_pytree,
                                            save_pytree_async)
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.backend import Backend, BackendConfig, TorchConfig
from ray_tpu_torch.train.backend_executor import (
    ElasticWorldSizeError,
    TrainingProtocolError,
    TrainingWorkerError,
    WorkerDeathError,
)
from ray_tpu_torch.train.session import (
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train.trainer import (
    BaseTrainer,
    DataParallelTrainer,
    TorchTrainer,
    TrainingFailedError,
)
from ray_tpu_torch.train.train_state import (
    TrainLoopHelper,
    TrainState,
    adamw,
    create_train_state,
    make_train_step,
)
from ray_tpu_torch.train.telemetry import StepTelemetry, get_step_telemetry

__all__ = [
    "Checkpoint",
    "save_pytree",
    "save_pytree_async",
    "AsyncSave",
    "load_pytree",
    "CheckpointConfig",
    "FailureConfig",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "Backend",
    "BackendConfig",
    "TorchConfig",
    "TrainingWorkerError",
    "TrainingProtocolError",
    "WorkerDeathError",
    "ElasticWorldSizeError",
    "TrainContext",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "report",
    "BaseTrainer",
    "DataParallelTrainer",
    "TorchTrainer",
    "TrainingFailedError",
    "TrainLoopHelper",
    "TrainState",
    "adamw",
    "create_train_state",
    "make_train_step",
    "StepTelemetry",
    "get_step_telemetry",
]
