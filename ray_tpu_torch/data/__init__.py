"""ray_tpu_torch.data — streaming distributed datasets feeding training
on the card (twin of ``ray_tpu/data/``).

Role analog: ``python/ray/data`` (SURVEY §2.5, §3.7). Same architecture in
compact form: lazy logical plan → fused map stages → streaming execution
over the task runtime with bounded in-flight backpressure; all-to-all ops
run through the streaming exchange. Every module but ``iterator.py`` is a
copy of the reference's; ``DataIterator.iter_torch_batches`` yields
batches on the card from pinned memory, one batch ahead of the consumer
(the ingest path of ``TorchTrainer``).
"""

from ray_tpu_torch.data.block import Block, BlockMetadata
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data.execution import (ActorPoolStrategy,
                                    BackpressurePolicy,
                                    ConcurrencyCapBackpressurePolicy,
                                    ExecutionOptions,
                                    StoreMemoryBackpressurePolicy)
from ray_tpu_torch.data.optimizer import (CollapseRepartitionIntoShuffle,
                                    DEFAULT_RULES, EliminateRedundantShuffles,
                                    FuseLimits, OperatorFusionRule, Optimizer,
                                    Rule, plan_summary)
from ray_tpu_torch.data.grouped import GroupedData
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.read_api import (
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    range_tensor,
    read_binary_files,
    read_images,
    read_csv,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
)

__all__ = [
    "Block",
    "BlockMetadata",
    "Dataset",
    "DataIterator",
    "ExecutionOptions",
    "ActorPoolStrategy",
    "BackpressurePolicy",
    "ConcurrencyCapBackpressurePolicy",
    "StoreMemoryBackpressurePolicy",
    "Optimizer",
    "Rule",
    "DEFAULT_RULES",
    "OperatorFusionRule",
    "EliminateRedundantShuffles",
    "CollapseRepartitionIntoShuffle",
    "FuseLimits",
    "plan_summary",
    "GroupedData",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "range_tensor",
    "read_binary_files",
    "read_images",
    "read_csv",
    "read_json",
    "read_numpy",
    "read_parquet",
    "read_text",
]
