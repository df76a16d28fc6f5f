"""LLM serving on PyTorch: the paged continuous-batching engine and its
host-side KV bookkeeping and admission control."""

from ray_tpu_torch.serve.admission import (AdmissionController,
                                           DeadlineExceededError,
                                           RequestShedError, SLOConfig)
from ray_tpu_torch.serve.kv_cache import BlockPool, KVCacheError, PrefixCache
from ray_tpu_torch.serve.llm import LLMEngine

__all__ = [
    "AdmissionController",
    "BlockPool",
    "DeadlineExceededError",
    "KVCacheError",
    "LLMEngine",
    "PrefixCache",
    "RequestShedError",
    "SLOConfig",
]
