"""LLM serving on PyTorch: the paged continuous-batching engine (with KV
export and adoption for disaggregated serving), speculative decoding over
it, and their host-side KV bookkeeping and admission control."""

from ray_tpu_torch.serve.admission import (AdmissionController,
                                           DeadlineExceededError,
                                           RequestShedError, SLOConfig)
from ray_tpu_torch.serve.kv_cache import BlockPool, KVCacheError, PrefixCache
from ray_tpu_torch.serve.llm import KVExport, LLMEngine
from ray_tpu_torch.serve.multiplex import SpeculativeLLMEngine

__all__ = [
    "AdmissionController",
    "BlockPool",
    "DeadlineExceededError",
    "KVCacheError",
    "KVExport",
    "LLMEngine",
    "PrefixCache",
    "RequestShedError",
    "SLOConfig",
    "SpeculativeLLMEngine",
]
