"""The built-in transformer family on PyTorch: presets, the inference
forward, and the paged decode step the serving engine drives."""

from ray_tpu_torch.models.config import (
    PRESETS,
    TransformerConfig,
    gemma2_9b,
    gemma_debug,
    get_config,
    gpt2_debug,
    gpt2_small,
    llama3_8b,
    llama3_70b,
    llama_1b,
    llama_250m,
    llama_debug,
    mistral_7b,
    mistral_debug,
    moe_debug,
    qwen2_7b,
    qwen2_debug,
)
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.transformer import (
    copy_kv_block,
    decode_step_paged,
    forward,
    init_cache_paged,
    init_params,
)

__all__ = [
    "PRESETS",
    "TransformerConfig",
    "copy_kv_block",
    "decode_step_paged",
    "forward",
    "gemma2_9b",
    "gemma_debug",
    "get_config",
    "gpt2_debug",
    "gpt2_small",
    "init_cache_paged",
    "init_params",
    "llama3_8b",
    "llama3_70b",
    "llama_1b",
    "llama_250m",
    "llama_debug",
    "mistral_7b",
    "mistral_debug",
    "moe_debug",
    "params_from_jax",
    "qwen2_7b",
    "qwen2_debug",
]
