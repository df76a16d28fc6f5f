"""Ops: layer primitives, attention, and the Hopper flash-attention kernel."""

from ray_tpu_torch.ops.attention import (flash_attention, naive_attention,
                                         resolve_attention_impl,
                                         set_default_attention_impl)
from ray_tpu_torch.ops.layers import (apply_rotary, layer_norm, rms_norm,
                                      rotary_embedding, swiglu)

__all__ = [
    "apply_rotary",
    "flash_attention",
    "layer_norm",
    "naive_attention",
    "resolve_attention_impl",
    "rms_norm",
    "rotary_embedding",
    "set_default_attention_impl",
    "swiglu",
]
