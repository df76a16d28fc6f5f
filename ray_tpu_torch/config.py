"""The few runtime knobs the port reads, from the same ``RTPU_<NAME>``
environment variables as ``ray_tpu/config.py`` (resolved lazily on each
access, with the same defaults)."""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, NamedTuple


class Knob(NamedTuple):
    type: Callable
    default: Any
    doc: str


_REGISTRY: Dict[str, Knob] = {
    "attn_impl": Knob(str, "", "attention on CPU tensors: blockwise | naive "
                      "(empty = auto); CUDA tensors always run the kernel"),
    "attn_block_q": Knob(int, 512, "query tile of the blockwise attention"),
    "attn_block_k": Knob(int, 512, "key/value tile of the blockwise attention"),
    "llm_block_size": Knob(int, 16, "tokens per paged-KV block"),
    "llm_prefill_chunk": Knob(int, 8, "prompt tokens consumed per engine step "
                              "during chunked prefill"),
}


def env_name(name: str) -> str:
    return "RTPU_" + name.upper()


def get(name: str) -> Any:
    """Env override if set (parsed to the knob's type, the default on a
    parse error), else the default."""
    k = _REGISTRY[name]
    raw = os.environ.get(env_name(name))
    if raw is None:
        return k.default
    try:
        return k.type(raw)
    except (ValueError, TypeError):
        return k.default
