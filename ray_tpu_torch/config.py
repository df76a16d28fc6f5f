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
    "spec_k": Knob(int, 4, "draft tokens proposed per speculative-decoding "
                   "round (the target verifies k+1 positions in one step)"),
    "spec_accept_floor": Knob(float, 0.2, "per-request acceptance-EWMA "
                              "floor: a request whose draft acceptance "
                              "falls below it after the warmup rounds "
                              "decodes plainly from then on"),
    "device_plane": Knob(str, "1", "0 turns off the device plane's "
                         "accounting (the registry rows); programs are "
                         "captured and replayed either way"),
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
