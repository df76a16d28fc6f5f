"""Carry weights across from the JAX package.

:func:`params_from_jax` takes the JAX package's parameter tree as numpy
arrays (``jax.device_get(params)`` or ``np.asarray`` per leaf, done by the
caller) and returns the port's parameter dict with the same keys and
layouts; :func:`delta_from_jax` does the same for a LoRA-style delta
(``models/delta.py``: numpy factors and a float ``scale``). This module
never imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from ray_tpu_torch._device import Device, resolve_device


def _to_tensor(a: Any, device: torch.device,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: torch cannot wrap it
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: Mapping[str, Any], *,
                    device: Optional[Device] = None,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """Nested dict of arrays -> nested dict of tensors on ``device``, cast
    to ``dtype`` when given (else each leaf keeps its dtype)."""
    dev = resolve_device(device)
    return {k: (params_from_jax(v, device=dev, dtype=dtype)
                if isinstance(v, Mapping) else _to_tensor(v, dev, dtype))
            for k, v in tree.items()}


def delta_from_jax(delta: Mapping[str, Any], *,
                   device: Optional[Device] = None,
                   dtype: Optional[torch.dtype] = None) -> dict:
    """A JAX delta ``{"scale": s, "targets": {name: {"a": .., "b": ..}}}``
    with numpy factors -> the port's delta: the same layout (the factors
    multiply the leaves' ``[L, d, ...]`` layout, which the port shares with
    the reference), tensors on ``device``, ``scale`` a float."""
    return {"scale": float(delta.get("scale", 1.0)),
            "targets": params_from_jax(delta["targets"], device=device,
                                       dtype=dtype)}
