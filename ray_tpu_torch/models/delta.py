"""LoRA-style parameter deltas for model multiplexing (twin of
``ray_tpu/models/delta.py``).

A fine-tune variant in a multiplexed fleet is a low-rank delta over a
shared base: per target projection leaf, factors ``a [L, d, r]`` and
``b [L, r, rest]``. :func:`apply_delta` rebuilds only the touched leaves
and hands back every other leaf as the base's own tensor, so a resident
variant costs its delta bytes plus the few rebuilt projections, not a full
copy of the model.

Plain functions over dicts of tensors, like the rest of ``models/``. The
update is a batched matmul outside any kernel, as it is in the reference
(``jnp.einsum`` there, ``torch.einsum`` here).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ray_tpu_torch._device import Device, resolve_device
from ray_tpu_torch.models.config import TransformerConfig
from ray_tpu_torch.models.transformer import torch_dtype

Params = Dict[str, Any]

#: the leaves a delta perturbs by default: attention q and v, the usual
#: LoRA targets
DEFAULT_TARGETS: Tuple[str, ...] = ("wq", "wv")


def target_shapes(c: TransformerConfig) -> Dict[str, Tuple[int, int]]:
    """(rows, columns) of each projection a delta may target, its leaf
    flattened past the layer axis."""
    d = c.d_model
    return {"wq": (d, c.n_heads * c.hdim),
            "wk": (d, c.kv_heads * c.hdim),
            "wv": (d, c.kv_heads * c.hdim),
            "wo": (c.n_heads * c.hdim, d)}


def make_delta(generator: torch.Generator, config: TransformerConfig, *,
               rank: int = 2, scale: float = 1.0,
               targets: Tuple[str, ...] = DEFAULT_TARGETS,
               device: Optional[Device] = None) -> Params:
    """A random low-rank delta drawn from a seeded ``torch.Generator`` on
    ``device``: per target leaf ``W [L, d, ...]`` the factors ``a [L, d, r]``
    (std ``d ** -0.5``) and ``b [L, r, prod(rest)]`` (std ``r ** -0.5``),
    drawn in float32 and stored in ``param_dtype``, as the reference draws
    them. The update is ``scale * (a @ b)`` reshaped to ``W``'s shape;
    ``scale=0`` gives a variant equal to its base."""
    c = config
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} cannot fill "
                         f"tensors on {dev}")
    pdt = torch_dtype(c.param_dtype)
    shapes = target_shapes(c)
    L = c.n_layers
    out: Dict[str, Any] = {}
    for name in targets:
        if name not in shapes:
            raise ValueError(
                f"unknown delta target {name!r}; have {sorted(shapes)}")
        din, dout = shapes[name]
        a = (torch.randn((L, din, rank), generator=generator,
                         dtype=torch.float32, device=dev)
             * din ** -0.5).to(pdt)
        b = (torch.randn((L, rank, dout), generator=generator,
                         dtype=torch.float32, device=dev)
             * rank ** -0.5).to(pdt)
        out[name] = {"a": a, "b": b}
    return {"scale": float(scale), "targets": out}


def apply_delta(params: Params, delta: Params) -> Params:
    """``base + delta``: each target leaf is rebuilt as
    ``W + scale * einsum("ldr,lre->lde", a, b)`` in ``W``'s dtype; every
    other leaf is the base's own tensor (the same object), so dropping a
    variant never touches the base."""
    scale = float(delta.get("scale", 1.0))
    layers = dict(params["layers"])
    for name, fac in delta["targets"].items():
        w = layers[name]
        flat = w.reshape(w.shape[0], w.shape[1], -1)
        upd = torch.einsum("ldr,lre->lde",
                           fac["a"].to(device=flat.device, dtype=flat.dtype),
                           fac["b"].to(device=flat.device, dtype=flat.dtype))
        layers[name] = (flat + scale * upd).reshape(w.shape).to(w.dtype)
    out = dict(params)
    out["layers"] = layers
    return out


def delta_bytes(delta: Params) -> int:
    """Bytes of the delta's own factors (what a registry charges a variant
    beyond its rebuilt leaves)."""
    return sum(leaf.numel() * leaf.element_size()
               for fac in delta["targets"].values()
               for leaf in (fac["a"], fac["b"]))


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def params_bytes(params: Params) -> int:
    """Total bytes of a parameter dict's tensors (registry budget
    accounting; a leaf shared twice counts twice, as in the reference)."""
    return sum(int(x.numel()) * x.element_size() for x in _leaves(params))
