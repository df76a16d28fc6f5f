"""Device meshes with named parallelism axes (twin of
``ray_tpu/parallel/mesh.py``).

The axis names, their order and :class:`MeshConfig`'s arithmetic are the
reference's. What a mesh is differs: the JAX package lays chips out on a
grid and lets GSPMD partition programs over it; here one process drives one
card, and the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the process group's ranks (one device a rank), or a one-rank
:class:`LocalMesh` when no process group exists.

Only the data axes may exceed 1 so far: ``dp`` (replicated parameters,
gradients all-reduced) and ``dcn`` (the outermost data axis). Sharded
parameters (``fsdp``, ``tp``: FSDP2 / DTensor in ``parallel/sharding.py``)
are ``ROADMAP.md`` queue 1 item 5; ``sp``, ``ep`` and ``pp`` are item 7.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

#: axes above 1 that the port does not run yet, and where they are queued
_UNPORTED_AXES = {
    "fsdp": "ROADMAP.md queue 1 item 5 (parallel/sharding.py as FSDP2 / "
            "DTensor)",
    "tp": "ROADMAP.md queue 1 item 5 (parallel/sharding.py as FSDP2 / "
          "DTensor)",
    "sp": "ROADMAP.md queue 1 item 7",
    "ep": "ROADMAP.md queue 1 item 7",
    "pp": "ROADMAP.md queue 1 item 7",
}
DATA_AXES = ("dcn", "dp", "fsdp")


@dataclass(frozen=True)
class MeshConfig:
    """Declarative parallelism layout.

    Sizes of -1 mean "absorb whatever devices remain" (at most one axis may
    be -1). Axes of size 1 are kept in the mesh, so code can always name
    them.
    """

    dp: int = 1          # pure data parallel (replicated params)
    fsdp: int = -1       # data parallel with sharded params (ZeRO-3)
    tp: int = 1          # tensor parallel
    sp: int = 1          # sequence/context parallel
    ep: int = 1          # expert parallel
    pp: int = 1          # pipeline stages
    dcn: int = 1         # cross-slice (multi-pod) axis, outermost
    axis_order: Tuple[str, ...] = ("dcn", "pp", "dp", "fsdp", "sp", "tp", "ep")

    def sizes(self) -> Dict[str, int]:
        return {
            "dcn": self.dcn, "pp": self.pp, "dp": self.dp, "fsdp": self.fsdp,
            "sp": self.sp, "tp": self.tp, "ep": self.ep,
        }

    def resolve(self, n_devices: int) -> Dict[str, int]:
        """Fill in a single -1 axis so the product equals ``n_devices``."""
        sizes = self.sizes()
        unknown = [a for a, s in sizes.items() if s == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {unknown}")
        known = math.prod(s for s in sizes.values() if s != -1)
        if unknown:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {known}"
                )
            sizes[unknown[0]] = n_devices // known
        elif known != n_devices:
            raise ValueError(
                f"mesh axes product {known} != device count {n_devices}"
            )
        return sizes


def mesh_shape_for(config: MeshConfig, n_devices: int) -> Tuple[Tuple[str, int], ...]:
    sizes = config.resolve(n_devices)
    return tuple((a, sizes[a]) for a in config.axis_order)


def check_supported(shape: Dict[str, int]) -> None:
    """Raise ``NotImplementedError`` for an axis above 1 that only the
    unported sharding and pipeline layers could run."""
    for axis, where in _UNPORTED_AXES.items():
        if shape.get(axis, 1) > 1:
            hint = ("; the default fsdp=-1 absorbs every rank: with "
                    "several ranks pass MeshConfig(dp=N, fsdp=1)"
                    if axis == "fsdp" else "")
            raise NotImplementedError(
                f"mesh axis {axis}={shape[axis]} is not ported yet: {where}"
                f"{hint}")


class LocalMesh:
    """The one-rank mesh: every axis of size 1, no process group. Has the
    two ``DeviceMesh`` attributes the port reads: ``mesh_dim_names`` and
    ``shape``."""

    def __init__(self, names: Tuple[str, ...]):
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(1 for _ in self.mesh_dim_names)

    def __repr__(self) -> str:
        return f"LocalMesh({dict(zip(self.mesh_dim_names, self.shape))})"


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or a :class:`LocalMesh`, as
    ``jax.sharding.Mesh.shape`` gives it."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_mesh(config: Optional[MeshConfig] = None,
              device_type: Optional[str] = None):
    """Build the mesh of a :class:`MeshConfig` over ``world_size`` ranks of
    one device each (the process group's world, or 1 without one).

    With a process group: a ``DeviceMesh`` of the group's device type (or
    ``device_type``: ``cuda`` for NCCL, ``cpu`` for gloo) whose ranks are
    laid out row-major over ``axis_order``, as the reference lays out
    ``jax.devices()``. Without one: a :class:`LocalMesh`. Every process of
    the group must call it with the same config. Raises
    ``NotImplementedError`` for ``fsdp``, ``tp``, ``sp``, ``ep`` or ``pp``
    above 1.
    """
    import torch.distributed as dist

    config = config or MeshConfig()
    distributed = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    check_supported(config.sizes())
    shape = mesh_shape_for(config, world)
    check_supported(dict(shape))
    names = tuple(a for a, _ in shape)
    if not distributed:
        return LocalMesh(names)
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, tuple(s for _, s in shape),
                            mesh_dim_names=names)
