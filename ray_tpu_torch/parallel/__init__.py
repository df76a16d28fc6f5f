"""The parallelism layer of the port (twin of ``ray_tpu/parallel``).

- :mod:`ray_tpu_torch.parallel.mesh` — device meshes with the reference's
  named axes (dp/fsdp/tp/sp/ep/pp/dcn) over the process group's ranks.

Data parallelism (``dp``, ``dcn``) runs: the train step all-reduces the
gradients over the group. ``parallel/sharding.py`` (FSDP2 / DTensor, for
``fsdp`` and ``tp``) and ``parallel/ops.py`` are not ported yet
(``ROADMAP.md`` queue 1 items 5 and 7).
"""

from ray_tpu_torch.parallel.mesh import (
    LocalMesh,
    MeshConfig,
    make_mesh,
    mesh_shape_for,
    mesh_sizes,
)

__all__ = [
    "LocalMesh",
    "MeshConfig",
    "make_mesh",
    "mesh_shape_for",
    "mesh_sizes",
]
