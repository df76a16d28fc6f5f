"""Utilities over the runtime: placement groups, the state API
(``util.state``), and the observability planes (tracing, metrics, events,
profiling, contention, and the device plane's program registry,
``util.device_plane``)."""

from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    placement_group,
    remove_placement_group,
)

__all__ = ["placement_group", "remove_placement_group", "PlacementGroup"]
