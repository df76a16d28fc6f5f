"""Experimental: mutable shm ring channels and tensor channels (twin of
``ray_tpu/experimental``). The serve KV-transfer plane ships over them.

``broadcast_object`` replicates objects across a cluster's nodes and waits
for ``cluster/`` (ROADMAP.md queue 1 item 4).
"""

from ray_tpu_torch.experimental.channel import (
    Channel,
    ChannelFullError,
    ChannelTimeoutError,
)
from ray_tpu_torch.experimental.device_channel import (
    DeviceChannel,
    DeviceTensorType,
    TensorWithMeta,
)

__all__ = ["Channel", "ChannelFullError", "ChannelTimeoutError",
           "DeviceChannel", "DeviceTensorType", "TensorWithMeta"]
