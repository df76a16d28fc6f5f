"""The port's device rule: ``cuda`` unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

Device = Union[str, torch.device]


def resolve_device(device: Optional[Device] = None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for (explicitly or
    by default) and no GPU is present: the port never falls back to the
    CPU on its own — pass ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev
