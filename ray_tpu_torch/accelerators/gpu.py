"""NVIDIA GPU accelerator support: the CUDA counterpart of
``ray_tpu/accelerators/tpu.py``.

The node's card count becomes the ``GPU`` resource that ``num_gpus=`` asks
for. It is counted without creating a CUDA context, and without even
initialising the CUDA driver API, in the process that asks (the driver at
``init()``): through NVML, as ``torch.cuda.device_count()`` does before CUDA
is initialised, else through ``nvidia-smi -L``. A process in which CUDA was
initialised can no longer pick its cards, and its forked children cannot
use CUDA at all.

Which cards a process sees is ``CUDA_VISIBLE_DEVICES``, read by CUDA once,
at its first use in the process. Workers get it empty
(:func:`hidden_worker_env`): they see no card until an actor opts in with
its own value.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

GPU_RESOURCE_NAME = "GPU"
CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
#: makes ``torch.cuda.is_available()`` ask NVML, not the CUDA driver API
NVML_CHECK_ENV = "PYTORCH_NVML_BASED_CUDA_CHECK"


def _nvml_count() -> Optional[int]:
    """The physical card count from NVML, or None without NVML."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    try:
        if nvml.nvmlInit_v2() != 0:
            return None
        try:
            n = ctypes.c_uint(0)
            if nvml.nvmlDeviceGetCount_v2(ctypes.byref(n)) != 0:
                return None
            return int(n.value)
        finally:
            nvml.nvmlShutdown()
    except AttributeError:
        return None


def _smi_count() -> Optional[int]:
    """The physical card count from ``nvidia-smi -L``, or None."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run([smi, "-L"], capture_output=True, text=True,
                             timeout=10, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return sum(1 for line in out.splitlines() if line.startswith("GPU "))


def visible_ids() -> Optional[List[str]]:
    """This process's ``CUDA_VISIBLE_DEVICES`` entries, or None when it is
    unset (every card visible). An empty value hides every card."""
    raw = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
    if raw is None:
        return None
    return [x.strip() for x in raw.split(",") if x.strip()]


def detect_num_gpus() -> int:
    """The cards this process may use, counted with no CUDA context."""
    physical = _nvml_count()
    if physical is None:
        physical = _smi_count()
    ids = visible_ids()
    if ids is not None:
        return len(ids) if physical is None else min(len(ids), physical)
    return physical or 0


#: dense bf16 tensor-core peaks (FLOP/s, no sparsity) by a part of the
#: name ``torch.cuda.get_device_name`` gives: NVIDIA's data sheet for the
#: H100 SXM part, whose name reads "H100 80GB HBM3"
DENSE_BF16_PEAKS = (("H100 80GB HBM3", 989.4e12), ("H100 SXM", 989.4e12))


def peak_flops(device=None) -> Optional[float]:
    """The dense bf16 peak of ``device`` (default: the current card), or
    None for a card the table does not know: the denominator of MFU."""
    import torch

    name = torch.cuda.get_device_name(device)
    return next((peak for part, peak in DENSE_BF16_PEAKS if part in name),
                None)


def hidden_worker_env() -> Dict[str, str]:
    """The environment a worker starts with: no card visible, and
    ``torch.cuda.is_available()`` answered by NVML, so asking initialises
    nothing."""
    return {CUDA_VISIBLE_DEVICES_ENV: "", NVML_CHECK_ENV: "1"}


class GPUAcceleratorManager:
    """Accelerator plugin for NVIDIA GPUs (reference ABC:
    ``_private/accelerators/accelerator.py``; the port's twin of
    ``TPUAcceleratorManager``)."""

    @staticmethod
    def get_resource_name() -> str:
        return GPU_RESOURCE_NAME

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        return detect_num_gpus()

    @staticmethod
    def get_current_process_visible_accelerator_ids() -> Optional[List[str]]:
        return visible_ids()

    @staticmethod
    def set_current_process_visible_accelerator_ids(ids: List[str]) -> None:
        """Restrict this process to ``ids``. Takes effect only where CUDA
        has not been initialised yet in this process."""
        if "torch" in sys.modules:
            import torch

            if torch.cuda.is_initialized():
                logger.warning("CUDA is already initialised in this "
                               "process; %s=%s has no effect",
                               CUDA_VISIBLE_DEVICES_ENV, ",".join(ids))
        os.environ[CUDA_VISIBLE_DEVICES_ENV] = ",".join(str(i) for i in ids)
