"""ray_tpu_torch: the PyTorch + CUDA port of ray_tpu's model and serving path.

The JAX package ``ray_tpu`` stays the reference; this package mirrors its
layout (``ray_tpu_torch/ops/attention.py`` is the twin of
``ray_tpu/ops/attention.py``, and so on) and imports nothing of it. Every
TPU kernel on a ported path is a kernel written by hand for Hopper under
``ops/csrc/``, built with ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
machine with no GPU they raise rather than quietly run on the CPU.
"""

from ray_tpu_torch._version import __version__

__all__ = ["__version__"]
