"""Hopper flash-attention forward: the counterpart of
``ray_tpu/ops/flash_pallas.py``'s forward.

The kernel lives in ``ops/csrc/flash_fwd.cu`` (CUDA C++ for ``sm_90a``,
built at first use and loaded with ctypes). :func:`flash_attention_fwd`
takes the same arguments and layouts as ``flash_attention_pallas_fwd``:
q ``[B, Lq, H, D]``, k/v ``[B, Lk, Hk, D]`` with ``H % Hk == 0``; it
returns ``out`` ``[B, Lq, H, D]`` in q's dtype and ``lse`` ``[B, H, Lq]``
float32. Ragged lengths are masked inside the kernel.

For CPU tensors the wrapper computes :func:`flash_attention_fwd_reference`,
the plain PyTorch version; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import _mha_fwd_blockwise, _repeat_kv

#: kernel launches by :func:`flash_attention_fwd` (callers reset it to 0)
launches = 0

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (64, 128)
_lib: Optional[ctypes.CDLL] = None


def _require_causal_window(causal: bool, window) -> None:
    if window and not causal:
        raise ValueError("window requires causal attention")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


def flash_attention_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: ``_mha_fwd_blockwise`` in float32 with
    GQA expanded by ``repeat_interleave`` (512 tiles, or one tile per
    sequence when 512 does not divide it, as the TPU wrapper does)."""
    _require_causal_window(causal, window)
    lq, h, d = q.shape[1], q.shape[2], q.shape[3]
    lk, hk = k.shape[1], k.shape[2]
    if h % hk:
        raise ValueError(f"q heads {h} not divisible by kv heads {hk}")
    scale = scale if scale is not None else d ** -0.5
    bq, bk = min(512, lq), min(512, lk)
    if lq % bq or lk % bk:
        bq, bk = lq, lk
    return _mha_fwd_blockwise(q, _repeat_kv(k, h), _repeat_kv(v, h), causal,
                              scale, bq, bk, window or None, softcap=softcap)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_fwd")
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 12
                       + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads 16-byte vectors: last dim contiguous, other strides
    multiples of 8 elements, base 16-byte aligned; copy when not."""
    if (t.stride(3) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward returning ``(out, lse)``.

    CPU tensors: the plain version. CUDA tensors: the Hopper kernel, for
    bfloat16 or float32 inputs (all three alike) and head dim 64 or 128;
    anything else raises.
    """
    global launches
    _require_causal_window(causal, window)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_fwd_reference(q, k, v, causal=causal,
                                             scale=scale, window=window,
                                             softcap=softcap)
    if not (q.device.type == "cuda" and q.device == k.device == v.device):
        raise ValueError(
            f"q/k/v must share one CUDA device (or all be on the CPU), got "
            f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"the kernel takes bfloat16 or float32 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, lq, h, d = q.shape
    lk, hk = k.shape[1], k.shape[2]
    if k.shape != (b, lk, hk, d) or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel "
                         f"(supported: {HEAD_DIMS})")
    if h % hk:
        raise ValueError(f"q heads {h} not divisible by kv heads {hk}")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    fn = _library().flash_attention_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *out.stride()[:3], b, lq, lk, h, hk, d,
                 _DTYPES[q.dtype], int(causal), int(window or 0),
                 float(softcap or 0.0), float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return out, lse
