"""Hopper flash attention: the counterpart of ``ray_tpu/ops/flash_pallas.py``.

The kernels live in ``ops/csrc/flash_fwd.cu`` (forward) and
``ops/csrc/flash_bwd.cu`` (dQ and dK/dV), CUDA C++ for ``sm_90a``, built at
first use and loaded with ctypes.

- :func:`flash_attention_fwd` takes the same arguments and layouts as
  ``flash_attention_pallas_fwd``: q ``[B, Lq, H, D]``, k/v
  ``[B, Lk, Hk, D]`` with ``H % Hk == 0``; it returns ``out``
  ``[B, Lq, H, D]`` in q's dtype and ``lse`` ``[B, H, Lq]`` float32.
- :func:`flash_attention_bwd` takes those plus ``out``, ``lse`` and
  ``dout``, as ``flash_attention_pallas_bwd`` does, and returns
  ``(dq, dk, dv)`` with dk/dv at the native kv-head count.

Both take head dims 64, 128 and 256 (Gemma-2's), in bfloat16 or float32.

Ragged lengths are masked inside the kernels. For CPU tensors each wrapper
computes its plain PyTorch version (``*_reference``); for CUDA tensors it
launches its kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.attention import (_mha_bwd_gqa, _mha_fwd_blockwise,
                                         _repeat_kv)

#: kernel launches by :func:`flash_attention_fwd` (callers reset it to 0)
launches = 0
#: dK/dV and dQ kernel launches by :func:`flash_attention_bwd`
launches_dkv = 0
launches_dq = 0

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
#: head dims the forward kernel takes, and the backward kernels
FWD_HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = (64, 128, 256)
_BWD_ARGS = ([ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64)]
             + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
# C entry points of each source: argument types
_SIGNATURES = {
    "flash_fwd": {"flash_attention_fwd": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 12 + [ctypes.c_int] * 9
        + [ctypes.c_float] * 2 + [ctypes.c_void_p])},
    "flash_bwd": {"flash_attention_bwd_dq": _BWD_ARGS,
                  "flash_attention_bwd_dkv": _BWD_ARGS},
}
_libs: Dict[str, ctypes.CDLL] = {}


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
    bq, bk = _reference_blocks(lq, lk)
    return _mha_fwd_blockwise(q, _repeat_kv(k, h), _repeat_kv(v, h), causal,
                              scale, bq, bk, window or None, softcap=softcap)


def _reference_blocks(lq: int, lk: int) -> Tuple[int, int]:
    """512 tiles, or one tile per sequence when 512 does not divide it, as
    the TPU wrapper does."""
    bq, bk = min(512, lq), min(512, lk)
    if lq % bq or lk % bk:
        return lq, lk
    return bq, bk


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' plain version: ``_mha_bwd_blockwise`` in
    float32 with GQA expanded and each group's dk/dv summed back, on the
    forward reference's tiles; grads come back in the inputs' dtypes."""
    _require_causal_window(causal, window)
    lq, h, d = q.shape[1], q.shape[2], q.shape[3]
    lk, hk = k.shape[1], k.shape[2]
    if h % hk:
        raise ValueError(f"q heads {h} not divisible by kv heads {hk}")
    scale = scale if scale is not None else d ** -0.5
    bq, bk = _reference_blocks(lq, lk)
    return _mha_bwd_gqa(q, k, v, out, lse, dout, causal, scale, bq, bk,
                        window or None, softcap)


def _library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its entry points'
    argument types set."""
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def _check_launch(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed (cudaError {err})")


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         head_dims: Tuple[int, ...]
                         ) -> Tuple[int, int, int, int]:
    """What a kernel takes: q/k/v on one CUDA device, bfloat16 or float32
    alike, [B, L, H, D] / [B, L, Hk, D] with H % Hk == 0 and D in
    ``head_dims``. Returns (B, Lq, H, D)."""
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
    if d not in head_dims:
        raise ValueError(f"head dim {d} not supported by the kernel "
                         f"(supported: {head_dims})")
    if h % hk:
        raise ValueError(f"q heads {h} not divisible by kv heads {hk}")
    return b, lq, h, d


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """The kernels read 16-byte vectors, the bf16 ones through TMA: the
    last dim contiguous, the strides of the other dims positive multiples of
    8 elements (16 bytes of bf16), the base 16-byte aligned; copy when not.
    A dim of extent 1 never applies its stride, so any stride does there."""
    if (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and s % 8 == 0
                    for n, s in zip(t.shape[:3], t.stride()[:3]) if n > 1)):
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
    bfloat16 or float32 inputs (all three alike) and head dim 64, 128 or
    256; anything else raises.
    """
    global launches
    _require_causal_window(causal, window)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_fwd_reference(q, k, v, causal=causal,
                                             scale=scale, window=window,
                                             softcap=softcap)
    b, lq, h, d = _check_kernel_inputs(q, k, v, FWD_HEAD_DIMS)
    lk, hk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    fn = _library("flash_fwd").flash_attention_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *out.stride()[:3], b, lq, lk, h, hk, d,
                 _DTYPES[q.dtype], int(causal), int(window or 0),
                 float(softcap or 0.0), float(scale), stream)
    _check_launch(err, "flash_attention_fwd")
    launches += 1
    return out, lse


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash attention backward returning ``(dq, dk, dv)``; dk/dv at k's
    native kv-head count.

    CPU tensors: the plain version. CUDA tensors: the dQ kernel (which
    also writes D = rowsum(dO * O)) and then the dK/dV kernel, on the
    current stream, for bfloat16 or float32 q/k/v/out/dout (all alike),
    float32 lse ``[B, H, Lq]`` and head dim 64, 128 or 256; anything else
    raises. At head dim 256 the dK/dV kernel sweeps the q tiles twice
    (dV, then dK) in its one launch.
    """
    global launches_dkv, launches_dq
    _require_causal_window(causal, window)
    if all(t.device.type == "cpu" for t in (q, k, v, out, lse, dout)):
        return flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                             causal=causal, scale=scale,
                                             window=window, softcap=softcap)
    run_dq, run_dkv, grads = _bwd_launchers(q, k, v, out, lse, dout,
                                            causal=causal, scale=scale,
                                            window=window, softcap=softcap)
    if run_dq is not None:
        run_dq()
        launches_dq += 1
        run_dkv()
        launches_dkv += 1
    return grads


def _bwd_launchers(q, k, v, out, lse, dout, *, causal=True, scale=None,
                   window=None, softcap=0.0):
    """Check CUDA inputs and allocate the grads: ``(run_dq, run_dkv,
    (dq, dk, dv))``, the two kernel launches as callables to be run in
    that order (both None when a length is 0 and the grads are zeros)."""
    b, lq, h, d = _check_kernel_inputs(q, k, v, BWD_HEAD_DIMS)
    lk, hk = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} must match q ({tuple(q.shape)}, "
                             f"{q.dtype}, {q.device}), got {tuple(t.shape)}, "
                             f"{t.dtype}, {t.device}")
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (b, h, lq)):
        raise ValueError(f"lse must be float32 {(b, h, lq)} on {q.device}, "
                         f"got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    scale = scale if scale is not None else d ** -0.5
    if q.numel() == 0 or k.numel() == 0:
        return None, None, (torch.zeros_like(q), torch.zeros_like(k),
                            torch.zeros_like(v))
    dq = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, lk, hk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    q, k, v, out, dout = (_kernel_layout(t) for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    tensors = (q, k, v, out, dout, dq, dk, dv)
    ptrs = (ctypes.c_void_p * 10)(*(t.data_ptr() for t in (
        q, k, v, out, dout, lse, delta, dq, dk, dv)))
    strides = (ctypes.c_int64 * 24)(*(s for t in tensors
                                      for s in t.stride()[:3]))
    lib = _library("flash_bwd")
    args = (ptrs, strides, b, lq, lk, h, hk, d, _DTYPES[q.dtype],
            int(causal), int(window or 0), float(softcap or 0.0),
            float(scale))

    def launcher(fn_name):
        fn = getattr(lib, fn_name)

        def run():
            # the closure keeps the buffers that the pointers name alive
            with torch.cuda.device(q.device):
                stream = torch.cuda.current_stream(q.device).cuda_stream
                _check_launch(fn(*args, stream), fn_name)
            return tensors, lse, delta
        return run

    return (launcher("flash_attention_bwd_dq"),
            launcher("flash_attention_bwd_dkv"), (dq, dk, dv))
