"""Transformer layer primitives, forward only: RMSNorm, LayerNorm, rotary
embeddings, SwiGLU (twin of ``ray_tpu/ops/layers.py``).

Norms and the rotation compute in float32 and cast back to the input dtype,
as the reference does. The bf16-residual backward rules come with training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 accumulation regardless of input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 accumulation."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def rotary_embedding(positions: torch.Tensor, head_dim: int, *,
                     theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for RoPE. positions: [..., L] int; returns [..., L, D/2]."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=positions.device) / head_dim))
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Apply RoPE (half-split rotation). x: [B, L, H, D]; cos/sin:
    [B, L, D/2] (per-row positions, the paged step) or [L, D/2]."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :]  # [B, L, 1, D/2]
    sin = sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x @ w_gate) * (x @ w_up) @ w_down."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
