"""Decoder-only transformer, inference half: plain functions over a parameter
dict (twin of ``ray_tpu/models/transformer.py``).

- Parameters are a dict of tensors with the JAX package's keys and layouts,
  layers stacked on a leading dim (``wq`` [L, d, h, hd], ``wo`` [L, h, hd, d],
  ...), so weights move across 1:1 (:mod:`ray_tpu_torch.models.convert`).
- The layer stack is a Python loop over that leading dim; each layer's
  window is a Python int, so the kernel sees it as a plain argument.
- Weights stay in ``param_dtype`` and are cast to ``dtype`` at each use
  (free when the two agree); norms, softmax and logits accumulate in f32.
- Full-sequence attention goes through ``ops.attention.flash_attention``:
  the Hopper kernel on CUDA tensors, the blockwise plain version on CPU.
  The paged serving step gathers its context and runs a dense softmax, as
  the reference does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch import config as _knobs
from ray_tpu_torch._device import Device, resolve_device
from ray_tpu_torch.models.config import TransformerConfig
from ray_tpu_torch.ops.attention import (NEG_INF, _repeat_kv, _softcap_scores,
                                         flash_attention)
from ray_tpu_torch.ops.layers import (apply_rotary, layer_norm, rms_norm,
                                      rotary_embedding)

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _check_supported(c: TransformerConfig) -> None:
    if c.num_experts:
        raise NotImplementedError(
            "MoE layers (num_experts > 0) are not ported yet")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, config: TransformerConfig, *,
                device: Optional[Device] = None) -> Params:
    """Initialize a parameter dict (layers stacked on a leading dim) from a
    seeded ``torch.Generator`` whose device matches ``device``. Same keys,
    shapes, dtypes and distributions as the JAX init (not the same values:
    the generators differ). Weights are drawn in float32 and stored in
    ``param_dtype`` one layer at a time, so peak memory stays near the
    stored size."""
    c = config
    _check_supported(c)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} cannot fill "
                         f"tensors on {dev}")
    pdt = torch_dtype(c.param_dtype)
    d, hd, f, L = c.d_model, c.hdim, c.ff, c.n_layers
    h, kv, v = c.n_heads, c.kv_heads, c.vocab_size

    def normal(shape, std, stacked=True):
        out = torch.empty(shape, dtype=pdt, device=dev)
        for part in (out if stacked else [out]):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   dtype=torch.float32, device=dev) * std)
        return out

    def const(shape, value):
        return torch.full(shape, value, dtype=pdt, device=dev)

    proj_std = d ** -0.5
    out_std = proj_std / (2 * L) ** 0.5  # GPT-2-style depth scaling
    layers: Params = {
        "attn_norm": const((L, d), 1.0),
        "wq": normal((L, d, h, hd), proj_std),
        "wk": normal((L, d, kv, hd), proj_std),
        "wv": normal((L, d, kv, hd), proj_std),
        "wo": normal((L, h, hd, d), out_std),
        "mlp_norm": const((L, d), 1.0),
    }
    if c.attn_qkv_bias:
        layers["bq"] = const((L, h, hd), 0.0)
        layers["bk"] = const((L, kv, hd), 0.0)
        layers["bv"] = const((L, kv, hd), 0.0)
    if c.norm == "layer":
        layers["attn_norm_b"] = const((L, d), 0.0)
        layers["mlp_norm_b"] = const((L, d), 0.0)
    if c.mlp == "swiglu":
        layers["w_gate"] = normal((L, d, f), proj_std)
        layers["w_up"] = normal((L, d, f), proj_std)
        layers["w_down"] = normal((L, f, d), out_std)
    else:  # gelu
        layers["w_in"] = normal((L, d, f), proj_std)
        layers["b_in"] = const((L, f), 0.0)
        layers["w_out"] = normal((L, f, d), out_std)
        layers["b_out"] = const((L, d), 0.0)

    params: Params = {
        "embed": normal((v, d), 0.02, stacked=False),
        "layers": layers,
        "final_norm": const((d,), 1.0),
    }
    if c.norm == "layer":
        params["final_norm_b"] = const((d,), 0.0)
    if c.positions == "learned":
        params["pos_embed"] = normal((c.max_seq_len, d), 0.02, stacked=False)
    if not c.tie_embeddings:
        params["lm_head"] = normal((d, v), proj_std, stacked=False)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer_params(params: Params, i: int) -> Params:
    return {k: a[i] for k, a in params["layers"].items()}


def _qkv_proj(h, lp, dt):
    """q/k/v projections (+ optional Qwen2-style qkv biases): [B, L, d] ->
    [B, L, heads, hd] each."""
    d = h.shape[-1]

    def proj(w):
        return (h @ w.to(dt).reshape(d, -1)).unflatten(-1, w.shape[1:])

    q, k, v = proj(lp["wq"]), proj(lp["wk"]), proj(lp["wv"])
    if "bq" in lp:
        q = q + lp["bq"].to(dt)
        k = k + lp["bk"].to(dt)
        v = v + lp["bv"].to(dt)
    return q, k, v


def _out_proj(o, lp, dt):
    """[B, L, h, hd] @ wo [h, hd, d] -> [B, L, d]."""
    wo = lp["wo"].to(dt)
    return o.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _norm(x, w, b, c):
    if c.norm == "rms":
        return rms_norm(x, w, eps=c.norm_eps or 1e-6)
    return layer_norm(x, w, b, eps=c.norm_eps or 1e-5)


def _decode_mlp(x, lp, c, dt):
    """Post-attention norm + MLP tail with its residual (the one definition
    shared by the full-sequence and paged paths)."""
    h = _norm(x, lp["mlp_norm"], lp.get("mlp_norm_b"), c)
    if c.mlp == "swiglu":
        g = F.silu(h @ lp["w_gate"].to(dt))
        m = (g * (h @ lp["w_up"].to(dt))) @ lp["w_down"].to(dt)
    else:
        hmid = F.gelu(h @ lp["w_in"].to(dt) + lp["b_in"].to(dt),
                      approximate="tanh")  # jax.nn.gelu's default
        m = hmid @ lp["w_out"].to(dt) + lp["b_out"].to(dt)
    return x + m


def _lm_head(params: Params, c: TransformerConfig) -> torch.Tensor:
    dt = torch_dtype(c.dtype)
    return (params["embed"].T if c.tie_embeddings
            else params["lm_head"]).to(dt)


def _logits(x, params, c):
    """LM head in float32: the product accumulates in f32 and its logits
    leave in f32. (The JAX einsum rounds them to ``dtype`` first; in bf16
    that spaces the top logits of a 128k vocab 2**-5 apart, so greedy
    argmax ties become common.) Identical to the reference in float32."""
    head = _lm_head(params, c)
    if x.is_cuda and x.dtype != torch.float32:
        logits = torch.mm(x.reshape(-1, x.shape[-1]), head,
                          out_dtype=torch.float32).unflatten(0, x.shape[:-1])
    else:  # the CPU has no reduced-precision GEMM with an f32 output
        logits = x.float() @ head.float()
    if c.logits_softcap:
        logits = torch.tanh(logits / c.logits_softcap) * c.logits_softcap
    return logits


def forward_features(params: Params, tokens: torch.Tensor,
                     config: TransformerConfig, *,
                     positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transformer stack up to and including the final norm: tokens [B, L]
    int -> features [B, L, D]. Layer i attends with window
    ``config.layer_windows[i]`` (0 = global), which covers both the uniform
    window and the per-layer alternating pattern."""
    c = config
    _check_supported(c)
    dt = torch_dtype(c.dtype)
    emb = params["embed"]
    tokens = tokens.to(emb.device)
    b, l = tokens.shape
    if positions is None:
        positions = torch.arange(l, device=emb.device)[None, :]
    x = emb[tokens].to(dt)
    if c.positions == "learned":
        x = x + params["pos_embed"][positions[0]].to(dt)[None]
    cos = sin = None
    if c.positions == "rope":
        cos, sin = rotary_embedding(positions[0], c.hdim, theta=c.rope_theta)
    q_block = int(_knobs.get("attn_block_q"))
    kv_block = int(_knobs.get("attn_block_k"))
    for i, window in enumerate(c.layer_windows):
        lp = _layer_params(params, i)
        h = _norm(x, lp["attn_norm"], lp.get("attn_norm_b"), c)
        q, k, v = _qkv_proj(h, lp, dt)
        if cos is not None:
            q = apply_rotary(q, cos, sin)
            k = apply_rotary(k, cos, sin)
        o = flash_attention(q, k, v, causal=True, q_block=q_block,
                            kv_block=kv_block, window=window or None,
                            softcap=c.attn_softcap)
        x = x + _out_proj(o, lp, dt)
        x = _decode_mlp(x, lp, c, dt)
    return _norm(x, params["final_norm"], params.get("final_norm_b"), c)


def forward(params: Params, tokens: torch.Tensor, config: TransformerConfig,
            *, positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. tokens: [B, L] int -> (logits [B, L, V] f32,
    moe_aux) — moe_aux is a zero scalar (dense models only), kept so the
    return matches the JAX ``forward``."""
    x = forward_features(params, tokens, config, positions=positions)
    return _logits(x, params, config), x.new_zeros((), dtype=torch.float32)


# ---------------------------------------------------------------------------
# Paged decode (the serving engine's step)
# ---------------------------------------------------------------------------

def init_cache_paged(config: TransformerConfig, num_blocks: int,
                     block_size: int, dtype=None, *,
                     device: Optional[Device] = None) -> Params:
    """Block-paged KV cache for :func:`decode_step_paged`: a pool of
    fixed-size token blocks shared by every request, [L, num_blocks,
    block_size, kv_heads, hd] per tensor. Positions and block ownership are
    host-side scheduler state (``serve.kv_cache``)."""
    c = config
    dt = torch_dtype(dtype or c.dtype)
    dev = resolve_device(device)
    shape = (c.n_layers, num_blocks, block_size, c.kv_heads, c.hdim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def copy_kv_block(cache: Params, src: int, dst: int) -> Params:
    """Copy one physical block (all layers) — the device half of
    copy-on-write. In place: torch tensors are mutable, so no new pool is
    made (the JAX version returns an updated copy and donates the old)."""
    cache["k"][:, dst] = cache["k"][:, src]
    cache["v"][:, dst] = cache["v"][:, src]
    return cache


def decode_step_paged(params: Params, cache: Params, tokens: torch.Tensor,
                      block_tables: torch.Tensor, pos: torch.Tensor,
                      nvalid: torch.Tensor, config: TransformerConfig,
                      active: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Params]:
    """Advance B independent requests by up to C tokens each against the
    block-paged cache — one step serves both chunked prefill (rows feeding
    C prompt tokens) and decode (rows feeding 1 token with C-1 padding).

    tokens: [B, C] int; block_tables: [B, M] int physical block ids
    (logical position p of request b lives in block ``block_tables[b, p //
    bs]`` at offset ``p % bs``; unused entries must hold a valid id — they
    are masked, never written). pos: [B] tokens already cached; nvalid: [B]
    how many of this step's C tokens are real. Only valid rows write, so
    padding touches nothing. Returns (logits [B, V] of each row's LAST
    VALID token, cache) — the cache is updated in place."""
    return _step_paged_impl(params, cache, tokens, block_tables, pos, nvalid,
                            config, active)


def _step_paged_impl(params, cache, tokens, block_tables, pos, nvalid,
                     config: TransformerConfig, active=None):
    c = config
    _check_supported(c)
    dt = torch_dtype(c.dtype)
    dev = cache["k"].device
    tokens, block_tables, pos, nvalid = (
        t.to(dev, torch.int64) for t in (tokens, block_tables, pos, nvalid))
    b, t = tokens.shape
    n_blocks, bs = cache["k"].shape[1], cache["k"].shape[2]
    m = block_tables.shape[1]
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=dev)
    active = active.to(dev, torch.bool)

    steps = torch.arange(t, device=dev)
    positions = pos[:, None] + steps[None, :]                        # [B, C]
    valid = ((steps[None, :] < nvalid[:, None]) & active[:, None]).reshape(-1)
    # physical row of each new token; lookups clipped to the table width.
    # Only valid rows are written: the reference scatters invalid rows out
    # of bounds for XLA to drop, torch would fault, so select them instead.
    blk = torch.gather(block_tables, 1, (positions // bs).clamp(0, m - 1))
    dest = (blk * bs + positions % bs).reshape(-1)[valid]
    # gather map: logical position j of request b = physical row gidx[b, j]
    gidx = (block_tables[:, :, None] * bs
            + torch.arange(bs, device=dev)[None, None, :]).reshape(b, m * bs)

    x = params["embed"][tokens].to(dt)                              # [B, C, D]
    if c.positions == "learned":
        # clamp ONLY the table lookup (padding rows can sit past the
        # table); rope uses the true positions
        x = x + params["pos_embed"][positions.clamp(0, c.max_seq_len - 1)].to(dt)
    cos = sin = None
    if c.positions == "rope":
        cos, sin = rotary_embedding(positions, c.hdim, theta=c.rope_theta)

    kpos = torch.arange(m * bs, device=dev)[None, None, :]          # [1, 1, Mbs]
    scale = c.hdim ** -0.5
    for i, w in enumerate(c.layer_windows):
        wl = w if w > 0 else 1 << 30
        lp = _layer_params(params, i)
        h = _norm(x, lp["attn_norm"], lp.get("attn_norm_b"), c)
        q, k, v = _qkv_proj(h, lp, dt)
        if cos is not None:
            q = apply_rotary(q, cos, sin)
            k = apply_rotary(k, cos, sin)
        # write BEFORE gathering: queries at chunk offset j must see the
        # chunk's own earlier keys. The views alias the pool: in place.
        kcf = cache["k"][i].view(n_blocks * bs, *cache["k"].shape[3:])
        vcf = cache["v"][i].view(n_blocks * bs, *cache["v"].shape[3:])
        kcf[dest] = k.reshape(b * t, *k.shape[2:])[valid].to(kcf.dtype)
        vcf[dest] = v.reshape(b * t, *v.shape[2:])[valid].to(vcf.dtype)
        kx = _repeat_kv(kcf[gidx], c.n_heads)                   # [B, Mbs, H, hd]
        vx = _repeat_kv(vcf[gidx], c.n_heads)
        s = torch.einsum("bchd,bkhd->bhck", q.float(), kx.float()) * scale
        s = _softcap_scores(s, c.attn_softcap)
        vis = (kpos <= positions[:, :, None]) & (kpos > positions[:, :, None] - wl)
        s = torch.where(vis[:, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhck,bkhd->bchd", p, vx.float()).to(dt)
        x = x + _out_proj(o, lp, dt)
        x = _decode_mlp(x, lp, c, dt)
    x = _norm(x, params["final_norm"], params.get("final_norm_b"), c)
    # only each row's last valid position needs logits: project B rows,
    # not B*C
    last = (nvalid - 1).clamp(0, t - 1)
    x_last = x[torch.arange(b, device=dev), last]
    return _logits(x_last, params, c), cache
