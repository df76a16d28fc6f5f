"""Decoder-only transformer: plain functions over a parameter dict (twin of
``ray_tpu/models/transformer.py``): init, the forward, the loss, the dense
decode steps (full-length or ring cache) with ``generate``, and the paged
decode and verify steps with the KV-block copy, gather and scatter.

- Parameters are a dict of tensors with the JAX package's keys and layouts,
  layers stacked on a leading dim (``wq`` [L, d, h, hd], ``wo`` [L, h, hd, d],
  ...), so weights move across 1:1 (:mod:`ray_tpu_torch.models.convert`).
- The layer stack is a Python loop over that leading dim; each layer's
  window is a Python int, so the kernel sees it as a plain argument.
- Weights stay in ``param_dtype`` and are cast to ``dtype`` at each use
  (free when the two agree); norms, softmax and logits accumulate in f32.
- Full-sequence attention goes through ``ops.attention.flash_attention``:
  the Hopper kernels on CUDA tensors, the blockwise plain version on CPU.
  The decode steps attend with a dense softmax over their cache (the paged
  one over a gathered context), as the reference does; they update the
  cache in place, where the reference returns a new one.
- The serving steps (``decode_step_multi``, the paged steps, the block
  copy, gather and scatter) are static in shape and never wait for the
  device, so the engine can capture each as a CUDA graph.
- Training differentiates :func:`loss_and_metrics` with autograd. Under
  ``config.remat`` each layer runs under ``torch.utils.checkpoint`` and is
  recomputed in the backward pass: with ``remat_policy="full"`` the flash
  forward kernel runs twice a layer and step, with ``"save_attn"`` once
  (its out and lse are saved).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch import config as _knobs
from ray_tpu_torch._device import Device, resolve_device
from ray_tpu_torch.models.config import TransformerConfig
from ray_tpu_torch.ops.attention import (NEG_INF, SAVE_ATTN_OP, _repeat_kv,
                                         _softcap_scores, flash_attention,
                                         naive_attention)
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

def _layer_params(params: Params) -> List[Params]:
    """One dict of views a layer, from one ``unbind`` of each stacked
    tensor: its backward stacks the layers' grads once, where indexing
    layer by layer would fill and add a zero tensor the size of the whole
    stack for every layer (traffic quadratic in depth)."""
    keys = list(params["layers"])
    return [dict(zip(keys, views)) for views in
            zip(*(params["layers"][k].unbind(0) for k in keys))]


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


class _HeadF32(torch.autograd.Function):
    """``x @ head`` in the compute dtype, leaving as its float32
    accumulator (CUDA only: ``torch.mm`` with ``out_dtype`` has no autograd
    rule). The backward is the reference einsum's: the cotangent is
    rounded to the compute dtype and both products run in it."""

    @staticmethod
    def forward(ctx, x, head):
        ctx.save_for_backward(x, head)
        return torch.mm(x, head, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, head = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ head.T if ctx.needs_input_grad[0] else None
        dhead = x.T @ g if ctx.needs_input_grad[1] else None
        return dx, dhead


def _head_logits(x, head, c, softcap: bool = True):
    """LM head in float32: the product accumulates in f32 and its logits
    leave in f32. (The JAX einsum rounds them to ``dtype`` first; in bf16
    that spaces the top logits of a 128k vocab 2**-5 apart, so greedy
    argmax ties become common.) Identical to the reference in float32.
    ``softcap=False`` skips the config's ``logits_softcap``, as the
    reference's ``decode_step`` does."""
    if x.is_cuda and x.dtype != torch.float32:
        logits = _HeadF32.apply(x.reshape(-1, x.shape[-1]),
                                head).unflatten(0, x.shape[:-1])
    else:  # the CPU has no reduced-precision GEMM with an f32 output
        logits = x.float() @ head.float()
    if softcap and c.logits_softcap:
        logits = torch.tanh(logits / c.logits_softcap) * c.logits_softcap
    return logits


def _logits(x, params, c):
    return _head_logits(x, _lm_head(params, c), c)


def _layer(x, lp, c: TransformerConfig, cos, sin, window: int, q_block: int,
           kv_block: int):
    """One pre-norm decoder layer: attention then MLP, each with its
    residual."""
    dt = torch_dtype(c.dtype)
    h = _norm(x, lp["attn_norm"], lp.get("attn_norm_b"), c)
    q, k, v = _qkv_proj(h, lp, dt)
    if cos is not None:
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    o = flash_attention(q, k, v, causal=True, q_block=q_block,
                        kv_block=kv_block, window=window or None,
                        softcap=c.attn_softcap)
    x = x + _out_proj(o, lp, dt)
    return _decode_mlp(x, lp, c, dt)


def _save_attn_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing: save the attention forward's out and lse,
    recompute everything else (norms, projections, rotary, MLP)."""
    if op is SAVE_ATTN_OP:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_attn_context():
    return create_selective_checkpoint_contexts(_save_attn_policy)


def _remat_wrap(layer_fn: Callable, c: TransformerConfig) -> Callable:
    """Apply the config's rematerialization choice to the layer body:
    ``remat_policy="full"`` saves only the layer's inputs and recomputes
    the layer in the backward pass; ``"save_attn"`` also keeps the
    attention forward's out and lse (the reference saves the named
    ``attn_out``; the port's backward kernels read the lse too), so the
    recompute rebuilds q, k and v but does not run attention again: one
    forward attention a layer a step instead of two. Outside autograd it
    changes nothing."""
    if not c.remat:
        return layer_fn
    kw = ({"context_fn": _save_attn_context}
          if c.remat_policy == "save_attn" else {})

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return layer_fn(*args)
        return checkpoint(layer_fn, *args, use_reentrant=False, **kw)
    return wrapped


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
    layer = _remat_wrap(_layer, c)
    for lp, window in zip(_layer_params(params), c.layer_windows):
        x = layer(x, lp, c, cos, sin, window, q_block, kv_block)
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
# Loss
# ---------------------------------------------------------------------------

def loss_and_metrics(params: Params, batch: Dict[str, Any],
                     config: TransformerConfig
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy. batch: {"tokens": [B, L]} (optionally
    with "mask") or explicit {"inputs", "targets", "mask"}. Returns the
    loss (plus ``z_loss`` times the mean squared log-normalizer when set)
    and metrics {"loss", "ntokens", "perplexity"} (+ "z_loss"), where
    "loss" is the cross entropy alone, as in the reference."""
    dev = params["embed"].device
    if "inputs" in batch:
        inputs, targets = batch["inputs"], batch["targets"]
        mask = batch.get("mask")
    else:
        toks = batch["tokens"]
        inputs, targets = toks[:, :-1], toks[:, 1:]
        mask = batch.get("mask")
        if mask is not None:
            mask = mask[:, 1:]
    inputs = torch.as_tensor(inputs, device=dev).long()
    targets = torch.as_tensor(targets, device=dev).long()
    mask = (torch.ones(targets.shape, dtype=torch.float32, device=dev)
            if mask is None
            else torch.as_tensor(mask, device=dev).to(torch.float32))

    C = config.loss_chunk
    if C and targets.shape[1] > C:
        nll_sum, z_sum = _chunked_xent(params, inputs, targets, mask, config)
    else:
        logits, _ = forward(params, inputs, config)
        nll_sum, z_sum = _xent_sums(logits, targets, mask, config)
    ntokens = mask.sum()
    denom = ntokens.clamp(min=1.0)
    loss = nll_sum / denom
    metrics = {"loss": loss, "ntokens": ntokens}
    if config.z_loss:
        zl = config.z_loss * z_sum / denom
        loss = loss + zl
        metrics["z_loss"] = zl
    metrics["perplexity"] = torch.exp(metrics["loss"].clamp(max=20.0))
    return loss, metrics


def _xent_sums(logits, targets, mask, c: TransformerConfig):
    """(masked sum of -log p(target), masked sum of logz**2 or None)."""
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    nll = ((logz - tgt) * mask).sum()
    return nll, (((logz ** 2) * mask).sum() if c.z_loss else None)


def _chunked_xent(params, inputs, targets, mask, c: TransformerConfig):
    """Blockwise LM head + cross entropy over ``c.loss_chunk``-token
    chunks, each under ``checkpoint``: only one chunk's [B, C, V] float32
    logits are live at a time, and the backward recomputes them from the
    features. Sequences that do not divide by the chunk are padded with
    mask-0 positions (never a dense fallback: that would bring back the
    buffer the caller asked to avoid)."""
    x = forward_features(params, inputs, c)
    head = _lm_head(params, c)
    pad = (-targets.shape[1]) % c.loss_chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))

    def chunk(xc, tc, mc, head):
        return _xent_sums(_head_logits(xc, head, c), tc, mc, c)

    nll_sum = z_sum = None
    for i in range(x.shape[1] // c.loss_chunk):
        cols = slice(i * c.loss_chunk, (i + 1) * c.loss_chunk)
        args = (x[:, cols], targets[:, cols], mask[:, cols], head)
        nll, z = (checkpoint(chunk, *args, use_reentrant=False)
                  if torch.is_grad_enabled() else chunk(*args))
        nll_sum = nll if nll_sum is None else nll_sum + nll
        if z is not None:
            z_sum = z if z_sum is None else z_sum + z
    return nll_sum, z_sum


# ---------------------------------------------------------------------------
# Dense decode: the KV cache of ``generate`` and of the dense engine
# ---------------------------------------------------------------------------

_GLOBAL = 1 << 30  # the window of a global layer: beyond any position


def _embed_at(params: Params, tokens: torch.Tensor, positions: torch.Tensor,
              c: TransformerConfig):
    """Token embeddings (+ learned positions) in the compute dtype, and the
    rotary tables at ``positions`` (None without rope)."""
    x = params["embed"][tokens].to(torch_dtype(c.dtype))
    if c.positions == "learned":
        x = x + params["pos_embed"][positions].to(x.dtype)
    if c.positions == "rope":
        return x, rotary_embedding(positions, c.hdim, theta=c.rope_theta)
    return x, (None, None)


def init_cache(config: TransformerConfig, batch: int, max_len: int,
               dtype=None, rolling: Optional[bool] = None, *,
               device: Optional[Device] = None) -> Params:
    """KV cache for :func:`decode_step`, [n_layers, batch, length, kv_heads,
    hd] per tensor. With one window shared by every layer and smaller than
    ``max_len`` it is a RING of ``window`` slots, so memory stays O(window)
    however long generation runs; ``rolling=False`` forces the full-length
    layout, ``rolling=True`` the ring (which needs one shared window).
    ``pos`` (tokens cached so far) is a host int, where the reference keeps
    a device scalar."""
    c = config
    uniform = c.uniform_window
    if rolling and not uniform:
        raise ValueError(
            "ring KV layout requires ONE window shared by all layers; "
            f"this config's pattern is {c.window_pattern} (0 = global / "
            "mixed) — use rolling=False (full-length cache)")
    use_ring = (bool(uniform) and uniform < max_len
                if rolling is None else rolling)
    length = uniform if use_ring else max_len
    dt = torch_dtype(dtype or c.dtype)
    dev = resolve_device(device)
    shape = (c.n_layers, batch, length, c.kv_heads, c.hdim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev), "pos": 0}


def decode_step(params: Params, cache: Params, tokens: torch.Tensor,
                config: TransformerConfig) -> Tuple[torch.Tensor, Params]:
    """Append ``tokens`` [B, T] (a prompt chunk or one token) to the cache
    and return (logits [B, T, V] f32, cache); the cache is updated in place.

    The full-length layout writes the chunk at ``pos`` and attends with
    each layer's own window. The ring layout (a cache of exactly the shared
    window) keeps position p in slot p % W: one token is written, then
    attends; a chunk attends over the old ring and its own keys BEFORE it
    is written, because a key that the end of the chunk evicts can still be
    in the window of its early queries. The logits skip ``logits_softcap``,
    as the reference's ``decode_step`` does (its other steps apply it)."""
    c = config
    _check_supported(c)
    dt = torch_dtype(c.dtype)
    dev = cache["k"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    t = tokens.shape[1]
    pos0 = int(cache["pos"])
    cache_len = cache["k"].shape[2]
    uniform = c.uniform_window
    is_ring = bool(uniform) and cache_len == uniform
    if is_ring and t > cache_len:
        raise ValueError(
            f"prefill chunk {t} exceeds the ring cache ({cache_len}); "
            "feed the prompt in <=window chunks or init_cache(..., "
            "rolling=False)")
    if not is_ring and pos0 + t > cache_len:
        raise ValueError(f"{pos0} cached + {t} new tokens exceed the cache "
                         f"({cache_len} positions)")
    positions = pos0 + torch.arange(t, device=dev)
    x, (cos, sin) = _embed_at(params, tokens, positions, c)
    slots = torch.arange(cache_len, device=dev)
    if is_ring and t == 1:
        slot = pos0 % cache_len
        # slot j holds the largest position = j (mod W) written so far
        # (negative: not filled yet, masked)
        k_pos = pos0 - (slot - slots) % cache_len
    elif is_ring:
        prev = pos0 - 1
        k_pos = torch.cat([prev - (prev % cache_len - slots) % cache_len,
                           positions])
    for i, (lp, w) in enumerate(zip(_layer_params(params), c.layer_windows)):
        h = _norm(x, lp["attn_norm"], lp.get("attn_norm_b"), c)
        q, k, v = _qkv_proj(h, lp, dt)
        if cos is not None:
            q = apply_rotary(q, cos, sin)
            k = apply_rotary(k, cos, sin)
        kc, vc = cache["k"][i], cache["v"][i]  # views: writes land in place
        k, v = k.to(kc.dtype), v.to(vc.dtype)
        if is_ring and t == 1:
            # the slot held pos0 - W, outside this query's window: write
            # first, then attend
            kc[:, slot] = k[:, 0]
            vc[:, slot] = v[:, 0]
            o = naive_attention(q, kc, vc, causal=True, q_offset=pos0,
                                window=uniform, k_positions=k_pos,
                                softcap=c.attn_softcap)
        elif is_ring:
            o = naive_attention(q, torch.cat([kc, k], 1),
                                torch.cat([vc, v], 1), causal=True,
                                q_offset=pos0, window=uniform,
                                k_positions=k_pos, softcap=c.attn_softcap)
            kc[:, positions % cache_len] = k
            vc[:, positions % cache_len] = v
        else:
            kc[:, pos0:pos0 + t] = k
            vc[:, pos0:pos0 + t] = v
            o = naive_attention(q, kc, vc, causal=True, q_offset=pos0,
                                window=w or _GLOBAL, softcap=c.attn_softcap)
        x = x + _out_proj(o, lp, dt)
        x = _decode_mlp(x, lp, c, dt)
    x = _norm(x, params["final_norm"], params.get("final_norm_b"), c)
    cache["pos"] = pos0 + t
    return _head_logits(x, _lm_head(params, c), c, softcap=False), cache


def init_cache_multi(config: TransformerConfig, n_slots: int, max_len: int,
                     dtype=None, *, device: Optional[Device] = None) -> Params:
    """Per-slot KV cache for :func:`decode_step_multi` (continuous
    batching): the full-length layout with ``pos`` a [n_slots] int64
    tensor, each slot an independent request at its own depth."""
    c = config
    dt = torch_dtype(dtype or c.dtype)
    dev = resolve_device(device)
    shape = (c.n_layers, n_slots, max_len, c.kv_heads, c.hdim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "pos": torch.zeros(n_slots, dtype=torch.int64, device=dev)}


def decode_step_multi(params: Params, cache: Params, tokens: torch.Tensor,
                      config: TransformerConfig,
                      active: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Params]:
    """One decode step for B independent sequences at per-slot positions
    ``cache["pos"]`` [B]: tokens [B, 1] -> (logits [B, V] f32 of each row's
    new token, cache), the cache (``pos`` included) updated in place. Rows
    where ``active`` is False (parked slots) keep their cache and position.
    Static in shape, as the reference's ``where`` form is: every row
    writes its slot at ``pos``, a parked row (or one past the cache, whose
    write the reference drops) the value the slot already holds, so the
    step never waits for the device and can be captured in a CUDA graph.
    Per-layer windows as in :func:`decode_step`."""
    c = config
    _check_supported(c)
    dt = torch_dtype(c.dtype)
    dev = cache["k"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    b = tokens.shape[0]
    pos = cache["pos"]
    cache_len = cache["k"].shape[2]
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=dev)
    active = torch.as_tensor(active, dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    at = pos.clamp(max=cache_len - 1)
    keep = (active & (pos < cache_len))[:, None, None]
    x, (cos, sin) = _embed_at(params, tokens[:, :1], pos[:, None], c)
    kpos = torch.arange(cache_len, device=dev)[None, :]
    scale = c.hdim ** -0.5
    for i, (lp, w) in enumerate(zip(_layer_params(params), c.layer_windows)):
        h = _norm(x, lp["attn_norm"], lp.get("attn_norm_b"), c)
        q, k, v = _qkv_proj(h, lp, dt)
        if cos is not None:
            q = apply_rotary(q, cos, sin)
            k = apply_rotary(k, cos, sin)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[rows, at] = torch.where(keep, k[:, 0].to(kc.dtype), kc[rows, at])
        vc[rows, at] = torch.where(keep, v[:, 0].to(vc.dtype), vc[rows, at])
        kx = _repeat_kv(kc, c.n_heads)
        vx = _repeat_kv(vc, c.n_heads)
        s = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), kx.float()) * scale
        s = _softcap_scores(s, c.attn_softcap)
        vis = (kpos <= pos[:, None]) & (kpos > pos[:, None] - (w or _GLOBAL))
        s = torch.where(vis[:, None, :], s, NEG_INF)
        o = torch.einsum("bhk,bkhd->bhd", torch.softmax(s, dim=-1),
                         vx.float()).to(dt)[:, None]
        x = x + _out_proj(o, lp, dt)
        x = _decode_mlp(x, lp, c, dt)
    x = _norm(x, params["final_norm"], params.get("final_norm_b"), c)
    pos.add_(active.to(pos.dtype))
    return _logits(x[:, 0], params, c), cache


def generate(params: Params, prompt: torch.Tensor, config: TransformerConfig,
             *, max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None) -> torch.Tensor:
    """Greedy (``temperature <= 0``) or temperature sampling from a
    ``torch.Generator`` on the params' device (seed 0 when none is given,
    as the reference's default key). prompt: [B, P] -> [B, P +
    max_new_tokens], on the params' device. With the ring cache a prompt
    longer than the window is prefilled in window-sized chunks, so memory
    stays O(window)."""
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, p = prompt.shape
    total = max_len or min(config.max_seq_len, p + max_new_tokens)
    cache = init_cache(config, b, total, device=dev)
    w = config.uniform_window
    chunk = w if w and cache["k"].shape[2] == w and p > w else p
    for i in range(0, p, chunk):
        logits, cache = decode_step(params, cache, prompt[:, i:i + chunk],
                                    config)
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    out = [prompt]
    for n in range(max_new_tokens):
        last = logits[:, -1]
        if temperature <= 0.0:
            tok = last.argmax(dim=-1)
        else:
            tok = torch.multinomial(torch.softmax(last / temperature, dim=-1),
                                    1, generator=generator)[:, 0]
        out.append(tok[:, None])
        if n + 1 < max_new_tokens:  # the last token is never fed
            logits, cache = decode_step(params, cache, tok[:, None], config)
    return torch.cat(out, dim=1)


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


def _block_ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, device=device).long().reshape(-1)


def copy_kv_block(cache: Params, src, dst) -> Params:
    """Copy one physical block (all layers) — the device half of
    copy-on-write. ``src`` and ``dst`` are ints or one-element int tensors
    on the cache's device (tensors keep a captured copy free of its
    operands). In place: torch tensors are mutable, so no new pool is made
    (the JAX version returns an updated copy and donates the old)."""
    dev = cache["k"].device
    src, dst = _block_ids(src, dev), _block_ids(dst, dev)
    for name in ("k", "v"):
        cache[name].index_copy_(1, dst, cache[name].index_select(1, src))
    return cache


def gather_kv_blocks(cache: Params, block_ids) -> Params:
    """Gather a request's physical blocks out of the paged pool ([L, n,
    bs, kvh, hd] per tensor, contiguous) — the device half of KV-block
    export for disaggregated prefill / decode."""
    ids = _block_ids(block_ids, cache["k"].device)
    return {"k": cache["k"].index_select(1, ids),
            "v": cache["v"].index_select(1, ids)}


def _first_valid(valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(index of each row's donor: itself where ``valid``, else the first
    valid row; whether any row is valid) — without leaving the device."""
    first = valid.long().argmax()
    rows = torch.arange(valid.shape[0], device=valid.device)
    return torch.where(valid, rows, first), valid.any()


def scatter_kv_blocks(cache: Params, block_ids, kv: Params) -> Params:
    """Scatter a shipped block batch ([L, n, bs, kvh, hd] per tensor, as
    :func:`gather_kv_blocks` gives it) into this pool's blocks
    ``block_ids``, in place — the device half of KV-block adoption. Ids
    outside the pool write nothing, as the reference's dropped scatter: the
    engine pads a batch to a power-of-two bucket with the id
    ``num_blocks``. Static in shape: a padded entry rewrites the first real
    entry's block with that entry's payload (with no real entry at all,
    block 0 with what it holds), so the write never waits for the
    device."""
    n = cache["k"].shape[1]
    ids = _block_ids(block_ids, cache["k"].device)
    src, any_valid = _first_valid((ids >= 0) & (ids < n))
    dest = torch.where(any_valid, ids[src], 0)
    for name in ("k", "v"):
        pool = cache[name]
        new = kv[name].to(pool.device, pool.dtype).index_select(1, src)
        pool.index_copy_(1, dest, torch.where(any_valid, new,
                                              pool.index_select(1, dest)))
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
    how many of this step's C tokens are real. Only valid rows change the
    cache, so padding touches nothing. Returns (logits [B, V] of each row's
    LAST VALID token, cache) — the cache is updated in place."""
    return _step_paged_impl(params, cache, tokens, block_tables, pos, nvalid,
                            config, active, all_logits=False)


def verify_step_paged(params: Params, cache: Params, tokens: torch.Tensor,
                      block_tables: torch.Tensor, pos: torch.Tensor,
                      nvalid: torch.Tensor, config: TransformerConfig,
                      active: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Params]:
    """The speculative-decoding verify twin of :func:`decode_step_paged`:
    the same cache semantics and masking, but logits [B, C, V] f32 for
    EVERY fed position (``logits_softcap`` applied). Feeding ``[last, d1..
    dk]`` verifies a k-token draft in one call: logits[:, i] is the
    target's distribution after input i. Logits at invalid positions are
    garbage; the caller masks them with ``nvalid``."""
    return _step_paged_impl(params, cache, tokens, block_tables, pos, nvalid,
                            config, active, all_logits=True)


def _step_paged_impl(params, cache, tokens, block_tables, pos, nvalid,
                     config: TransformerConfig, active=None, *,
                     all_logits: bool = False):
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
    # physical row of each new token; lookups clipped to the table width
    blk = torch.gather(block_tables, 1, (positions // bs).clamp(0, m - 1))
    dest = (blk * bs + positions % bs).reshape(-1)
    # The reference scatters invalid rows out of bounds for XLA to drop;
    # torch would fault, and selecting the valid rows would wait for the
    # device. So every row writes, in a shape fixed by [B, C]: an invalid
    # row takes the first valid row's destination and value (the same
    # bytes to the same place), and with no valid row at all every row
    # rewrites row dest[0] with what it holds.
    src, any_valid = _first_valid(valid)
    dest = dest[src]
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
    for i, (lp, w) in enumerate(zip(_layer_params(params), c.layer_windows)):
        wl = w if w > 0 else 1 << 30
        h = _norm(x, lp["attn_norm"], lp.get("attn_norm_b"), c)
        q, k, v = _qkv_proj(h, lp, dt)
        if cos is not None:
            q = apply_rotary(q, cos, sin)
            k = apply_rotary(k, cos, sin)
        # write BEFORE gathering: queries at chunk offset j must see the
        # chunk's own earlier keys. The views alias the pool: in place.
        kcf = cache["k"][i].view(n_blocks * bs, *cache["k"].shape[3:])
        vcf = cache["v"][i].view(n_blocks * bs, *cache["v"].shape[3:])
        for new, flat in ((k, kcf), (v, vcf)):
            rows = new.reshape(b * t, *new.shape[2:]).to(flat.dtype)[src]
            flat[dest] = torch.where(any_valid, rows, flat[dest])
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
    if all_logits:
        # verify: the accept check needs a distribution at every position
        return _logits(x, params, c), cache
    # only each row's last valid position needs logits: project B rows,
    # not B*C
    last = (nvalid - 1).clamp(0, t - 1)
    x_last = x[torch.arange(b, device=dev), last]
    return _logits(x_last, params, c), cache
