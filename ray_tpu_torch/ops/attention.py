"""Attention: naive reference, blockwise (flash-style) plain PyTorch version
with its backward, and the dispatching ``flash_attention`` (twin of
``ray_tpu/ops/attention.py``).

Shapes follow the JAX convention ``[batch, seq, heads, head_dim]``. Grouped
query attention (GQA) is supported: ``k``/``v`` may have fewer heads than
``q`` as long as ``q_heads % kv_heads == 0``; q head ``h`` reads kv head
``h // group``.

On CUDA tensors ``flash_attention`` runs the Hopper kernels of
:mod:`ray_tpu_torch.ops.flash_cuda` (forward, and dQ + dK/dV under
autograd) and nothing else; the blockwise and naive versions here serve CPU
tensors (the tests) and are the kernels' plain reference. Both
differentiable paths keep O(L) residuals: q, k and v at their native
kv-head count, out and lse, as the reference's ``_mha`` custom VJP does.

Both forwards go through one registered operator,
``torch.ops.ray_tpu_torch.attention_fwd`` (:func:`attention_fwd`, returning
out and lse), so that a selective-checkpoint policy can name it: under
``remat_policy="save_attn"`` the layer's recompute takes its saved out and
lse instead of running attention again (:data:`SAVE_ATTN_OP`).
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from ray_tpu_torch import config

NEG_INF = -1e30

# Process-wide pin for CPU tensors: "auto" | "blockwise" | "naive"
# (None -> RTPU_ATTN_IMPL or "auto"). CUDA tensors ignore it.
_ATTN_IMPL: Optional[str] = None


def set_default_attention_impl(impl: Optional[str]) -> None:
    """Pin the plain attention used for CPU tensors: "auto" | "blockwise" |
    "naive". ``None`` resets to the default (env ``RTPU_ATTN_IMPL`` or
    "auto"). CUDA tensors always run the kernel."""
    global _ATTN_IMPL
    if impl is not None and impl not in ("auto", "blockwise", "naive"):
        raise ValueError(f"unknown attention impl: {impl!r}")
    _ATTN_IMPL = impl


def resolve_attention_impl(device) -> str:
    """Concrete impl for tensors on ``device``: "cuda" | "blockwise" | "naive"."""
    if torch.device(device).type == "cuda":
        return "cuda"
    impl = _ATTN_IMPL or config.get("attn_impl") or "auto"
    return "naive" if impl == "naive" else "blockwise"


def _band_mask(qpos, kpos, causal, window):
    """[qb, kb] visibility mask for the causal/sliding-window band, or None.
    The one definition shared by the naive and blockwise paths; ``None``
    (not 0) means no window."""
    if not (causal or window is not None):
        return None
    mask = qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def _softcap_scores(s, softcap):
    """Attention-logit soft-capping (Gemma-2): ``cap * tanh(s / cap)``.
    Apply BEFORE masking — tanh(NEG_INF) would erase the mask value."""
    if not softcap:
        return s
    return softcap * torch.tanh(s / softcap)


def _softcap_dfactor(s_hat, softcap):
    """d(capped)/d(raw) = 1 - tanh^2 = 1 - (s_hat/cap)^2, from the CAPPED
    (unmasked) score — shared by every backward recompute."""
    return 1.0 - (s_hat / softcap).square()


def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """Expand kv heads to match q heads for GQA: each kv head repeated in
    place (q head h reads kv head h // group), as ``jnp.repeat`` does."""
    kv_heads = k.shape[2]
    if kv_heads == num_q_heads:
        return k
    if num_q_heads % kv_heads:
        raise ValueError(
            f"q heads {num_q_heads} not divisible by kv heads {kv_heads}")
    return k.repeat_interleave(num_q_heads // kv_heads, dim=2)


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    q_offset: int = 0,
    window: Optional[int] = None,
    k_offset: int = 0,
    k_positions: Optional[torch.Tensor] = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Materialized-scores attention; numerical reference for tests.

    ``q_offset`` shifts q's global positions; ``window`` limits each query
    to its last ``window`` keys; ``k_offset`` maps key slot j to global
    position k_offset + j, or ``k_positions`` gives each slot a position;
    negative key positions mean "slot not filled" and are masked. Window
    and key positions require ``causal``. ``softcap`` applies tanh capping.
    """
    if isinstance(window, int) and window <= 0:
        window = None
    has_koff = k_positions is not None or k_offset != 0
    if (window is not None or has_koff) and not causal:
        raise ValueError("window / ring key positions require causal attention")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    k = _repeat_kv(k, q.shape[2])
    v = _repeat_kv(v, q.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = _softcap_scores(scores, softcap)
    if causal or window is not None or has_koff:
        lq, lk = q.shape[1], k.shape[1]
        if k_positions is not None:
            k_pos = k_positions.to(q.device)
        else:
            k_pos = torch.arange(lk, device=q.device) + k_offset
        mask = _band_mask(torch.arange(lq, device=q.device)[:, None] + q_offset,
                          k_pos[None, :], causal, window)
        if has_koff:
            mask &= (k_pos >= 0)[None, :]
        scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def _attend_block(q, k, v, m, l, o, mask, scale, softcap=0.0):
    """One online-softmax update: q block vs one kv block.

    q: [B, qb, H, D]; k/v: [B, kb, H, D]; m, l: [B, H, qb]; o: [B, qb, H, D];
    mask: [qb, kb] bool or None. All float32.
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = _softcap_scores(s, softcap)
    if mask is not None:
        s = torch.where(mask[None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v)
    return m_new, l_new, o_new


def _n_live_kv_blocks(nk: int, q_block: int, kv_block: int, window) -> int:
    """Count of kv blocks a q block can see under the window band (every
    block without a window)."""
    if not window:
        return nk
    return min(nk, (q_block + window - 2) // kv_block + 2)


def _live_kv_start(qi: int, nk: int, n_live: int, q_block: int,
                   kv_block: int, window) -> int:
    """First live kv block for q block ``qi``, clamped so the run of
    ``n_live`` blocks stays in range (clamping only extends coverage)."""
    if not window:
        return 0
    start = (qi * q_block - (window - 1)) // kv_block
    return min(max(start, 0), nk - n_live)


def _mha_fwd_blockwise(q, k, v, causal, scale, q_block, kv_block,
                       window=None, softcap=0.0):
    """Blockwise forward returning (out, lse). Heads already expanded;
    ``q_block``/``kv_block`` divide Lq/Lk.

    With ``window`` only the live kv blocks per q block are visited. A
    visited block can still be fully masked for SOME rows: those rows take
    exp(NEG_INF - NEG_INF) = 1 fake mass per key, which the rescale
    alpha = exp(NEG_INF - m_finite) annihilates to exactly 0 at the first
    in-band block. This relies on NEG_INF being a large FINITE negative.
    """
    b, lq, h, d = q.shape
    lk = k.shape[1]
    nq, nk = lq // q_block, lk // kv_block
    qf, kf, vf = q.float(), k.float(), v.float()
    dev = q.device
    q_ids = torch.arange(q_block, device=dev)
    k_ids = torch.arange(kv_block, device=dev)
    n_live = _n_live_kv_blocks(nk, q_block, kv_block, window)
    out = torch.empty((b, lq, h, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=dev)
    for qi in range(nq):
        rows = slice(qi * q_block, (qi + 1) * q_block)
        m = torch.full((b, h, q_block), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, q_block), dtype=torch.float32, device=dev)
        o = torch.zeros((b, q_block, h, d), dtype=torch.float32, device=dev)
        start = _live_kv_start(qi, nk, n_live, q_block, kv_block, window)
        for ki in range(start, start + n_live):
            cols = slice(ki * kv_block, (ki + 1) * kv_block)
            mask = _band_mask(qi * q_block + q_ids[:, None],
                              ki * kv_block + k_ids[None, :], causal, window)
            m, l, o = _attend_block(qf[:, rows], kf[:, cols], vf[:, cols],
                                    m, l, o, mask, scale, softcap)
        lse[:, :, rows] = m + torch.log(torch.clamp(l, min=1e-30))
        out[:, rows] = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype), lse


def _mha_bwd_blockwise(causal, scale, q_block, kv_block, q, k, v, out, lse,
                       dout, window=None, softcap=0.0):
    """Blocked backward; recomputes p per (q block, kv block) pair. Heads
    already expanded; ``q_block``/``kv_block`` divide Lq/Lk. Visits the
    same live kv blocks as :func:`_mha_fwd_blockwise`. Returns float32
    ``(dq, dk, dv)``: the caller sums GQA groups before rounding."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    nq, nk = lq // q_block, lk // kv_block
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    dvec = (dof * out.float()).sum(-1).transpose(1, 2)  # D: [B, H, Lq]
    dev = q.device
    q_ids = torch.arange(q_block, device=dev)
    k_ids = torch.arange(kv_block, device=dev)
    n_live = _n_live_kv_blocks(nk, q_block, kv_block, window)
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    for qi in range(nq):
        rows = slice(qi * q_block, (qi + 1) * q_block)
        qb, dob = qf[:, rows], dof[:, rows]
        lseb, db = lse[:, :, rows, None], dvec[:, :, rows, None]
        start = _live_kv_start(qi, nk, n_live, q_block, kv_block, window)
        for ki in range(start, start + n_live):
            cols = slice(ki * kv_block, (ki + 1) * kv_block)
            kb, vb = kf[:, cols], vf[:, cols]
            s_hat = _softcap_scores(
                torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale, softcap)
            mask = _band_mask(qi * q_block + q_ids[:, None],
                              ki * kv_block + k_ids[None, :], causal, window)
            s = s_hat if mask is None else torch.where(mask[None, None],
                                                       s_hat, NEG_INF)
            # out-of-band keys: s = NEG_INF, lse finite -> p underflows to
            # exactly 0 (NEG_INF must stay a finite float for this)
            p = torch.exp(s - lseb)
            dp = torch.einsum("bqhd,bkhd->bhqk", dob, vb)
            ds = p * (dp - db)
            if softcap:
                # masked entries already have p = 0: the factor is harmless
                ds = ds * _softcap_dfactor(s_hat, softcap)
            dq[:, rows] += scale * torch.einsum("bhqk,bkhd->bqhd", ds, kb)
            dk[:, cols] += scale * torch.einsum("bhqk,bqhd->bkhd", ds, qb)
            dv[:, cols] += torch.einsum("bhqk,bqhd->bkhd", p, dob)
    return dq, dk, dv


def _mha_bwd_gqa(q, k, v, out, lse, dout, causal, scale, q_block, kv_block,
                 window=None, softcap=0.0):
    """:func:`_mha_bwd_blockwise` for k/v at their native kv-head count:
    expands them transiently, sums each group's dk/dv back in float32 and
    rounds to the input dtypes (the reference's ``_mha_bwd_rule`` XLA
    path, which sums after rounding)."""
    b, lk, hk, d = k.shape
    h = q.shape[2]
    dq, dk, dv = _mha_bwd_blockwise(causal, scale, q_block, kv_block, q,
                                    _repeat_kv(k, h), _repeat_kv(v, h), out,
                                    lse, dout, window, softcap)
    if hk != h:
        dk = dk.reshape(b, lk, hk, h // hk, d).sum(3)
        dv = dv.reshape(b, lk, hk, h // hk, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


#: calls of :func:`attention_fwd` (each one a forward attention: a launch
#: of kernel 1 on the card, the plain version on the CPU); callers reset it
fwd_calls = 0


@torch.library.custom_op("ray_tpu_torch::attention_fwd", mutates_args=())
def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, scale: float, window: Optional[int],
                  softcap: float, q_block: int,
                  kv_block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention forward as one operator: ``(out, lse)``. With
    ``q_block == 0`` it is the kernel wrapper's
    (:func:`~ray_tpu_torch.ops.flash_cuda.flash_attention_fwd`: the kernel
    on CUDA tensors, its plain version on CPU ones); otherwise the blockwise
    plain version on those tiles (CPU tensors)."""
    global fwd_calls
    fwd_calls += 1
    if q_block == 0:
        from ray_tpu_torch.ops.flash_cuda import flash_attention_fwd

        return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                   window=window, softcap=softcap)
    h = q.shape[2]
    return _mha_fwd_blockwise(q, _repeat_kv(k, h), _repeat_kv(v, h), causal,
                              scale, q_block, kv_block, window,
                              softcap=softcap)


@attention_fwd.register_fake
def _attention_fwd_fake(q, k, v, causal, scale, window, softcap, q_block,
                        kv_block):
    b, lq, h, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, lq), dtype=torch.float32))


#: the operator a ``save_attn`` checkpoint policy must save
SAVE_ATTN_OP = torch.ops.ray_tpu_torch.attention_fwd.default


def _grads_needed(ctx, grads):
    """(dq, dk, dv) as autograd wants them: None where no grad was asked."""
    return tuple(g if need else None
                 for g, need in zip(grads, ctx.needs_input_grad[:3]))


class _BlockwiseAttention(torch.autograd.Function):
    """The plain blockwise attention under autograd (CPU tensors): the
    forward keeps only q, k, v (native kv heads), out and lse; the backward
    recomputes p block by block."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_block, kv_block, window,
                softcap):
        out, lse = attention_fwd(q, k, v, causal, scale, window, softcap,
                                 q_block, kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, q_block, kv_block, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        if not any(ctx.needs_input_grad[:3]):
            return (None,) * 9
        grads = _mha_bwd_gqa(*ctx.saved_tensors, dout, *ctx.args)
        return _grads_needed(ctx, grads) + (None,) * 6


class _FlashAttention(torch.autograd.Function):
    """The kernels under autograd: the forward kernel saves q, k, v (native
    kv heads), out and lse; the backward runs the dQ and dK/dV kernels
    (both, whichever of dq/dk/dv is asked for: the dK/dV kernel reads the
    D = rowsum(dO * O) that the dQ kernel writes). On CPU tensors the
    kernel wrappers run their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, softcap):
        out, lse = attention_fwd(q, k, v, causal, scale, window, softcap,
                                 0, 0)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, scale=scale, window=window,
                        softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        from ray_tpu_torch.ops.flash_cuda import flash_attention_bwd

        if not any(ctx.needs_input_grad[:3]):
            return (None,) * 7
        grads = flash_attention_bwd(*ctx.saved_tensors, dout, **ctx.args)
        return _grads_needed(ctx, grads) + (None,) * 4


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    impl: str = "auto",
    q_block: int = 512,
    kv_block: int = 512,
    window: Optional[int] = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Dispatching entry point: the Hopper kernels for CUDA tensors, the
    blockwise plain version (or naive, when pinned) for CPU tensors. Both
    are differentiable with O(L) residuals; naive is plain autograd.

    ``impl``: ``auto`` | ``cuda`` | ``blockwise`` | ``naive``. A plain impl
    asked for on CUDA tensors, or the kernel on CPU tensors, raises: the
    card never runs the plain version in place of the kernel.
    ``window`` (sliding-window attention) requires ``causal``.
    """
    if window is not None:
        if not causal:
            raise ValueError("window requires causal attention")
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
    on_cuda = q.device.type == "cuda"
    if impl == "auto":
        impl = resolve_attention_impl(q.device)
    if impl not in ("cuda", "blockwise", "naive"):
        raise ValueError(f"unknown attention impl: {impl!r}")
    if on_cuda != (impl == "cuda"):
        raise ValueError(
            f"attention impl {impl!r} cannot run on {q.device.type} tensors: "
            "CUDA tensors run the kernel, CPU tensors a plain version")
    d = q.shape[-1]
    scale = d ** -0.5
    if impl == "cuda":
        return _FlashAttention.apply(q, k, v, causal, scale, window, softcap)
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    lq = q.shape[1]
    lk = k.shape[1]
    q_block = min(q_block, lq)
    kv_block = min(kv_block, lk)
    if lq % q_block or lk % kv_block:
        # Non-dividing tile knob: the largest divisor >= 128 (multiple of
        # 8) rather than naive's O(L^2) scores; genuinely ragged short
        # shapes still use naive.
        qb = next((x for x in range(q_block, 127, -1)
                   if lq % x == 0 and x % 8 == 0), 0)
        kb = next((x for x in range(kv_block, 127, -1)
                   if lk % x == 0 and x % 8 == 0), 0)
        if not (qb and kb):
            return naive_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
        warnings.warn(
            f"attention tile sizes (q={q_block}, kv={kv_block}) do not "
            f"divide seq (lq={lq}, lk={lk}); using largest divisors "
            f"(q={qb}, kv={kb}) instead")
        q_block, kv_block = qb, kb
    return _BlockwiseAttention.apply(q, k, v, causal, scale, q_block,
                                     kv_block, window, softcap)
