"""The port's ops against the JAX package's, on the CPU: layer primitives
and their gradients, naive attention, the blockwise flash_attention and its
gradients, and the kernels' plain versions: (out, lse) against the Pallas
forward and (dq, dk, dv) against the Pallas backward, both run in
interpret mode, and against ``jax.grad`` of naive attention at ragged
lengths.

Inputs come from numpy (seeded) and go to both packages. Tolerances are in
float32: 1e-5 absolute unless stated, for summation-order differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as JA
from ray_tpu.ops import layers as JL
from ray_tpu_torch.ops import attention as TA
from ray_tpu_torch.ops import flash_cuda
from ray_tpu_torch.ops import layers as TL

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _small_footprint():
    """These tests share worker processes with the rest of the suite: torch
    keeps to one thread while they run (the shapes are tiny), and JAX's
    caches of the many small programs they compile are dropped after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()


def _np(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, atol=F32_TOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------------------
# layer primitives
# ---------------------------------------------------------------------------

def _prim_rms():
    x, w = _np(2, 5, 16), _np(16, seed=1)
    return (JL.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-5),
            TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-5))


def _prim_layer_norm():
    x, w, b = _np(2, 5, 16), _np(16, seed=1), _np(16, seed=2)
    return (JL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
            TL.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b)))


def _prim_layer_norm_nobias():
    x, w = _np(3, 16), _np(16, seed=1)
    return (JL.layer_norm(jnp.asarray(x), jnp.asarray(w)),
            TL.layer_norm(torch.from_numpy(x), torch.from_numpy(w)))


def _prim_rotary_tables():
    pos = np.arange(37)
    jc, js = JL.rotary_embedding(jnp.asarray(pos), 32, theta=500000.0)
    tc, ts = TL.rotary_embedding(torch.from_numpy(pos), 32, theta=500000.0)
    return np.concatenate([jc, js]), torch.cat([tc, ts])


def _prim_apply_rotary_seq():
    # [L] positions (the full-sequence forward)
    x = _np(2, 9, 4, 16)
    pos = np.arange(9)
    jc, js = JL.rotary_embedding(jnp.asarray(pos), 16)
    tc, ts = TL.rotary_embedding(torch.from_numpy(pos), 16)
    return (JL.apply_rotary(jnp.asarray(x), jc, js),
            TL.apply_rotary(torch.from_numpy(x), tc, ts))


def _prim_apply_rotary_rows():
    # [B, C] per-row positions (the paged step)
    x = _np(3, 4, 2, 16)
    pos = np.array([[0, 1, 2, 3], [7, 8, 9, 10], [30, 31, 32, 33]])
    jc, js = JL.rotary_embedding(jnp.asarray(pos), 16)
    tc, ts = TL.rotary_embedding(torch.from_numpy(pos), 16)
    return (JL.apply_rotary(jnp.asarray(x), jc, js),
            TL.apply_rotary(torch.from_numpy(x), tc, ts))


def _prim_swiglu():
    x, g, u, d = _np(2, 3, 8), _np(8, 24, seed=1), _np(8, 24, seed=2), \
        _np(24, 8, seed=3)
    return (JL.swiglu(*(jnp.asarray(a) for a in (x, g, u, d))),
            TL.swiglu(*(torch.from_numpy(a) for a in (x, g, u, d))))


PRIMITIVES = {
    "rms_norm": _prim_rms,
    "layer_norm": _prim_layer_norm,
    "layer_norm_nobias": _prim_layer_norm_nobias,
    "rotary_tables": _prim_rotary_tables,
    "apply_rotary_seq": _prim_apply_rotary_seq,
    "apply_rotary_rows": _prim_apply_rotary_rows,
    "swiglu": _prim_swiglu,
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_layer_primitives_match_jax(name):
    want, got = PRIMITIVES[name]()
    _close(got, want)


def _grad_rms():
    x, w, g = _np(2, 5, 16), _np(16, seed=1), _np(2, 5, 16, seed=3)
    return (jax.vjp(lambda x, w: JL.rms_norm(x, w, eps=1e-5),
                    jnp.asarray(x), jnp.asarray(w))[1](jnp.asarray(g)),
            (lambda x, w: TL.rms_norm(x, w, eps=1e-5), (x, w), g))


def _grad_layer_norm():
    x, w, b, g = _np(2, 5, 16), _np(16, seed=1), _np(16, seed=2), \
        _np(2, 5, 16, seed=3)
    return (jax.vjp(JL.layer_norm, *(jnp.asarray(a) for a in (x, w, b)))[1](
        jnp.asarray(g)), (TL.layer_norm, (x, w, b), g))


def _grad_layer_norm_nobias():
    x, w, g = _np(3, 16), _np(16, seed=1), _np(3, 16, seed=3)
    return (jax.vjp(JL.layer_norm, jnp.asarray(x), jnp.asarray(w))[1](
        jnp.asarray(g)), (TL.layer_norm, (x, w), g))


def _grad_apply_rotary(pos):
    x = _np(*pos.shape[:-1] or (2,), pos.shape[-1], 4, 16)
    g = _np(*x.shape, seed=3)
    jc, js = JL.rotary_embedding(jnp.asarray(pos), 16)
    tc, ts = TL.rotary_embedding(torch.from_numpy(pos), 16)
    want = jax.vjp(lambda x: JL.apply_rotary(x, jc, js), jnp.asarray(x))[1](
        jnp.asarray(g))
    return want, (lambda x: TL.apply_rotary(x, tc, ts), (x,), g)


LAYER_GRADS = {
    "rms_norm": _grad_rms,
    "layer_norm": _grad_layer_norm,
    "layer_norm_nobias": _grad_layer_norm_nobias,
    "apply_rotary_seq": lambda: _grad_apply_rotary(np.arange(9)),
    "apply_rotary_rows": lambda: _grad_apply_rotary(
        np.array([[0, 1, 2, 3], [7, 8, 9, 10], [30, 31, 32, 33]])),
}


@pytest.mark.parametrize("name", sorted(LAYER_GRADS))
def test_layer_grads_match_jax(name):
    """The backward rules (bf16-residual norms, inverse rotation) against
    ``jax.vjp`` of the reference's custom VJPs, for every input."""
    want, (fn, args, g) = LAYER_GRADS[name]()
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    got = torch.autograd.grad(fn(*leaves), leaves, torch.from_numpy(g))
    assert len(got) == len(want)
    for gt, wt in zip(got, want):
        _close(gt, wt)


def test_norm_backward_saves_only_inputs():
    """The norms keep only x and weight for the backward (no float32
    intermediates), and grads come back in the inputs' dtypes."""
    x = torch.randn(2, 8, dtype=torch.bfloat16, requires_grad=True)
    w = torch.ones(8, dtype=torch.float32, requires_grad=True)
    for fn in (TL.rms_norm, TL.layer_norm):
        out = fn(x, w)
        saved = out.grad_fn.saved_tensors
        assert [t.dtype for t in saved] == [torch.bfloat16, torch.float32]
        dx, dw = torch.autograd.grad(out, (x, w), torch.ones_like(out))
        assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32


def test_norms_keep_input_dtype():
    x = torch.randn(2, 8, dtype=torch.bfloat16)
    w = torch.ones(8, dtype=torch.float32)
    assert TL.rms_norm(x, w).dtype == torch.bfloat16
    assert TL.layer_norm(x, w).dtype == torch.bfloat16
    cos, sin = TL.rotary_embedding(torch.arange(2), 8)
    assert TL.apply_rotary(x.reshape(1, 2, 1, 8), cos, sin).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# naive attention
# ---------------------------------------------------------------------------

NAIVE_CASES = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "window": dict(causal=True, window=5),
    "q_offset": dict(causal=True, q_offset=4),
    "k_offset": dict(causal=True, k_offset=-3),
    "k_positions": dict(causal=True, k_positions=np.array(
        [5, 6, 7, -1, 0, 1, 2, 3, 4, -1, 8, 9])),
    "softcap": dict(causal=True, softcap=2.0),
    "softcap_full": dict(causal=False, softcap=2.0, scale=0.7),
}


@pytest.mark.parametrize("gqa", [1, 2], ids=["mha", "gqa2"])
@pytest.mark.parametrize("case", sorted(NAIVE_CASES))
def test_naive_attention_matches_jax(case, gqa):
    kw = dict(NAIVE_CASES[case])
    lq = 8 if "q_offset" in kw else 12
    q, k, v = _np(2, lq, 4, 16), _np(2, 12, 4 // gqa, 16, seed=1), \
        _np(2, 12, 4 // gqa, 16, seed=2)
    jkw, tkw = dict(kw), dict(kw)
    if "k_positions" in kw:
        jkw["k_positions"] = jnp.asarray(kw["k_positions"])
        tkw["k_positions"] = torch.from_numpy(kw["k_positions"])
    want = JA.naive_attention(*(jnp.asarray(a) for a in (q, k, v)), **jkw)
    got = TA.naive_attention(*(torch.from_numpy(a) for a in (q, k, v)), **tkw)
    _close(got, want)


def test_repeat_kv_repeats_each_head_in_place():
    k = torch.arange(3).float().reshape(1, 1, 3, 1).expand(1, 1, 3, 2)
    got = TA._repeat_kv(k, 6)[0, 0, :, 0].tolist()
    assert got == [0, 0, 1, 1, 2, 2]   # q head h reads kv head h // 2
    want = JA._repeat_kv(jnp.asarray(k.numpy()), 6)[0, 0, :, 0].tolist()
    assert got == want


# ---------------------------------------------------------------------------
# blockwise flash_attention (the CPU path of the dispatcher)
# ---------------------------------------------------------------------------

BLOCKWISE_CASES = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "window24": dict(causal=True, window=24),
    "window40_softcap": dict(causal=True, window=40, softcap=5.0),
}


@pytest.mark.parametrize("case", sorted(BLOCKWISE_CASES))
def test_blockwise_flash_attention_matches_jax_xla(case):
    kw = BLOCKWISE_CASES[case]
    q, k, v = _np(1, 128, 4, 16), _np(1, 128, 2, 16, seed=1), \
        _np(1, 128, 2, 16, seed=2)
    want = JA.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              impl="xla", q_block=32, kv_block=16, **kw)
    got = TA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             impl="blockwise", q_block=32, kv_block=16, **kw)
    _close(got, want)
    naive = TA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               impl="naive", **kw)
    _close(got, naive)


def test_flash_attention_impl_rules(monkeypatch):
    q = torch.zeros(1, 4, 2, 8)
    monkeypatch.delenv("RTPU_ATTN_IMPL", raising=False)
    assert TA.resolve_attention_impl("cuda") == "cuda"
    assert TA.resolve_attention_impl("cpu") == "blockwise"
    monkeypatch.setenv("RTPU_ATTN_IMPL", "naive")
    assert TA.resolve_attention_impl("cpu") == "naive"
    assert TA.resolve_attention_impl("cuda") == "cuda"   # env never picks a
    monkeypatch.delenv("RTPU_ATTN_IMPL")                 # plain path on CUDA
    TA.set_default_attention_impl("naive")
    try:
        assert TA.resolve_attention_impl("cpu") == "naive"
    finally:
        TA.set_default_attention_impl(None)
    with pytest.raises(ValueError):
        TA.set_default_attention_impl("pallas")
    with pytest.raises(ValueError, match="cannot run on cpu"):
        TA.flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="window requires causal"):
        TA.flash_attention(q, q, q, causal=False, window=4)


# ---------------------------------------------------------------------------
# attention gradients on the CPU: the blockwise autograd Function and the
# kernels' autograd Function (plain versions on CPU tensors)
# ---------------------------------------------------------------------------

GRAD_CASES = {
    # name: (Hk, causal, window, softcap); H = 4, D = 16
    "causal": (2, True, None, 0.0),
    "full": (2, False, None, 0.0),
    "window24": (2, True, 24, 0.0),
    "softcap5": (2, True, None, 5.0),
    "mha_window40_softcap": (4, True, 40, 5.0),
}


def _jax_attention_grads(q, k, v, g, causal, window, softcap, **blocks):
    fn = lambda q, k, v: JA.flash_attention(  # noqa: E731
        q, k, v, causal=causal, window=window, softcap=softcap, impl="xla",
        **blocks)
    return jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))[1](
        jnp.asarray(g))


@pytest.mark.parametrize("length", [128, 200], ids=["L128", "ragged200"])
@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_flash_attention_grads_match_jax_xla(case, length):
    """dq/dk/dv (dk/dv at the native kv-head count) of the dispatcher's
    CPU path and of ``_FlashAttention`` on CPU tensors, against ``jax.vjp``
    of the reference's ``flash_attention(impl="xla")``. At 128 the
    blockwise path runs 32/16 tiles; at 200 neither knob divides, so both
    packages take naive attention and the kernel Function's plain version
    takes one 200-row tile."""
    hk, causal, window, softcap = GRAD_CASES[case]
    amp = 3.0 if softcap else 1.0
    q = _np(1, length, 4, 16) * amp
    k, v = _np(1, length, hk, 16, seed=1), _np(1, length, hk, 16, seed=2)
    g = _np(1, length, 4, 16, seed=3)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = _jax_attention_grads(q, k, v, g, q_block=32, kv_block=16, **kw)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    blockwise = TA.flash_attention(*leaves, q_block=32, kv_block=16, **kw)
    kernel_fn = TA._FlashAttention.apply(*leaves, causal, 16 ** -0.5,
                                         window, softcap)
    _close(kernel_fn.detach(), blockwise.detach())
    for out in (blockwise, kernel_fn):
        got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
        for gt, wt in zip(got, want):
            assert gt.shape == wt.shape
            _close(gt, wt, atol=2e-5 * amp)


def test_attention_functions_respect_needs_input_grad():
    """Only the inputs that require grad get one; residuals stay O(L) (k
    and v at their native kv-head count, no [Lq, Lk] scores)."""
    q = torch.from_numpy(_np(1, 64, 4, 16)).requires_grad_()
    k, v = (torch.from_numpy(_np(1, 64, 2, 16, seed=s)) for s in (1, 2))
    for out in (TA.flash_attention(q, k, v, q_block=32, kv_block=32),
                TA._FlashAttention.apply(q, k, v, True, 0.25, None, 0.0)):
        saved = out.grad_fn.saved_tensors
        assert [tuple(t.shape) for t in saved] == [
            (1, 64, 4, 16), (1, 64, 2, 16), (1, 64, 2, 16), (1, 64, 4, 16),
            (1, 4, 64)]
        (dq,) = torch.autograd.grad(out.sum(), [q], retain_graph=True)
        assert dq.shape == q.shape
        assert out.grad_fn.apply(torch.ones_like(out))[1:3] == (None, None)


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas forward (interpret mode)
# ---------------------------------------------------------------------------

FLASH_CASES = {
    # name: (Hk, causal, window, softcap); H = 4, D = 32
    "causal": (4, True, None, 0.0),
    "full": (4, False, None, 0.0),
    "window48": (4, True, 48, 0.0),
    "softcap50": (4, True, None, 50.0),
    "gqa2": (2, True, None, 0.0),
}


@pytest.mark.modern_jax
@pytest.mark.parametrize("length", [256, 200], ids=["L256", "ragged200"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_reference_matches_pallas_interpret(case, length):
    """(out, lse) of flash_attention_fwd_reference == Pallas forward.
    L256 runs the Pallas kernel on 128-tiles (band-skipping predicates
    included); the ragged length runs the TPU wrapper's fallback."""
    from ray_tpu.ops.flash_pallas import flash_attention_pallas_fwd

    hk, causal, window, softcap = FLASH_CASES[case]
    # softcap 50 on unit-scale scores would be a no-op: widen the scores
    amp = 8.0 if softcap else 1.0
    q = _np(1, length, 4, 32) * amp
    k, v = _np(1, length, hk, 32, seed=1), _np(1, length, hk, 32, seed=2)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jo, jl = flash_attention_pallas_fwd(
        *(jnp.asarray(a) for a in (q, k, v)), block_q=128, block_k=128,
        interpret=True, **kw)
    to, tl = flash_cuda.flash_attention_fwd_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), **kw)
    _close(to, jo)
    _close(tl, jl, atol=F32_TOL * amp)


@pytest.mark.modern_jax
@pytest.mark.parametrize("case", ["causal_softcap50", "window48_softcap50"])
def test_flash_reference_matches_pallas_interpret_d256(case):
    """Head dim 256 (gemma2_9b's), the shape the forward kernel takes at
    D = 256: GQA 4/2, Gemma-2's softcap 50, causal or a window of 48, on
    the Pallas kernel's 128-tiles."""
    from ray_tpu.ops.flash_pallas import flash_attention_pallas_fwd

    window = 48 if case.startswith("window") else None
    q = _np(1, 256, 4, 256) * 8.0  # widen the scores: the cap must bite
    k, v = _np(1, 256, 2, 256, seed=1), _np(1, 256, 2, 256, seed=2)
    kw = dict(causal=True, window=window, softcap=50.0)
    jo, jl = flash_attention_pallas_fwd(
        *(jnp.asarray(a) for a in (q, k, v)), block_q=128, block_k=128,
        interpret=True, **kw)
    to, tl = flash_cuda.flash_attention_fwd_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), **kw)
    _close(to, jo)
    _close(tl, jl, atol=F32_TOL * 8.0)


@pytest.mark.modern_jax
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_bwd_reference_matches_pallas_interpret(case):
    """(dq, dk, dv) of flash_attention_bwd_reference == the Pallas backward
    kernels (interpret mode, 128-tiles, dk/dv at native kv heads) on the
    Pallas forward's out and lse."""
    from ray_tpu.ops.flash_pallas import (flash_attention_pallas_bwd,
                                          flash_attention_pallas_fwd)

    hk, causal, window, softcap = FLASH_CASES[case]
    amp = 8.0 if softcap else 1.0
    q = _np(1, 256, 4, 32) * amp
    k, v = _np(1, 256, hk, 32, seed=1), _np(1, 256, hk, 32, seed=2)
    g = _np(1, 256, 4, 32, seed=3)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jo, jl = flash_attention_pallas_fwd(jq, jk, jv, block_q=128,
                                        block_k=128, interpret=True, **kw)
    want = flash_attention_pallas_bwd(jq, jk, jv, jo, jl, jg, block_q=128,
                                      block_k=128, interpret=True, **kw)
    got = flash_cuda.flash_attention_bwd_reference(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, jo, jl, g)),
        **kw)
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape
        _close(gt, wt, atol=2e-5 * amp)


@pytest.mark.modern_jax
@pytest.mark.parametrize("case", ["causal_softcap50", "window48_softcap50"])
def test_flash_bwd_reference_matches_pallas_interpret_d256(case):
    """Head dim 256 (Gemma-2's), the shape the backward kernels take at
    D = 256: (dq, dk, dv) of flash_attention_bwd_reference against the
    Pallas backward (interpret mode, 128-tiles) on the Pallas forward's out
    and lse, GQA 4/2, softcap 50 with q widened by 8 so the cap and its
    chain factor change the grads, causal or a window of 48. Tolerance
    2e-5 x 8 absolute, as at D = 32: float32 sums in another order."""
    from ray_tpu.ops.flash_pallas import (flash_attention_pallas_bwd,
                                          flash_attention_pallas_fwd)

    window = 48 if case.startswith("window") else None
    q = _np(1, 256, 4, 256) * 8.0
    k, v = _np(1, 256, 2, 256, seed=1), _np(1, 256, 2, 256, seed=2)
    g = _np(1, 256, 4, 256, seed=3)
    kw = dict(causal=True, window=window, softcap=50.0)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jo, jl = flash_attention_pallas_fwd(jq, jk, jv, block_q=128,
                                        block_k=128, interpret=True, **kw)
    want = flash_attention_pallas_bwd(jq, jk, jv, jo, jl, jg, block_q=128,
                                      block_k=128, interpret=True, **kw)
    got = flash_cuda.flash_attention_bwd_reference(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, jo, jl, g)),
        **kw)
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape
        _close(gt, wt, atol=2e-5 * 8.0)


RAGGED_BWD_CASES = {
    # name: (Lq, Lk, Hk, causal, window, softcap); H = 4, D = 16
    "causal_L200": (200, 200, 2, True, None, 0.0),
    "window24_L70": (70, 70, 1, True, 24, 0.0),
    "softcap_L90": (90, 90, 2, True, None, 5.0),
    "full_q70_k100": (70, 100, 2, False, None, 0.0),
    "causal_q100_k70": (100, 70, 4, True, None, 0.0),
}


@pytest.mark.parametrize("case", sorted(RAGGED_BWD_CASES))
def test_flash_bwd_reference_matches_naive_grad_ragged(case):
    """At lengths no tile divides, the kernels' plain versions (forward,
    then backward on its out and lse) against ``jax.vjp`` of the
    reference's naive attention."""
    lq, lk, hk, causal, window, softcap = RAGGED_BWD_CASES[case]
    amp = 3.0 if softcap else 1.0
    q = _np(2, lq, 4, 16) * amp
    k, v = _np(2, lk, hk, 16, seed=1), _np(2, lk, hk, 16, seed=2)
    g = _np(2, lq, 4, 16, seed=3)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = jax.vjp(lambda q, k, v: JA.naive_attention(q, k, v, **kw),
                   *(jnp.asarray(a) for a in (q, k, v)))[1](jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = flash_cuda.flash_attention_fwd_reference(tq, tk, tv, **kw)
    before = (flash_cuda.launches_dq, flash_cuda.launches_dkv)
    got = flash_cuda.flash_attention_bwd(tq, tk, tv, out, lse, tg, **kw)
    assert (flash_cuda.launches_dq, flash_cuda.launches_dkv) == before
    ref = flash_cuda.flash_attention_bwd_reference(tq, tk, tv, out, lse, tg,
                                                   **kw)
    for gt, rt, wt in zip(got, ref, want):
        assert torch.equal(gt, rt) and gt.shape == wt.shape
        _close(gt, wt, atol=2e-5 * amp)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in
               (_np(1, 70, 4, 64), _np(1, 70, 2, 64, seed=1),
                _np(1, 70, 2, 64, seed=2)))
    before = flash_cuda.launches
    out, lse = flash_cuda.flash_attention_fwd(q, k, v, window=16)
    assert flash_cuda.launches == before       # no kernel ran
    ref_out, ref_lse = flash_cuda.flash_attention_fwd_reference(q, k, v,
                                                                window=16)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert out.shape == q.shape and lse.shape == (1, 4, 70)
    want = TA.naive_attention(q, k, v, window=16)
    _close(out, want)
    with pytest.raises(ValueError, match="window requires causal"):
        flash_cuda.flash_attention_fwd(q, k, v, causal=False, window=16)


def test_kernel_layout_copies_only_what_the_kernels_cannot_read():
    """``_kernel_layout`` keeps a view the kernels (TMA for the bf16
    forward) can read in place and copies the rest, values unchanged."""
    base = torch.arange(2 * 96 * 8 * 64, dtype=torch.float32).to(
        torch.bfloat16)
    qkv = base.view(2, 96, 8, 64)
    keep = [qkv, qkv[:, :, :4], qkv[:, :, 6:],
            # extent-1 batch and head dims with strides TMA could not take
            base.as_strided((1, 96, 1, 64), (5, 512, 3, 1))]
    for t in keep:
        assert flash_cuda._kernel_layout(t) is t
    copy = [qkv.transpose(1, 2).transpose(1, 3),        # last dim strided
            qkv[:, :, :1].expand(2, 96, 4, 64),          # zero head stride
            base.as_strided((1, 96, 2, 64), (0, 130, 64, 1)),  # row stride
            base[1:].as_strided((1, 96, 2, 64), (0, 128, 64, 1))]  # base
    for t in copy:
        got = flash_cuda._kernel_layout(t)
        assert got is not t and got.is_contiguous() and torch.equal(got, t)


def test_forward_kernel_variants_patch_the_source(tmp_path):
    """Each variant of ``experiments/torch_flash_fwd_variants.py`` still
    finds, exactly once, the lines of ``flash_fwd.cu`` it replaces."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "torch_flash_fwd_variants",
        root / "experiments" / "torch_flash_fwd_variants.py")
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    csrc = root / "ray_tpu_torch" / "ops" / "csrc"
    source = (csrc / "flash_fwd.cu").read_text()
    for name, patches in variants.VARIANTS.items():
        out = variants.variant_source(name, csrc, tmp_path / name)
        patched = (out / "flash_fwd.cu").read_text()
        assert (patched == source) == (not patches), name
        assert (out / "hopper.cuh").exists()


def test_backward_kernel_variants_patch_the_source(tmp_path):
    """Each variant of ``experiments/torch_flash_bwd_variants.py`` still
    finds, exactly once, the lines of ``flash_bwd.cu`` it replaces."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "torch_flash_bwd_variants",
        root / "experiments" / "torch_flash_bwd_variants.py")
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    csrc = root / "ray_tpu_torch" / "ops" / "csrc"
    source = (csrc / "flash_bwd.cu").read_text()
    for name, patches in variants.VARIANTS.items():
        out = variants.variant_source(name, csrc, tmp_path / name)
        patched = (out / "flash_bwd.cu").read_text()
        assert (patched == source) == (not patches), name
        assert (out / "hopper.cuh").exists()
