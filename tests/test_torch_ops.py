"""The port's ops against the JAX package's, on the CPU: layer primitives,
naive attention, the blockwise flash_attention, and the kernel's plain
version (out, lse) against the Pallas forward run in interpret mode.

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


def test_cuda_flash_backward_raises_not_implemented():
    with pytest.raises(NotImplementedError, match="_flash_bwd_dkv_kernel"):
        TA._FlashAttention.backward(None, torch.zeros(1))


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
