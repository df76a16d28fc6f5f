"""The port's kernels on the card: the Hopper flash-attention forward and
backward (dQ, dK/dV), at head dims 64, 128 and 256, against their plain
PyTorch versions, and the CUDA autograd path running them. The serving
engine's programs captured as CUDA graphs (``util.device_plane``) against
the same programs run eagerly.

Marked ``cuda``; each test skips (with the reason) where no GPU is
present. This file imports no JAX, so on a GPU machine without JAX it runs
alone (the repo's conftest imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch import models
from ray_tpu_torch.ops import attention, flash_cuda
from ray_tpu_torch.serve import LLMEngine
from ray_tpu_torch.util import device_plane

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, Lq, Lk, H, Hk, D, dtype, causal, window, softcap)
CASES = [
    (1, 256, 256, 4, 2, 128, torch.bfloat16, True, None, 0.0),
    (2, 190, 190, 4, 4, 64, torch.bfloat16, False, None, 0.0),
    (1, 300, 300, 8, 2, 128, torch.bfloat16, True, 48, 50.0),
    (1, 100, 260, 4, 1, 64, torch.bfloat16, True, None, 0.0),
    (1, 200, 200, 4, 2, 64, torch.float32, True, 24, 0.0),
    (1, 130, 70, 2, 2, 128, torch.float32, False, None, 30.0),
    # head dim 256 (gemma2_9b): 64-row K/V tiles, no producer warpgroup
    (1, 300, 300, 4, 2, 256, torch.bfloat16, True, 48, 50.0),
    (2, 200, 200, 4, 2, 256, torch.bfloat16, True, None, 0.0),
    (1, 100, 260, 4, 4, 256, torch.bfloat16, False, None, 0.0),
    (1, 200, 200, 4, 2, 256, torch.float32, True, 24, 30.0),
]
# bf16: P enters the PV product in bf16 and out is rounded to bf16
TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-4, 1e-4)}


@pytest.mark.parametrize("case", CASES, ids=str)
def test_kernel_matches_plain_version(cuda, case):
    b, lq, lk, h, hk, d, dtype, causal, window, softcap = case
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q, k, v = rnd(b, lq, h, d) * 4, rnd(b, lk, hk, d), rnd(b, lk, hk, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = flash_cuda.launches
    out, lse = flash_cuda.flash_attention_fwd(q, k, v, **kw)
    assert flash_cuda.launches == before + 1
    ref_out, ref_lse = flash_cuda.flash_attention_fwd_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    tol_out, tol_lse = TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (out.float() - ref_out.float()).abs().max().item() <= tol_out
    assert (lse - ref_lse).abs().max().item() <= tol_lse


def test_kernel_reads_strided_inputs(cuda):
    """q/k/v as views of one packed [B, L, H + 2 Hk, D] projection."""
    qkv = torch.randn(1, 128, 8, 64, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    out, lse = flash_cuda.flash_attention_fwd(q, k, v)
    ref_out, ref_lse = flash_cuda.flash_attention_fwd_reference(q, k, v)
    assert (out.float() - ref_out.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-2


# the edges of the bf16 kernel's 128-row q and kv tiles: one row short of a
# tile, a full tile, one row over, a full and a ragged tile; Lq != Lk
# without the causal mask at D = 64
# (B, Lq, Lk, H, Hk, D, causal)
EDGE_CASES = [
    (1, 127, 127, 4, 2, 128, True),
    (1, 128, 128, 4, 2, 128, True),
    (1, 129, 129, 4, 2, 128, True),
    (2, 200, 200, 4, 1, 128, True),
    (1, 129, 300, 4, 2, 64, False),
    (1, 300, 129, 4, 4, 64, False),
    # D = 256: the 64-row K/V tiles' edges, and a q tile's
    (1, 63, 63, 4, 2, 256, True),
    (1, 65, 65, 4, 2, 256, True),
    (1, 129, 193, 4, 2, 256, False),
]


@pytest.mark.parametrize("case", EDGE_CASES, ids=str)
def test_kernel_tile_edges(cuda, case):
    b, lq, lk, h, hk, d, causal = case
    gen = torch.Generator(device=cuda).manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(
            torch.bfloat16)

    q, k, v = rnd(b, lq, h, d) * 4, rnd(b, lk, hk, d), rnd(b, lk, hk, d)
    out, lse = flash_cuda.flash_attention_fwd(q, k, v, causal=causal)
    ref_out, ref_lse = flash_cuda.flash_attention_fwd_reference(
        q, k, v, causal=causal)
    tol_out, tol_lse = TOL[torch.bfloat16]
    assert (out.float() - ref_out.float()).abs().max().item() <= tol_out
    assert (lse - ref_lse).abs().max().item() <= tol_lse


def test_kernel_reads_batch_and_head_strides(cuda):
    """q a transposed view of [B, H, L, D], k/v every other head of a wider
    tensor, and an expanded (stride-0) k that the wrapper copies."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(2, 4, 200, 128, generator=gen, device=cuda).to(
        torch.bfloat16).transpose(1, 2)
    kv = torch.randn(2, 200, 4, 128, generator=gen, device=cuda).to(
        torch.bfloat16)
    k, v = kv[:, :, ::2], kv[:, :, 1::2]
    for kk in (k, k[:, :, :1].expand(2, 200, 2, 128)):
        out, lse = flash_cuda.flash_attention_fwd(q, kk, v)
        ref_out, ref_lse = flash_cuda.flash_attention_fwd_reference(q, kk, v)
        assert (out.float() - ref_out.float()).abs().max().item() <= 2e-2
        assert (lse - ref_lse).abs().max().item() <= 1e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_kernel_repeat_is_bitwise_equal(cuda, dtype):
    """No atomics and a fixed order of sums: a repeat call gives the same
    bits."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(2, 300, 4, 128, generator=gen, device=cuda).to(
        dtype) for _ in range(3))
    first = flash_cuda.flash_attention_fwd(q, k, v, window=100)
    again = flash_cuda.flash_attention_fwd(q, k, v, window=100)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_kernel_repeat_is_bitwise_equal_d256(cuda):
    """At head dim 256 the consumer warps also refill the ring, the last
    to release a stage elected by a shared counter: still the same bits on
    a repeat call."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(1, 1000, 8, 256, generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(3))
    first = flash_cuda.flash_attention_fwd(q, k, v, softcap=50.0)
    again = flash_cuda.flash_attention_fwd(q, k, v, softcap=50.0)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_unsupported_head_dim_backward_raises_without_a_fallback(
        cuda, monkeypatch):
    """A head dim the backward kernels do not take (96): flash_attention_bwd
    raises naming it, launches no kernel and never runs the plain version
    on CUDA tensors."""
    plain = []
    monkeypatch.setattr(flash_cuda, "flash_attention_bwd_reference",
                        lambda *a, **k: plain.append(1))
    q = torch.randn(1, 64, 2, 96, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 64, device=cuda)
    before = (flash_cuda.launches_dq, flash_cuda.launches_dkv)
    with pytest.raises(ValueError, match="head dim 96"):
        flash_cuda.flash_attention_bwd(q, q, q, q, lse, q)
    assert (flash_cuda.launches_dq, flash_cuda.launches_dkv) == before
    assert not plain


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn(1, 16, 2, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_cuda.flash_attention_fwd(q, q, q)
    q = torch.randn(1, 16, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_cuda.flash_attention_fwd(q, q, q)


# (B, Lq, Lk, H, Hk, D, dtype, causal, window, softcap)
BWD_CASES = [
    (1, 256, 256, 4, 2, 128, torch.bfloat16, True, None, 0.0),
    (2, 190, 190, 4, 4, 64, torch.bfloat16, False, None, 0.0),
    (1, 300, 300, 8, 2, 128, torch.bfloat16, True, 48, 50.0),
    (1, 100, 260, 4, 1, 64, torch.bfloat16, True, None, 0.0),
    (1, 260, 100, 4, 2, 128, torch.bfloat16, True, None, 0.0),
    (1, 200, 200, 4, 2, 64, torch.float32, True, 24, 0.0),
    (1, 130, 70, 2, 2, 128, torch.float32, False, None, 30.0),
    # head dim 256 (Gemma-2): 32-row streamed tiles, dK/dV in two sweeps
    (1, 300, 300, 4, 2, 256, torch.bfloat16, True, 48, 50.0),
    (2, 200, 200, 4, 2, 256, torch.bfloat16, True, None, 0.0),
    (1, 100, 260, 4, 4, 256, torch.bfloat16, False, None, 0.0),
    (1, 260, 100, 4, 2, 256, torch.bfloat16, True, None, 0.0),
    (1, 200, 200, 4, 2, 256, torch.float32, True, 24, 30.0),
]
# max |kernel - plain| over max |plain|: bf16 rounds P and dS to 8 bits in
# the products and the grads once; f32 sums in another order
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_bwd_kernels_match_plain_version(cuda, case):
    """dq, dk, dv (dk/dv at the native kv heads) against the plain version
    on the forward kernel's out and lse; a repeat call is bitwise equal
    (no atomics)."""
    b, lq, lk, h, hk, d, dtype, causal, window, softcap = case
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q, k, v = rnd(b, lq, h, d) * 4, rnd(b, lk, hk, d), rnd(b, lk, hk, d)
    dout = rnd(b, lq, h, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = flash_cuda.flash_attention_fwd(q, k, v, **kw)
    before = (flash_cuda.launches_dq, flash_cuda.launches_dkv)
    got = flash_cuda.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert (flash_cuda.launches_dq, flash_cuda.launches_dkv) == (
        before[0] + 1, before[1] + 1)
    again = flash_cuda.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = flash_cuda.flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                                    **kw)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a)
        assert _rel_err(g, w) <= BWD_TOL[dtype]


def test_bwd_kernels_read_strided_inputs(cuda):
    """q/k/v as views of one packed projection, dout a transposed view."""
    qkv = torch.randn(1, 128, 8, 64, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    dout = torch.randn(1, 4, 128, 64, device=cuda,
                       dtype=torch.bfloat16).transpose(1, 2)
    out, lse = flash_cuda.flash_attention_fwd(q, k, v)
    got = flash_cuda.flash_attention_bwd(q, k, v, out, lse, dout)
    want = flash_cuda.flash_attention_bwd_reference(q, k, v, out, lse, dout)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= BWD_TOL[torch.bfloat16]


# the edges of the bf16 backward kernels' tiles: 128 owned rows a CTA (64 a
# consumer warpgroup), 64 streamed rows a step (32 at D = 256); Lq != Lk
# without the causal mask; windows whose band crosses a 128-row tile, or
# that no 32-row tile divides
# (B, Lq, Lk, H, Hk, D, causal, window)
BWD_EDGE_CASES = [
    (1, 63, 63, 4, 2, 128, True, None),
    (1, 64, 64, 4, 2, 128, True, None),
    (1, 65, 65, 4, 2, 128, True, None),
    (1, 127, 127, 4, 2, 128, True, None),
    (1, 128, 128, 4, 2, 128, True, None),
    (1, 129, 129, 4, 2, 128, True, None),
    (2, 200, 200, 4, 1, 128, True, None),
    (1, 129, 300, 4, 2, 64, False, None),
    (1, 300, 129, 4, 4, 64, False, None),
    (1, 65, 200, 2, 1, 64, False, None),
    (1, 300, 300, 4, 2, 128, True, 100),
    (1, 260, 260, 4, 2, 64, True, 70),
    (1, 31, 31, 4, 2, 256, True, None),
    (1, 32, 32, 4, 2, 256, True, None),
    (1, 33, 33, 4, 2, 256, True, None),
    (1, 129, 129, 4, 2, 256, True, None),
    (2, 200, 200, 4, 1, 256, True, None),
    (1, 129, 300, 4, 2, 256, False, None),
    (1, 300, 129, 4, 4, 256, False, None),
    (1, 300, 300, 4, 2, 256, True, 70),
]


@pytest.mark.parametrize("case", BWD_EDGE_CASES, ids=str)
def test_bwd_kernel_tile_edges(cuda, case):
    b, lq, lk, h, hk, d, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(
            torch.bfloat16)

    q, k, v = rnd(b, lq, h, d) * 4, rnd(b, lk, hk, d), rnd(b, lk, hk, d)
    dout = rnd(b, lq, h, d)
    kw = dict(causal=causal, window=window)
    out, lse = flash_cuda.flash_attention_fwd(q, k, v, **kw)
    got = flash_cuda.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = flash_cuda.flash_attention_bwd_reference(q, k, v, out, lse, dout,
                                                    **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_err(g, w) <= BWD_TOL[torch.bfloat16]


def test_bwd_kernels_read_batch_and_head_strides(cuda):
    """q and dout transposed views of [B, H, L, D], k/v every other head of
    a wider tensor, dout also as a batch-strided slice and as an expanded
    (stride-0) tensor that the wrapper copies."""
    gen = torch.Generator(device=cuda).manual_seed(6)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(
            torch.bfloat16)

    q = (rnd(2, 4, 200, 128) * 4).transpose(1, 2)
    kv = rnd(2, 200, 4, 128)
    k, v = kv[:, :, ::2], kv[:, :, 1::2]
    out, lse = flash_cuda.flash_attention_fwd(q, k, v)
    douts = [rnd(2, 4, 200, 128).transpose(1, 2),
             rnd(4, 200, 4, 128)[::2],
             rnd(1, 200, 1, 128).expand(2, 200, 4, 128)]
    for dout in douts:
        got = flash_cuda.flash_attention_bwd(q, k, v, out, lse, dout)
        want = flash_cuda.flash_attention_bwd_reference(q, k, v, out, lse,
                                                        dout)
        for g, w in zip(got, want):
            assert _rel_err(g, w) <= BWD_TOL[torch.bfloat16]


@pytest.mark.parametrize(
    "dtype,d", [(torch.bfloat16, 128), (torch.float32, 128),
                (torch.bfloat16, 256), (torch.float32, 256)],
    ids=["torch.bfloat16", "torch.float32", "torch.bfloat16-d256",
         "torch.float32-d256"])
def test_bwd_repeat_is_bitwise_equal(cuda, dtype, d):
    """No atomics and a fixed order of sums: a repeat call gives the same
    bits, with GQA, a window and ragged lengths; at D = 256 the warps that
    refill the dK/dV ring are elected by a shared counter, and the bits
    stay the same."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, dout = (torch.randn(2, 300, 4, d, generator=gen, device=cuda).to(
        dtype) for _ in range(2))
    k, v = (torch.randn(2, 300, 2, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    out, lse = flash_cuda.flash_attention_fwd(q, k, v, window=100)
    first = flash_cuda.flash_attention_bwd(q, k, v, out, lse, dout,
                                           window=100)
    again = flash_cuda.flash_attention_bwd(q, k, v, out, lse, dout,
                                           window=100)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_kernels_launch_from_a_fresh_thread(cuda):
    """A thread whose first CUDA work is one of the kernels may have no CUDA
    context current yet, as autograd's worker thread may not: the forward
    and the backward each launch there, and give the main thread's bits."""
    import threading

    gen = torch.Generator(device=cuda).manual_seed(8)
    q, dout = (torch.randn(1, 200, 4, 64, generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(1, 200, 2, 64, generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    out, lse = flash_cuda.flash_attention_fwd(q, k, v, window=64)
    calls = {
        "fwd": lambda: flash_cuda.flash_attention_fwd(q, k, v, window=64),
        "bwd": lambda: flash_cuda.flash_attention_bwd(q, k, v, out, lse, dout,
                                                      window=64),
    }
    want = {name: fn() for name, fn in calls.items()}
    for name, fn in calls.items():
        got = {}

        def work():
            try:
                got["result"] = fn()
                torch.cuda.synchronize()
            except Exception as err:  # reported below, in the test's thread
                got["error"] = err

        thread = threading.Thread(target=work)
        thread.start()
        thread.join()
        assert "error" not in got, f"{name}: {got.get('error')}"
        assert all(torch.equal(x, y) for x, y in zip(got["result"],
                                                     want[name])), name


def test_bwd_kernels_reject_what_they_do_not_take(cuda):
    q = torch.randn(1, 16, 2, 32, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_cuda.flash_attention_bwd(q, q, q, q, lse, q)
    q = torch.randn(1, 16, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_cuda.flash_attention_bwd(q, q, q, q, lse, q)
    q = torch.randn(1, 16, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dout must match q"):
        flash_cuda.flash_attention_bwd(q, q, q, q, lse, q.float())
    with pytest.raises(ValueError, match="lse must be float32"):
        flash_cuda.flash_attention_bwd(q, q, q, q, lse.bfloat16(), q)


def test_cuda_flash_attention_backward_runs_kernels(cuda):
    """Autograd through ``flash_attention`` on CUDA tensors launches the
    forward, dQ and dK/dV kernels and agrees with the plain version; a
    plain impl on CUDA tensors still raises."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(1, 200, 4, 64, generator=gen, device=cuda,
                    dtype=torch.bfloat16, requires_grad=True)
    k, v = (torch.randn(1, 200, 2, 64, generator=gen, device=cuda,
                        dtype=torch.bfloat16, requires_grad=True)
            for _ in range(2))
    dout = torch.randn(1, 200, 4, 64, generator=gen, device=cuda,
                       dtype=torch.bfloat16)
    before = (flash_cuda.launches, flash_cuda.launches_dq,
              flash_cuda.launches_dkv)
    out = attention.flash_attention(q, k, v, window=64)
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert (flash_cuda.launches, flash_cuda.launches_dq,
            flash_cuda.launches_dkv) == tuple(n + 1 for n in before)
    ref_out, ref_lse = flash_cuda.flash_attention_fwd_reference(
        q.detach(), k.detach(), v.detach(), window=64)
    want = flash_cuda.flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), ref_out, ref_lse, dout,
        window=64)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_err(g, w) <= BWD_TOL[torch.bfloat16]
    with pytest.raises(ValueError, match="cannot run on cuda"):
        attention.flash_attention(q, k, v, impl="blockwise")


def test_cuda_flash_attention_backward_runs_kernels_d256(cuda):
    """The same at Gemma-2's head dim 256 with its softcap and a window:
    autograd launches the three kernels once each, and the grads agree with
    the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = (torch.randn(1, 300, 4, 256, generator=gen, device=cuda) * 4).to(
        torch.bfloat16).requires_grad_()
    k, v = (torch.randn(1, 300, 2, 256, generator=gen, device=cuda,
                        dtype=torch.bfloat16, requires_grad=True)
            for _ in range(2))
    dout = torch.randn(1, 300, 4, 256, generator=gen, device=cuda,
                       dtype=torch.bfloat16)
    kw = dict(window=100, softcap=50.0)
    before = (flash_cuda.launches, flash_cuda.launches_dq,
              flash_cuda.launches_dkv)
    out = attention.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert (flash_cuda.launches, flash_cuda.launches_dq,
            flash_cuda.launches_dkv) == tuple(n + 1 for n in before)
    ref_out, ref_lse = flash_cuda.flash_attention_fwd_reference(
        q.detach(), k.detach(), v.detach(), **kw)
    want = flash_cuda.flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), ref_out, ref_lse, dout, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_err(g, w) <= BWD_TOL[torch.bfloat16]


# ---------------------------------------------------------------------------
# captured serving programs (CUDA graphs) against eager, float32
# ---------------------------------------------------------------------------

GRAPH_TOL = 1e-5   # of max |eager|: the same kernels, replayed


def _f32_model(cuda, name, seed=0):
    cfg = models.get_config(name).replace(dtype="float32",
                                          param_dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return cfg, models.init_params(gen, cfg, device=cuda)


def _close(got, want):
    """(within GRAPH_TOL of max |want|, bitwise equal)"""
    gap = (got - want).abs().max().item()
    return gap <= GRAPH_TOL * want.abs().max().item(), gap == 0.0


def _paged_feed(cfg, rng, steps=4, b=3, c=4, n_blocks=12, bs=4):
    """A prefill chunk, then decode steps, for b rows (the last one parked)
    over a pool of n_blocks; every step's inputs have the same shapes."""
    tables = rng.permutation(n_blocks)[:b * 3].reshape(b, 3)
    feed, pos = [], np.zeros(b, np.int64)
    for i in range(steps):
        nvalid = np.full(b, c if i == 0 else 1)
        tokens = rng.integers(0, cfg.vocab_size, (b, c))
        active = np.array([True] * (b - 1) + [False])
        feed.append([torch.from_numpy(a.astype(np.int64)) for a in
                     (tokens, tables, pos.copy(), nvalid)]
                    + [torch.from_numpy(active)])
        pos = pos + nvalid * active
    return feed


@pytest.mark.parametrize("step,name", [
    ("decode_step_paged", "llama-debug"), ("decode_step_paged", "gemma-debug"),
    ("verify_step_paged", "llama-debug"), ("verify_step_paged", "gemma-debug"),
])
def test_captured_paged_step_matches_eager(cuda, step, name):
    """A paged step captured once and replayed over prefill and decode
    steps gives the eager step's logits and cache; its replays make no
    sync (``set_sync_debug_mode("error")``)."""
    cfg, params = _f32_model(cuda, name)
    fn = getattr(models, step)
    cache_e = models.init_cache_paged(cfg, 12, 4, device=cuda)
    cache_c = {k: v.clone() for k, v in cache_e.items()}
    prog = device_plane.registered_graph(
        lambda p, c, *a: fn(p, c, *a[:4], cfg, active=a[4])[0],
        name=f"test::{step}::{name}", fixed_argnums=(0, 1))
    bitwise = True
    for i, inputs in enumerate(_paged_feed(cfg, np.random.default_rng(0))):
        dev_in = [t.to(cuda) for t in inputs]
        want = fn(params, cache_e, *dev_in[:4], cfg, active=dev_in[4])[0]
        if i:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = prog(params, cache_c, *dev_in)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        rows = [0, 1]       # the parked row's logits are garbage in both
        ok, same = _close(got[rows], want[rows])
        assert ok, f"step {i}: logits off by more than {GRAPH_TOL}"
        bitwise &= same
        for key in ("k", "v"):
            ok, same = _close(cache_c[key], cache_e[key])
            assert ok, f"step {i}: cache {key}"
            bitwise &= same
    assert prog.captures == 1
    row = device_plane.registry().program(f"test::{step}::{name}")
    assert row["compiles"] == 1 and row["calls"] == 4
    assert row["memory"]["graph_pool_bytes"] > 0 and row["cost"]["flops"] > 0
    print(f"{step} {name}: captured == eager bitwise: {bitwise}")


def test_captured_dense_step_matches_eager(cuda):
    """decode_step_multi captured with its cache (pos included) fixed, its
    tokens and active flags copied in: replays match eager, a parked slot
    keeps its position, and the replays make no sync."""
    cfg, params = _f32_model(cuda, "gemma-debug")
    cache_e = models.init_cache_multi(cfg, 3, 24, device=cuda)
    cache_c = {k: v.clone() for k, v in cache_e.items()}
    prog = device_plane.registered_graph(
        lambda p, c, t, a: models.decode_step_multi(p, c, t, cfg,
                                                    active=a)[0],
        name="test::decode_step", fixed_argnums=(0, 1))
    rng = np.random.default_rng(1)
    active = torch.tensor([True, False, True], device=cuda)
    for i in range(6):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1))).to(
            cuda)
        want = models.decode_step_multi(params, cache_e, toks, cfg,
                                        active=active)[0]
        if i:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = prog(params, cache_c, toks, active)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert _close(got, want)[0], f"step {i}"
        for key in ("k", "v", "pos"):
            assert _close(cache_c[key].float(), cache_e[key].float())[0]
    assert cache_c["pos"].tolist() == [6, 0, 6]
    assert prog.captures == 1


def _engine_tokens(eng, prompts, new=6):
    sinks = [[] for _ in prompts]
    for p, s in zip(prompts, sinks):
        eng.submit(p, new, s.append)
    while eng.step():
        pass
    return sinks


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_captured_engine_matches_eager_and_recaptures_after_set_params(
        cuda, paged):
    """The engine's captured step against the same engine run eagerly
    (``cuda_graphs=False``): equal tokens; after ``set_params`` the step
    is captured again and follows the new weights (no prefix cache: its
    blocks hold the old weights' KV)."""
    cfg, params = _f32_model(cuda, "llama-debug", seed=0)
    _, other = _f32_model(cuda, "llama-debug", seed=1)
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7], [4] * 11]
    kw = dict(max_slots=3, max_len=32, block_size=4, prefill_chunk=4,
              paged=paged, prefix_cache=False, device=cuda)
    cap = LLMEngine(cfg, params, **kw)
    eag = LLMEngine(cfg, params, cuda_graphs=False, **kw)
    assert _engine_tokens(cap, prompts) == _engine_tokens(eag, prompts)
    assert cap._step_fn.captures == 1 and eag._step_fn.captures == 0
    for eng in (cap, eag):
        eng.set_params(other)
    assert cap._step_fn.captures == 0           # dropped with the params
    got = _engine_tokens(cap, prompts)
    assert got == _engine_tokens(eag, prompts)
    assert cap._step_fn.captures == 1
    fresh = LLMEngine(cfg, other, cuda_graphs=False, **kw)
    assert got == _engine_tokens(fresh, prompts)


def test_speculative_engine_self_draft_accepts_everything(cuda):
    """Speculation on the card with its verify and draft programs
    captured: a draft model that is the target proposes the target's own
    greedy tokens, so every proposal is accepted, and the tokens equal the
    plain engine's (which, with no proposal landing, the smoke's random
    drafts cannot show)."""
    from ray_tpu_torch.serve import SpeculativeLLMEngine

    cfg, params = _f32_model(cuda, "llama-debug")
    prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7], [4] * 11]
    kw = dict(max_slots=3, max_len=48, block_size=4, prefill_chunk=4,
              device=cuda)
    want = _engine_tokens(LLMEngine(cfg, params, **kw), prompts, new=16)
    spec = SpeculativeLLMEngine(cfg, params, drafter="model",
                                draft_params=params, spec_k=3, **kw)
    assert _engine_tokens(spec, prompts, new=16) == want
    st = spec.kv_state()["spec"]
    assert st["spec_accepted"] == st["spec_proposed"] > 0
    assert spec._verify_fn.captures == 1
    assert spec._draft._step.captures == 1


def test_second_signature_is_a_second_capture(cuda):
    """Another batch shape is a new capture and a retrace on the program's
    row, its signature diff kept; the first graph still replays."""
    cfg, params = _f32_model(cuda, "llama-debug")
    cache = models.init_cache_paged(cfg, 12, 4, device=cuda)
    name = "test::two_signatures"
    prog = device_plane.registered_graph(
        lambda p, c, *a: models.decode_step_paged(p, c, *a, cfg)[0],
        name=name, fixed_argnums=(0, 1))

    def inputs(b):
        return [torch.zeros(b, 4, dtype=torch.int64, device=cuda),
                torch.arange(b * 3, device=cuda).reshape(b, 3),
                torch.zeros(b, dtype=torch.int64, device=cuda),
                torch.ones(b, dtype=torch.int64, device=cuda)]

    for b in (2, 3, 2):
        assert prog(params, cache, *inputs(b)).shape == (b, cfg.vocab_size)
    assert prog.captures == 2
    row = device_plane.registry().program(name)
    assert row["compiles"] == 2 and row["retraces"] == 1 and row["calls"] == 3
    assert row["diffs"][0]["changed"]["args[2]"] == {
        "was": "int64[2,4]", "now": "int64[3,4]"}


def test_replay_refuses_a_moved_fixed_argument(cuda):
    prog = device_plane.registered_graph(lambda w, x: w @ x,
                                         name="test::fixed",
                                         fixed_argnums=(0,))
    w, x = torch.eye(8, device=cuda), torch.ones(8, 8, device=cuda)
    assert torch.equal(prog(w, x), x)
    assert torch.equal(prog(w, x * 2), x * 2)     # x is copied in
    with pytest.raises(RuntimeError, match="reset"):
        prog(w.clone(), x)
    prog.reset()
    assert torch.equal(prog(w.clone() * 3, x), x * 3)


def test_failed_capture_raises_without_a_fallback(cuda):
    """A program that waits for the device cannot be captured: the call
    raises (last in this file: a failed capture may leave the context
    unusable for work that follows)."""
    prog = device_plane.registered_graph(lambda x: x[x > 0].sum(),
                                         name="test::syncing")
    with pytest.raises(RuntimeError):
        prog(torch.ones(16, device=cuda))
    assert prog.captures == 0
