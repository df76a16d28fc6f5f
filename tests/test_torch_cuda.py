"""The port's kernels on the card: the Hopper flash-attention forward and
backward (dQ, dK/dV), at head dims 64, 128 and 256, against their plain
PyTorch versions, and the CUDA autograd path running them. The serving
engine's programs captured as CUDA graphs (``util.device_plane``) against
the same programs run eagerly; a param swap releasing the step's graph
pool, and ``remat_policy="save_attn"`` running the forward kernel once a
layer; KV blocks through the device channel and back onto the card; data
batches uploaded from reused pinned buffers, and consumed on a side stream;
``XlaGroup`` over the card's NCCL.

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


def test_capture_survives_a_graph_the_collector_frees(cuda):
    """A captured program left in a reference cycle is freed by the garbage
    collector, and freeing its graph resets it, which is not permitted
    while another capture runs: a capture collects what is garbage before
    it begins. The program captured here runs a collection inside its
    capture, as an allocation can trigger one; automatic collection is
    off in this test until then, so the cycle is still there."""
    import gc

    class Holder:
        pass

    calls = []

    def collects_when_captured(x):
        calls.append(1)
        if len(calls) == 2:          # the warm-up run, then the capture
            gc.collect()
        return x + 1

    gc.disable()
    try:
        old = Holder()
        old.cycle = old
        old.prog = device_plane.registered_graph(lambda x: x * 2,
                                                 name="test::garbage")
        old.prog(torch.ones(8, device=cuda))
        assert old.prog.captures == 1
        del old
        prog = device_plane.registered_graph(collects_when_captured,
                                             name="test::after_garbage")
        out = prog(torch.ones(8, device=cuda))
        assert len(calls) == 2 and prog.captures == 1
        assert torch.equal(out, torch.full((8,), 2.0, device=cuda))
    finally:
        gc.enable()


def test_dropping_params_releases_the_step_graph_pool(cuda):
    """A param swap drops the engine's captured graphs: after
    ``drop_params`` the card's reserved memory falls by at least the graph
    pool the step's capture added (the params themselves stay held here),
    and a multiplexed replica's evicted model keeps no capture."""
    import gc

    from ray_tpu_torch.serve import MultiplexedLLMDeployment

    cfg, params = _f32_model(cuda, "llama-debug")
    cfg = cfg.replace(d_model=256, d_ff=512, n_heads=4, n_kv_heads=2)
    params = models.init_params(torch.Generator(device=cuda).manual_seed(0),
                                cfg, device=cuda)
    eng = LLMEngine(cfg, params, max_slots=4, max_len=128, block_size=16,
                    prefill_chunk=16, device=cuda)
    _engine_tokens(eng, [[1, 2, 3, 4, 5]], new=4)
    pool = device_plane.registry().program(
        "serve::decode_step_paged")["memory"]["graph_pool_bytes"]
    assert eng._step_fn.captures == 1 and pool > 0

    def settle():
        # cuBLAS keeps a workspace a stream, allocated during the capture
        # from the graph's pool: drop it, or it pins that pool
        gc.collect()
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
    settle()
    before = torch.cuda.memory_reserved(cuda)
    eng.drop_params()
    settle()
    released = before - torch.cuda.memory_reserved(cuda)
    assert eng._step_fn.captures == 0
    assert released >= pool, (released, pool)

    one = sum(t.numel() * t.element_size() for t in
              [*params["layers"].values()]
              + [v for k, v in params.items() if k != "layers"])
    spec = {"m0": {"config": cfg, "seed": 0}, "m1": {"config": cfg,
                                                     "seed": 1}}
    dep = MultiplexedLLMDeployment(spec, budget_bytes=one + 1, max_slots=2,
                                   max_len=64, block_size=16,
                                   prefill_chunk=16, device=cuda)
    try:
        list(dep([1, 2, 3], 3, model_id="m0"))
        e0 = dep._deps["m0"].engine
        assert e0._step_fn.captures == 1
        list(dep([1, 2, 3], 3, model_id="m1"))     # evicts m0
        assert e0.params is None and e0._step_fn.captures == 0
        assert dep.registry.snapshot()["m0"]["swaps_out"] == 1
    finally:
        dep.close()


def test_save_attn_runs_the_forward_kernel_once_a_layer(cuda):
    """``remat_policy="save_attn"`` on the card: a training step launches
    the forward kernel once a layer (full remat: twice) and the dQ and
    dK/dV kernels once a layer, with the same loss and grads as full
    remat, bitwise (the kernels and the recompute are deterministic)."""
    cfg = models.llama_debug().replace(
        d_model=256, d_ff=512, n_heads=4, n_kv_heads=2, dtype="bfloat16",
        param_dtype="float32", remat=True)
    params = models.init_params(torch.Generator(device=cuda).manual_seed(0),
                                cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 129), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    out = {}
    for policy in ("full", "save_attn"):
        c = cfg.replace(remat_policy=policy)
        leaves = {k: t.detach().clone().requires_grad_(True)
                  for k, t in params["layers"].items()}
        p = dict(params, layers=leaves)
        before = (flash_cuda.launches, flash_cuda.launches_dq,
                  flash_cuda.launches_dkv)
        loss, _ = models.loss_and_metrics(p, {"tokens": toks}, c)
        loss.backward()
        torch.cuda.synchronize()
        counts = tuple(a - b for a, b in zip(
            (flash_cuda.launches, flash_cuda.launches_dq,
             flash_cuda.launches_dkv), before))
        out[policy] = (counts, loss.detach(),
                       {k: t.grad for k, t in leaves.items()})
    L = cfg.n_layers
    assert out["full"][0] == (2 * L, L, L)
    assert out["save_attn"][0] == (L, L, L)
    assert torch.equal(out["full"][1], out["save_attn"][1])
    for k, g in out["full"][2].items():
        assert torch.equal(g, out["save_attn"][2][k]), k


def test_device_channel_carries_card_kv_blocks_bitwise(cuda):
    """KV blocks gathered on the card, written to the device channel (one
    device-to-host copy into the slot), read back (a bare tensor aliases
    the slot, a ``TensorWithMeta`` is a copy) and scattered onto the card
    again through ``scatter_kv_blocks``: bitwise the original blocks."""
    import uuid

    from ray_tpu_torch.experimental.device_channel import (DeviceChannel,
                                                           TensorWithMeta)

    gen = torch.Generator(device=cuda).manual_seed(0)
    shape = (4, 8, 16, 2, 128)              # [L, blocks, bs, kvh, hd]
    src = {n: torch.randn(shape, generator=gen, device=cuda,
                          dtype=torch.bfloat16) for n in ("k", "v")}
    kv = models.gather_kv_blocks(src, torch.tensor([3, 1, 4], device=cuda))
    name = f"test-card-{uuid.uuid4().hex[:8]}"
    ch = DeviceChannel(name, capacity=1 << 22, create=True, slots=2)
    try:
        reader = DeviceChannel(name, create=False)
        ch.write(kv["k"], timeout=10)
        ch.write(TensorWithMeta({"req": "r"}, kv["v"]), timeout=10)
        got_k = reader.read(timeout=10)
        got_v = reader.read(timeout=10)
        assert got_k.device.type == "cpu" and got_k.dtype == torch.bfloat16
        assert got_v.meta == {"req": "r"}
        dst = {n: torch.zeros(shape, device=cuda, dtype=torch.bfloat16)
               for n in ("k", "v")}
        models.scatter_kv_blocks(
            dst, torch.tensor([0, 2, 5, 8], device=cuda),
            {"k": torch.cat([got_k, got_k[:, :1]], 1).to(cuda),
             "v": torch.cat([got_v.tensor, got_v.tensor[:, :1]], 1).to(cuda)})
        for n in ("k", "v"):
            assert torch.equal(dst[n][:, [0, 2, 5]].view(torch.int16),
                               src[n][:, [3, 1, 4]].view(torch.int16)), n
        del got_k
        reader.close()
    finally:
        ch.unlink()


class _BlockList:
    """A stand-in dataset whose refs are the blocks themselves (the
    runtime's ``get`` is stubbed to the identity)."""

    def __init__(self, blocks):
        self.blocks = blocks

    def iter_block_refs(self):
        return iter(self.blocks)


def _device_batches(monkeypatch, blocks, **kw):
    import ray_tpu_torch
    from ray_tpu_torch.data.iterator import DataIterator

    monkeypatch.setattr(ray_tpu_torch, "get", lambda r: r)
    it = DataIterator(_BlockList(blocks))
    return it, it.iter_torch_batches(**kw)


def test_pinned_buffers_reused_across_many_batches(cuda, monkeypatch):
    """320 batches through the 3 pinned slots while the copy stream lags
    (a sleep queued on it before every upload) and nothing on the host
    waits for the card until the end: every batch on the card equals its
    host batch (a slot rewritten before its upload read it would give a
    later batch's rows), cast to int64 on the card from uint16."""
    from ray_tpu_torch.data import iterator

    upload = iterator._upload

    def lagging_upload(bufs, stream, dev):
        with torch.cuda.stream(stream):
            torch.cuda._sleep(1_000_000)
        return upload(bufs, stream, dev)

    monkeypatch.setattr(iterator, "_upload", lagging_upload)
    rng = np.random.default_rng(0)
    blocks = [{"tokens": rng.integers(0, 60000, (64, 257)).astype(
        np.uint16)} for _ in range(20)]
    _, batches = _device_batches(monkeypatch, blocks, batch_size=4,
                                 device="cuda",
                                 dtypes={"tokens": torch.int64})
    host = np.concatenate([b["tokens"] for b in blocks]).astype(np.int64)
    got = []
    for batch in batches:
        got.append(batch["tokens"])
        assert batch["tokens"].dtype == torch.int64
        assert batch["tokens"].device.type == "cuda"
    assert len(got) == 320 > 100 * iterator.PINNED_SLOTS
    torch.cuda.synchronize()
    bad = [i for i, g in enumerate(got)
           if not torch.equal(g.cpu(), torch.from_numpy(host[4 * i:4 * i + 4]))]
    assert not bad, bad[:8]


def test_batch_consumed_on_a_side_stream(cuda, monkeypatch):
    """A batch taken while a side stream is current is ready on that stream
    and stays valid there after the iterator moves on and frees nothing
    under it."""
    rng = np.random.default_rng(1)
    blocks = [{"x": rng.standard_normal((32, 1024)).astype(np.float32)}
              for _ in range(8)]
    _, batches = _device_batches(monkeypatch, blocks, batch_size=8,
                                 device="cuda")
    side = torch.cuda.Stream()
    sums = []
    with torch.cuda.stream(side):
        for batch in batches:
            torch.cuda._sleep(1_000_000)      # the side stream lags
            sums.append(batch["x"].double().sum(1))
    torch.cuda.synchronize()
    host = np.concatenate([b["x"] for b in blocks]).astype(np.float64)
    want = host.sum(1)
    np.testing.assert_allclose(torch.cat(sums).cpu().numpy(), want,
                               rtol=1e-12)


def test_xla_group_on_the_card_matches_the_plain_version(cuda):
    """``XlaGroup`` over every card this process sees (NCCL), each verb
    against the plain path on the same CPU inputs."""
    from ray_tpu_torch.collective import collective as col
    from ray_tpu_torch.collective.types import ReduceOp

    n = torch.cuda.device_count()
    g = col.XlaGroup(n, 0, "card")
    plain = col.XlaGroup(n, 0, "plain", device="cpu")
    xs = [torch.randint(-8, 9, (4096,)).float() for _ in range(n)]
    on = [x.to(f"cuda:{i}") for i, x in enumerate(xs)]
    for op in ReduceOp:
        for got, want in zip(g.allreduce(on, op=op),
                             plain.allreduce(xs, op=op)):
            assert got.device.type == "cuda"
            torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0)
    for name in ("allgather", "broadcast", "reduce"):
        for got, want in zip(getattr(g, name)(on), getattr(plain, name)(xs)):
            assert torch.equal(got.cpu(), want), name
    rs = [torch.arange(4 * n, dtype=torch.float32) + i for i in range(n)]
    for got, want in zip(g.reducescatter([r.to(f"cuda:{i}") for i, r in
                                          enumerate(rs)]),
                         plain.reducescatter(rs)):
        assert torch.equal(got.cpu(), want)
    pairs = [(i, (i + 1) % n) for i in range(n)]
    for got, want in zip(g.permute(on, pairs), plain.permute(xs, pairs)):
        assert torch.equal(got.cpu(), want)
    g.barrier()


def test_failed_capture_raises_without_a_fallback(cuda):
    """A program that waits for the device cannot be captured: the call
    raises (last in this file: a failed capture may leave the context
    unusable for work that follows)."""
    prog = device_plane.registered_graph(lambda x: x[x > 0].sum(),
                                         name="test::syncing")
    with pytest.raises(RuntimeError):
        prog(torch.ones(16, device=cuda))
    assert prog.captures == 0


# -- the runtime on the card ------------------------------------------------

@pytest.fixture
def runtime(cuda):
    import os

    import ray_tpu_torch as rt

    saved = {k: os.environ.get(k) for k in ("RTPU_STORE_CAPACITY",
                                            "RTPU_STORE_PREFAULT_BYTES")}
    os.environ.update(RTPU_STORE_CAPACITY=str(256 << 20),
                      RTPU_STORE_PREFAULT_BYTES=str(16 << 20))
    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_cuda_tensor_put_comes_back_on_the_cpu(runtime):
    rt = runtime
    gen = torch.Generator(device="cuda").manual_seed(0)
    value = {"w": torch.randn(512, 256, generator=gen, device="cuda").to(
                 torch.bfloat16),
             "ids": torch.arange(4096, device="cuda")}
    got = rt.get(rt.put(value))
    for k, want in value.items():
        assert got[k].device.type == "cpu" and got[k].dtype == want.dtype
        assert torch.equal(got[k].view(torch.uint8) if k == "ids" else
                           got[k].view(torch.int16),
                           (want.view(torch.uint8) if k == "ids" else
                            want.view(torch.int16)).cpu())

    @rt.remote
    def reader(d):
        import torch

        return d["w"].device.type, torch.cuda.is_initialized()

    # a worker that reads it stays off the card
    assert rt.get(reader.remote(rt.put(value))) == ("cpu", False)


def test_gpu_actor_that_opts_in_reaches_the_card(runtime):
    rt = runtime
    assert rt.available_resources().get("GPU", 0) >= 1

    @rt.remote
    def plain():
        import torch

        return torch.cuda.is_available(), torch.cuda.is_initialized()

    @rt.remote(num_gpus=1,
               runtime_env={"env_vars": {"CUDA_VISIBLE_DEVICES": "0"}})
    class OnCard:
        def run(self):
            import torch

            x = torch.ones(1024, device="cuda")
            return (torch.cuda.get_device_name(0), float(x.sum()),
                    x * 2)

    assert rt.get(plain.remote()) == (False, False)
    a = OnCard.remote()
    name, total, doubled = rt.get(a.run.remote())
    assert name == torch.cuda.get_device_name(0) and total == 1024.0
    assert doubled.device.type == "cpu" and float(doubled.sum()) == 2048.0
    rt.kill(a)


def test_trainer_on_the_card_launches_the_kernels_in_its_worker(runtime,
                                                                 tmp_path):
    """``TorchTrainer`` with one ``use_gpu`` worker: the loop runs in the
    worker's own process on its card, and its steps go through the three
    kernels there (remat off: one forward, one dK/dV and one dQ launch a
    layer a step)."""
    import json
    import os

    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    def loop():
        import os

        import torch

        from ray_tpu_torch import models, train
        from ray_tpu_torch.ops import flash_cuda
        from ray_tpu_torch.train import TrainLoopHelper, adamw

        cfg = models.llama_debug().replace(head_dim=64)
        gen = torch.Generator(device="cuda").manual_seed(0)
        helper = TrainLoopHelper.create(
            lambda: models.init_params(gen, cfg, device="cuda"),
            lambda p, b: models.loss_and_metrics(p, b, cfg), adamw(1e-3))
        tokens = torch.randint(0, cfg.vocab_size, (2, 129), generator=gen,
                               device="cuda")
        for _ in range(2):
            flash_cuda.launches = flash_cuda.launches_dkv = 0
            flash_cuda.launches_dq = 0
            m = helper.run_step({"tokens": tokens})
            train.report({"loss": m["loss"].item(), "pid": os.getpid(),
                          "device": str(helper.device),
                          "launches": [flash_cuda.launches,
                                       flash_cuda.launches_dkv,
                                       flash_cuda.launches_dq]})

    result = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(storage_path=str(tmp_path))).fit()
    with open(os.path.join(result.path, "progress.jsonl")) as f:
        reports = [json.loads(line) for line in f]
    assert len(reports) == 2
    for r in reports:
        assert r["pid"] != os.getpid() and r["device"] == "cuda"
        assert r["launches"] == [2, 2, 2]
        assert np.isfinite(r["loss"])


def test_tensor_edge_carries_a_card_bf16_tensor_between_card_stages(runtime):
    """A compiled DAG whose two stages are actors on the card (half a GPU
    each): stage A makes a bf16 tensor on a side stream and returns it
    unsynchronised on a tensor edge (the channel's write must wait for
    it); stage B gets it on the card and returns it with its argmax on a
    tensor edge to this process, which reads it on the CPU. Bitwise the
    tensor this process draws from the same seed."""
    import glob

    rt = runtime
    from ray_tpu_torch.dag import InputNode

    on_card = dict(num_gpus=0.5, max_concurrency=2, runtime_env={
        "env_vars": {"CUDA_VISIBLE_DEVICES": "0"}})

    class Make:
        def make(self, seed):
            import torch

            gen = torch.Generator(device="cuda").manual_seed(seed)
            x = torch.randn(64, 4096, generator=gen, device="cuda")
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                y = (x * 3.0).to(torch.bfloat16)
            return y

    class Relay:
        def relay(self, y):
            from ray_tpu_torch.experimental.device_channel import \
                TensorWithMeta

            return TensorWithMeta({"device": y.device.type,
                                   "argmax": y.argmax(-1).tolist()}, y)

    a = rt.remote(Make).options(**on_card).remote()
    b = rt.remote(Relay).options(**on_card).remote()
    with InputNode() as inp:
        mid = a.make.bind(inp).with_tensor_transport()
        out = b.relay.bind(mid).with_tensor_transport()
    compiled = out.experimental_compile(max_in_flight=2,
                                        buffer_size_bytes=1 << 20)
    paths = [ch.path for ch in compiled._channels]
    try:
        futs = [compiled.execute(seed, timeout=60) for seed in range(4)]
        got = [futs[i].get(timeout=120) for i in (3, 1, 0, 2)]
        got = dict(zip((3, 1, 0, 2), got))
    finally:
        compiled.teardown()
        rt.kill(a)
        rt.kill(b)
    assert not any(glob.glob(p) for p in paths)
    for seed, res in got.items():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        want = (torch.randn(64, 4096, generator=gen, device="cuda")
                * 3.0).to(torch.bfloat16).cpu()
        assert res.meta["device"] == "cuda"
        assert res.tensor.device.type == "cpu"
        assert torch.equal(res.tensor.view(torch.int16),
                           want.view(torch.int16)), seed
        assert res.meta["argmax"] == want.argmax(-1).tolist()
