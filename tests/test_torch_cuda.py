"""The port's kernel on the card: the Hopper flash-attention forward against
its plain PyTorch version, and the CUDA autograd path's missing backward.

Marked ``cuda``; each test skips (with the reason) where no GPU is
present. This file imports no JAX, so on a GPU machine without JAX it runs
alone (the repo's conftest imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from ray_tpu_torch.ops import attention, flash_cuda

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


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn(1, 16, 2, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_cuda.flash_attention_fwd(q, q, q)
    q = torch.randn(1, 16, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_cuda.flash_attention_fwd(q, q, q)


def test_cuda_flash_attention_backward_raises(cuda):
    q = torch.randn(1, 64, 2, 64, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    out = attention.flash_attention(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()
    with pytest.raises(ValueError, match="cannot run on cuda"):
        attention.flash_attention(q, q, q, impl="blockwise")
