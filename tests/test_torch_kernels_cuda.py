"""The Hopper flash kernel against its plain version, on the card.

These tests need an NVIDIA GPU and nvcc, and skip elsewhere. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from openai_whisper_coreml_tpu_torch.ops import flash_attention as fa


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 1e-2), (torch.float32, 2e-5)])
@pytest.mark.parametrize("shape", [(4, 1500, 1500, 20), (1, 77, 77, 2),
                                   (2, 100, 300, 2)])
def test_kernel_matches_plain_version_on_card(shape, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    b, tq, tk, h = shape
    q = torch.randn(b, tq, h, 64, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, tk, h, 64, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, tk, h, 64, generator=g, device="cuda").to(dtype)
    before = fa.launches
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    err = (out.float() - fa.flash_attention_reference(q, k, v).float()).abs()
    assert err.max().item() <= atol
    assert err.mean().item() <= (1e-3 if dtype == torch.bfloat16 else atol)


@pytest.mark.cuda
def test_kernel_reads_strided_views_and_rejects_other_shapes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(2, 300, 3, 4, 64, generator=g, device="cuda").bfloat16()
    q, k, v = qkv.unbind(2)  # (B, T, H, D) views with a 3x head stride
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_reference(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2
    with pytest.raises(ValueError, match="D=64"):
        fa.flash_attention(*(torch.zeros(1, 8, 2, 32, device="cuda"),) * 3)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fa.flash_attention(*(torch.zeros(1, 8, 2, 64, device="cuda").half(),) * 3)
