"""The Hopper kernels (flash attention, log-mel) against their plain
versions, on the card.

These tests need an NVIDIA GPU and nvcc, and skip elsewhere. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from openai_whisper_coreml_tpu_torch import audio as taudio
from openai_whisper_coreml_tpu_torch.ops import flash_attention as fa
from openai_whisper_coreml_tpu_torch.ops import mel_kernel as mk


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


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n_samples,n_mels", [(4, 480_000, 128),
                                                   (3, 16_000 * 7, 80),
                                                   (1, 16_000 + 160 * 37, 128)])
def test_mel_kernel_matches_plain_version_on_card(batch, n_samples, n_mels):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(batch, n_samples, generator=g, device="cuda") * 0.1
    padded = torch.nn.functional.pad(x[:, None], (200, 200), mode="reflect")[:, 0]
    before = mk.launches
    out = mk.log_mel_kernel(padded, n_mels)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    assert out.shape == (batch, n_samples // 160, n_mels)
    err = (out - mk.log_mel_kernel_reference(padded, n_mels)).abs()
    assert err.max().item() <= 1e-4
    # the frontend sends CUDA audio through the kernel
    mel = taudio.log_mel_spectrogram(x, n_mels)
    assert mk.launches == before + 2
    assert mel.shape == (batch, n_mels, n_samples // 160)


@pytest.mark.cuda
def test_mel_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the kernel has no CPU mode)")
    with pytest.raises(ValueError, match="n_mels % 4"):
        mk.log_mel_kernel(torch.zeros(1, 560, device="cuda"), 81)
    with pytest.raises(ValueError, match="160 T"):
        mk.log_mel_kernel(torch.zeros(1, 561, device="cuda"), 80)
    with pytest.raises(TypeError, match="fp32"):
        mk.log_mel_kernel(torch.zeros(1, 560, device="cuda").half(), 80)
    # the kernel checks the tables' row width against its own bin tiling
    cw, sw, fbt, ranges = mk._tables(80, torch.device("cuda"))
    x, out = torch.zeros(1, 560, device="cuda"), torch.empty(1, 1, 80, device="cuda")
    err = mk.load_kernel().whisper_log_mel_f32(
        x.data_ptr(), 560, 560, 1, 1, cw.data_ptr(), sw.data_ptr(), mk.BINS_PAD - 8,
        fbt.data_ptr(), ranges.data_ptr(), 80, out.data_ptr(), None)
    assert err == 1  # cudaErrorInvalidValue, before any launch
