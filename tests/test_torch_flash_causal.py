"""K1's causal mode and K5 (the online multi-block kernel) in the port,
and the gradient through the flash wrapper.

The port's plain version is held against the JAX kernels (interpret mode on
CPU) and against `attention_core`; the autograd Function's gradients
against JAX's custom VJP. The CUDA kernel itself is checked on the card by
tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu.models.layers import attention_core
from openai_whisper_coreml_tpu.ops.flash_attention import flash_attention as jax_flash
from openai_whisper_coreml_tpu_torch.models import layers as tlayers
from openai_whisper_coreml_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

ATOL = 2e-5  # fp32 attention, as the K1 tests


def _qkv(rng, b, tq, tk, h, d=64):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, tq, h, d), (b, tk, h, d), (b, tk, h, d))]


def _causal_mask(t):
    return np.tril(np.ones((t, t), bool))[None, None]


@pytest.mark.parametrize("shape", [(2, 37, 37, 2), (1, 130, 130, 2),
                                   (1, 448, 448, 1)])
def test_causal_reference_matches_jax_kernel(rng, shape):
    q, k, v = _qkv(rng, *shape)
    ref = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), causal=True))
    ours = fa.flash_attention_reference(*map(torch.from_numpy, (q, k, v)),
                                        causal=True).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    core = np.asarray(attention_core(q, k, v, mask=_causal_mask(shape[1])))
    np.testing.assert_allclose(ours, core, atol=ATOL)


@pytest.mark.parametrize("shape,causal,block_k", [
    ((1, 200, 300, 2), False, 128),   # three KV blocks, ragged last block
    ((1, 256, 256, 2), True, 128),    # causal block skip
    ((1, 64, 1600, 1), False, None),  # Tk > 1536: JAX picks K5 itself
])
def test_multi_block_reference_matches_jax_online_kernel(rng, shape, causal,
                                                        block_k):
    """K5: JAX's online-softmax kernel (forced with online=True, or chosen
    by JAX for Tk > 1536) against the port's plain version, which is also
    what the one CUDA kernel computes for any Tk."""
    q, k, v = _qkv(rng, *shape)
    ref = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                               online=True, block_k=block_k))
    ours = fa.flash_attention_reference(*map(torch.from_numpy, (q, k, v)),
                                        causal=causal).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    mask = _causal_mask(shape[1]) if causal else None
    np.testing.assert_allclose(
        ours, np.asarray(attention_core(q, k, v, mask=mask)), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_function_gradients_match_jax_custom_vjp(rng, causal):
    q, k, v = _qkv(rng, 2, 40, 40, 2)
    g = rng.standard_normal(q.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jax_flash(*a, causal=causal),
                       *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ours = fa.flash_attention(*qkv, causal=causal)
    got = torch.autograd.grad(ours, qkv, torch.from_numpy(g))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(out), atol=ATOL)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_gradient_through_wrapper_equals_attention_core_gradient(rng, causal):
    """The gradient the ctypes output used to lose: on the CPU the wrapper's
    backward is exactly autograd through the plain attention."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 33, 33, 2))
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*qkv, causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, qkv, g)
    ref_in = [x.clone().requires_grad_() for x in (q, k, v)]
    mask = torch.ones(33, 33, dtype=torch.bool).tril() if causal else None
    want = torch.autograd.grad(tlayers.attention_core(*ref_in, mask=mask),
                               ref_in, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_causal_needs_aligned_queries_and_counts_nothing_on_cpu(rng):
    q, k, v = map(torch.from_numpy, _qkv(rng, 1, 8, 9, 1))
    with pytest.raises(ValueError, match="tq == tk"):
        fa.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="tq == tk"):
        fa.flash_attention_reference(q, k, v, causal=True)
    before = fa.launches, fa.launches_causal, fa.launches_online
    fa.flash_attention(k, k, v, causal=True)
    fa.flash_attention(q, torch.zeros(1, 1600, 1, 64), torch.zeros(1, 1600, 1, 64))
    assert (fa.launches, fa.launches_causal, fa.launches_online) == before


@pytest.mark.parametrize("flash", [False, True])
def test_self_attention_dispatch(rng, flash):
    """`layers.self_attention(causal=True, flash=...)`: the flash wrapper or
    the masked attention_core, as JAX's dispatch; both agree."""
    from openai_whisper_coreml_tpu_torch.models.layers import Attention

    n, h = 128, 2
    p = {name: {"w": torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)
                                      / np.sqrt(n))}
         for name in ("q", "k", "v", "out")}
    attn = Attention(p, h)
    x = torch.from_numpy(rng.standard_normal((2, 30, n)).astype(np.float32))
    calls = []
    real = tlayers.flash_attention
    tlayers.flash_attention = lambda *a, **kw: calls.append(kw) or real(*a, **kw)
    try:
        out = tlayers.self_attention(x, attn, causal=True, flash=flash)
    finally:
        tlayers.flash_attention = real
    assert calls == ([{"causal": True}] if flash else [])
    other = tlayers.self_attention(x, attn, causal=True, flash=not flash)
    torch.testing.assert_close(out, other, rtol=0, atol=ATOL)
