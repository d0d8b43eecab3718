"""K1 port: the flash wrapper's plain version against the JAX kernel
(interpret mode on CPU). The kernel itself is checked on the card by
tests/test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu.models.layers import attention_core
from openai_whisper_coreml_tpu.ops.flash_attention import flash_attention as jax_flash
from openai_whisper_coreml_tpu_torch.ops import flash_attention as fa

# tiny tensors: one torch thread per test worker keeps parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)


def _qkv(rng, b, tq, tk, h, d=64):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, tq, h, d), (b, tk, h, d), (b, tk, h, d))]


@pytest.mark.parametrize("shape", [(1, 1500, 1500, 2), (2, 300, 300, 2),
                                   (2, 77, 200, 2)])
def test_reference_matches_jax_kernel(rng, shape):
    q, k, v = _qkv(rng, *shape)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    ours = fa.flash_attention_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(attention_core(q, k, v)),
                               atol=2e-5)


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing(rng):
    q, k, v = map(torch.from_numpy, _qkv(rng, 1, 40, 40, 2, d=32))
    before = fa.launches
    out = fa.flash_attention(q, k, v)
    assert fa.launches == before
    torch.testing.assert_close(out, fa.flash_attention_reference(q, k, v),
                               rtol=0, atol=0)
    assert out.dtype == torch.float32 and out.shape == q.shape


def test_wrapper_rejects_other_devices(rng):
    q, k, v = map(torch.from_numpy, _qkv(rng, 1, 8, 8, 1))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        fa.flash_attention(q, k.to("meta"), v)


def test_bf16_plain_version_rounds_like_the_kernel(rng):
    """bf16 inputs: q scaling and P are rounded to bf16, l and the sums stay
    fp32 — within bf16 output rounding of the all-fp32 product."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(rng, 2, 65, 130, 2))
    out = fa.flash_attention_reference(q, k, v)
    assert out.dtype == torch.bfloat16
    exact = fa.flash_attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - exact).abs().max() < 1e-2
