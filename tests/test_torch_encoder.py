"""Port encoder against the JAX encoder (fp32, same weights)."""

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models import encoder as jenc
from openai_whisper_coreml_tpu.models.layers import sinusoids as jax_sinusoids
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu.quantize import quantize_params as jax_quantize
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.models.layers import sinusoids
from openai_whisper_coreml_tpu_torch.params import count_params, from_jax_params

# tiny tensors: one torch thread per test worker keeps parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

N_CTX = 64


def _pair(quant=False, **kw):
    jcfg = jax_tiny(n_audio_ctx=N_CTX, **kw)
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    if quant:
        params = jax_quantize(params, min_size=0)
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            tiny_test_config(n_audio_ctx=N_CTX, **kw))
    return jcfg, params, model


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_encoder_matches_jax(flash, quant):
    jcfg, params, model = _pair(quant)
    mel = np.random.default_rng(5).standard_normal(
        (2, 80, 2 * N_CTX)).astype(np.float32)
    ref = np.asarray(jenc.encode(params, jcfg, mel, flash=flash))
    ours = model.encode(mel)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(model.encode(mel[0]).numpy(), ref[0], atol=1e-4)


def test_encoder_head_dim_64_matches_jax():
    """D=64, the head dim the Hopper kernel is built for."""
    jcfg, params, model = _pair(n_state=128, n_head=2)
    mel = np.random.default_rng(6).standard_normal(
        (1, 80, 2 * N_CTX)).astype(np.float32)
    ref = np.asarray(jenc.encode(params, jcfg, mel, flash=True))
    np.testing.assert_allclose(model.encode(mel).numpy(), ref, atol=1e-4)


def test_encoder_rejects_wrong_context():
    _, _, model = _pair()
    with pytest.raises(ValueError, match="audio context"):
        model.encode(np.zeros((1, 80, 2 * N_CTX + 8), np.float32))


def test_sinusoids_and_param_count_match_jax():
    ours, ref = sinusoids(1500, 64).numpy(), np.asarray(jax_sinusoids(1500, 64))
    # a 1-ulp difference between the two exp implementations (6e-8) grows to
    # 1500 * 6e-8 = 9e-5 in the angle at the last positions
    np.testing.assert_allclose(ours[:64], ref[:64], atol=1e-5)
    np.testing.assert_allclose(ours, ref, atol=2e-4)
    _, params, model = _pair()
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert count_params(model) == n_jax == model.num_params
