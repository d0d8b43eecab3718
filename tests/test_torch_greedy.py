"""Port greedy decode loop against the JAX `greedy_decode_core`: tokens
exact, sum_logprobs <= 1e-4 and no_speech_prob <= 1e-5 (fp32, same weights),
against both the flat and the two-level JAX loops."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import decoding as jdecoding
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu.quantize import quantize_params as jax_quantize
from openai_whisper_coreml_tpu.tokenizer import get_tokenizer as jax_tokenizer
from openai_whisper_coreml_tpu_torch import decoding as tdecoding
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.params import from_jax_params

# tiny tensors: one torch thread per test worker keeps parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

N_CTX = 32
TEXT_CTX = 96
SAMPLE_LEN = 60


@pytest.fixture(scope="module", params=["float", "int8"])
def setup(request):
    jcfg = jax_tiny(n_audio_ctx=N_CTX, n_text_ctx=TEXT_CTX)
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    if request.param == "int8":
        params = jax_quantize(params, min_size=0)
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            tiny_test_config(n_audio_ctx=N_CTX, n_text_ctx=TEXT_CTX))
    feats = np.random.default_rng(3).standard_normal(
        (3, N_CTX, jcfg.n_text_state)).astype(np.float32)
    tok = jax_tokenizer(jcfg, language="en")
    opts = jdecoding.DecodingOptions(language="en")
    masks = (jdecoding.build_suppress_mask(tok, opts),
             jdecoding.build_blank_mask(tok))
    return jcfg, params, model, feats, tok, masks


def _compare(setup, initial, pad, sot, prompt_len, kv_dtype, two_level):
    jcfg, params, model, feats, _, (sup, blank) = setup
    ref = jdecoding.greedy_decode_core(
        params, jcfg, jnp.asarray(feats), jnp.asarray(initial),
        jnp.asarray(sup), jnp.asarray(blank), jnp.float32(0.0),
        jax.random.PRNGKey(0), jnp.int32(50), jnp.asarray(pad, jnp.int32),
        jnp.asarray(sot, jnp.int32), sample_len=SAMPLE_LEN,
        use_timestamps=True, prompt_len=prompt_len, kv_dtype=kv_dtype,
        two_level=two_level)
    ref = [np.asarray(r) for r in ref]
    ours = tdecoding.greedy_decode_core(
        model.decoder, torch.from_numpy(feats), torch.from_numpy(initial),
        torch.from_numpy(sup), torch.from_numpy(blank), 50,
        torch.as_tensor(pad), torch.as_tensor(sot), sample_len=SAMPLE_LEN,
        use_timestamps=True, prompt_len=prompt_len, kv_dtype=kv_dtype)
    ours = [o.numpy() for o in ours]
    np.testing.assert_array_equal(ours[0], ref[0])  # tokens
    np.testing.assert_array_equal(ours[2], ref[2])  # n_sampled
    np.testing.assert_allclose(ours[1], ref[1], atol=1e-4)  # sum_logprobs
    np.testing.assert_allclose(ours[3], ref[3], atol=1e-5)  # no_speech_prob
    return ours


@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_greedy_token_exact(setup, kv_dtype, two_level):
    _, _, _, feats, tok, _ = setup
    b = feats.shape[0]
    initial = np.tile(np.asarray([[tok.eot, tok.sot, tok.language_token("en"),
                                   tok.transcribe]], np.int32), (b, 1))
    tokens, _, n_sampled, _ = _compare(setup, initial, 1, 1, 4, kv_dtype,
                                       two_level)
    assert n_sampled.min() > 1  # the rules ran past the first step


def test_greedy_per_sample_left_padded_prompt(setup):
    _, _, _, feats, tok, _ = setup
    sot_seq = [tok.sot, tok.language_token("en"), tok.transcribe]
    prompts = [[], [11, 12, 13], list(range(40, 60))]
    rows = [([tok.sot_prev] + p if p else []) + sot_seq for p in prompts]
    bucket = 32
    pads = [bucket - len(r) for r in rows]
    initial = np.asarray([[tok.eot] * p + r for p, r in zip(pads, rows)],
                         np.int32)
    sots = [p + r.index(tok.sot) for p, r in zip(pads, rows)]
    _compare(setup, initial, np.asarray(pads), np.asarray(sots), bucket,
             "bf16", False)
