"""Port decoder (cache writes, decode_step, teacher forcing, int8 cross-KV)
against the JAX decoder (fp32, same weights)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models import decoder as jdec
from openai_whisper_coreml_tpu.ops.sqa_int8 import quantize_kv_column as jax_qkv
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu.quantize import quantize_params as jax_quantize
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.models import decoder as tdec
from openai_whisper_coreml_tpu_torch.params import from_jax_params

# tiny tensors: one torch thread per test worker keeps parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

N_CTX = 32


@pytest.fixture(scope="module", params=["float", "int8"])
def pair(request):
    jcfg = jax_tiny(n_audio_ctx=N_CTX, n_text_ctx=96)
    params = jax_init(jcfg, jax.random.PRNGKey(1))
    if request.param == "int8":
        params = jax_quantize(params, min_size=0)
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            tiny_test_config(n_audio_ctx=N_CTX, n_text_ctx=96))
    feats = np.random.default_rng(2).standard_normal(
        (3, N_CTX, jcfg.n_text_state)).astype(np.float32)
    return jcfg, params, model, feats


def _tokens(cfg, b, t, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.timestamp_begin, size=(b, t)).astype(np.int32)


def test_decoder_forward_matches_jax(pair):
    jcfg, params, model, feats = pair
    toks = _tokens(jcfg, 3, 7)
    ref = np.asarray(jdec.decoder_forward(params, jcfg, toks, feats))
    ours = model.logits(toks, torch.from_numpy(feats))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("valid_from", ["scalar", "per_row"])
def test_decode_step_prefill_and_step_match_jax(pair, kv_dtype, valid_from):
    jcfg, params, model, feats = pair
    b, p, ctx = 3, 6, 32
    vf = 2 if valid_from == "scalar" else np.array([0, 2, 5], np.int32)
    toks = _tokens(jcfg, b, p)
    if kv_dtype == "int8":
        jx = jdec.precompute_cross_kv_int8(params, jcfg, feats)
        tx = tdec.precompute_cross_kv_int8(model.decoder, torch.from_numpy(feats))
    else:
        jx = jdec.precompute_cross_kv(params, jcfg, feats)
        tx = tdec.precompute_cross_kv(model.decoder, torch.from_numpy(feats))
    for a, c in zip(jx, tx):
        np.testing.assert_allclose(c.numpy(), np.asarray(a), atol=1e-5)
    jcache = jdec.init_kv_cache(jcfg, b, ctx=ctx)
    tcache = tdec.init_kv_cache(model.cfg, b, torch.float32, "cpu", ctx=ctx)
    tvf = torch.as_tensor(vf)
    ref, jcache = jdec.decode_step(params, jcfg, toks, jx, jcache, 0,
                                   valid_from=jnp.asarray(vf))
    ours, tcache = tdec.decode_step(model.decoder, torch.from_numpy(toks).long(),
                                    tx, tcache, 0, valid_from=tvf)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    nxt = _tokens(jcfg, b, 1, seed=4)
    ref, jcache = jdec.decode_step(params, jcfg, nxt, jx, jcache, p,
                                   valid_from=jnp.asarray(vf))
    ours, tcache = tdec.decode_step(model.decoder, torch.from_numpy(nxt).long(),
                                    tx, tcache, p, valid_from=tvf)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    for a, c in zip(jcache, tcache):
        np.testing.assert_allclose(c.numpy(), np.asarray(a), atol=1e-4)


def test_quantize_kv_column_matches_jax(rng):
    x = rng.standard_normal((2, 3, 64, 50)).astype(np.float32)
    # exact half-way ties: column max 127 makes the scale 1.0
    x[0, 0, :, 0] = np.linspace(-10.5, 10.5, 64)
    x[0, 0, 0, 0] = 127.0
    q_ref, s_ref = (np.asarray(a) for a in jax_qkv(jnp.asarray(x)))
    q, s = tdec.quantize_kv_column(torch.from_numpy(x))
    assert q.dtype == torch.int8 and tuple(s.shape) == s_ref.shape
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-7)
    diff = np.abs(q.numpy().astype(np.int32) - q_ref.astype(np.int32))
    assert diff.max() <= 1
    # any difference must sit on an exact .5 tie of x / scale
    ratio = x / s_ref
    assert np.all(np.abs(np.abs(ratio - np.floor(ratio)) - 0.5)[diff > 0] < 1e-4)


def test_embed_tokens_per_row_positions(pair):
    jcfg, params, model, _ = pair
    toks = _tokens(jcfg, 3, 5)
    vf = np.array([0, 1, 4], np.int32)
    ref = np.asarray(jdec.embed_tokens(params, jcfg, toks, 3, jnp.float32,
                                       jnp.asarray(vf)))
    ours = tdec.embed_tokens(model.decoder, torch.from_numpy(toks).long(), 3,
                             torch.from_numpy(vf))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)
