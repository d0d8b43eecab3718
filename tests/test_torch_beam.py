"""Port beam search against the JAX `beam_decode_core` at fp32, same
weights: every returned candidate's tokens and length exact, scores within
1e-4, no-speech probability within 1e-5; and decode(beam_size=k) gives
JAX's text. JAX runs both its flat and its two-level loop; the port runs
the flat one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import beam as jbeam
from openai_whisper_coreml_tpu import decoding as jdecoding
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu.quantize import quantize_params as jax_quantize
from openai_whisper_coreml_tpu.tokenizer import get_tokenizer as jax_tokenizer
from openai_whisper_coreml_tpu_torch import beam as tbeam
from openai_whisper_coreml_tpu_torch import decoding as tdecoding
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.params import from_jax_params

# tiny tensors: one torch thread per test worker keeps parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

N_CTX = 32
TEXT_CTX = 96
SAMPLE_LEN = 40


@pytest.fixture(scope="module")
def setups():
    jcfg = jax_tiny(n_audio_ctx=N_CTX, n_text_ctx=TEXT_CTX)
    tcfg = tiny_test_config(n_audio_ctx=N_CTX, n_text_ctx=TEXT_CTX)
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    out = {}
    for weights in ("float", "int8"):
        p = jax_quantize(params, min_size=0) if weights == "int8" else params
        out[weights] = (p, from_jax_params(jax.tree.map(np.asarray, p), tcfg))
    feats = np.random.default_rng(5).standard_normal(
        (2, N_CTX, jcfg.n_text_state)).astype(np.float32)
    tok = jax_tokenizer(jcfg, language="en")
    return jcfg, out, feats, tok


@pytest.mark.parametrize("k,patience,timestamps,weights,kv_dtype,two_level", [
    (2, 2.0, True, "float", "bf16", False),
    (3, 2.0, True, "float", "bf16", True),
    (2, 2.0, False, "float", "int8", True),
    (3, 2.0, False, "int8", "bf16", False),
    (2, 2.0, True, "int8", "int8", True),
    (3, 2.0, True, "int8", "int8", False),
    (3, None, True, "float", "int8", False),
])
def test_beam_core_candidate_exact(setups, k, patience, timestamps, weights,
                                   kv_dtype, two_level):
    jcfg, models, feats, tok = setups
    params, model = models[weights]
    opts = jdecoding.DecodingOptions(language="en",
                                     without_timestamps=not timestamps)
    sup = jdecoding.build_suppress_mask(tok, opts)
    blank = jdecoding.build_blank_mask(tok)
    seq = [tok.eot, tok.sot, tok.language_token("en"), tok.transcribe]
    if not timestamps:
        seq = seq[1:] + [tok.no_timestamps]
    initial = np.tile(np.asarray([seq], np.int32), (feats.shape[0], 1))
    pad = 1 if timestamps else 0
    max_init = 50 if timestamps else -1
    max_cand = max(k, round(k * (patience or 1.0)))
    ref = jbeam.beam_decode_core(
        params, jcfg, jnp.asarray(feats), jnp.asarray(initial),
        jnp.asarray(sup), jnp.asarray(blank), jnp.int32(max_init),
        jnp.int32(pad), jnp.int32(pad), sample_len=SAMPLE_LEN,
        use_timestamps=timestamps, prompt_len=4, beam_size=k,
        max_candidates=max_cand, kv_dtype=kv_dtype, two_level=two_level)
    ref = [np.asarray(r) for r in ref]
    ours = tbeam.beam_decode_core(
        model.decoder, torch.from_numpy(feats), torch.from_numpy(initial),
        torch.from_numpy(sup), torch.from_numpy(blank), max_init, pad, pad,
        sample_len=SAMPLE_LEN, use_timestamps=timestamps, prompt_len=4,
        beam_size=k, max_candidates=max_cand, kv_dtype=kv_dtype)
    ours = [o.numpy() for o in ours]
    np.testing.assert_array_equal(ours[0], ref[0])  # candidate tokens
    np.testing.assert_array_equal(ours[2], ref[2])  # lengths
    np.testing.assert_allclose(ours[1], ref[1], atol=1e-4)  # sum log-probs
    np.testing.assert_allclose(ours[3], ref[3], atol=1e-5)  # no-speech
    assert ours[2].max() > 1  # beams ran past the first step
    for lp in (None, 1.0):
        np.testing.assert_allclose(
            tbeam.rank_sequences(torch.from_numpy(ours[1]),
                                 torch.from_numpy(ours[2]), lp).numpy(),
            np.asarray(jbeam.rank_sequences(jnp.asarray(ref[1]),
                                            jnp.asarray(ref[2]), lp)),
            rtol=1e-6)


@pytest.fixture(scope="module")
def models(setups):
    jcfg, models, _, _ = setups
    params, tm = models["float"]
    mel = np.random.default_rng(7).standard_normal(
        (2, jcfg.n_mels, 2 * N_CTX)).astype(np.float32)
    return JaxModel(cfg=jcfg, params=params), tm, mel


@pytest.mark.parametrize("kw", [
    dict(beam_size=2, patience=2.0),
    dict(beam_size=3, length_penalty=0.8, prompt="hello there"),
    dict(beam_size=2, kv_dtype="int8", without_timestamps=True),
], ids=["beam2", "beam3-lp-prompt", "beam2-int8-notimestamps"])
def test_decode_beam_matches_jax(models, kw):
    jm, tm, mel = models
    kw = dict(language="en", sample_len=30, **kw)
    ref = jdecoding.decode(jm, mel, jdecoding.DecodingOptions(**kw))
    ours = tdecoding.decode(tm, mel, tdecoding.DecodingOptions(**kw))
    for o, r in zip(ours, ref):
        assert o.tokens == r.tokens
        assert o.text == r.text
        np.testing.assert_allclose(o.avg_logprob, r.avg_logprob, atol=1e-5)
        np.testing.assert_allclose(o.no_speech_prob, r.no_speech_prob, atol=1e-5)


def test_beam_rejects_per_sample_prompts(models):
    _, tm, mel = models
    with pytest.raises(ValueError, match="per-sample"):
        tdecoding.decode(tm, mel, tdecoding.DecodingOptions(
            language="en", beam_size=2, prompt=["a", "b"]))
