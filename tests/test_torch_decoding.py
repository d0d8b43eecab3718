"""Port decode()/detect_language against the JAX package (fp32, same
weights), and the options both packages take."""

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import decoding as jdecoding
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu.tokenizer import get_tokenizer as jax_tokenizer
from openai_whisper_coreml_tpu_torch import decoding as tdecoding
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.params import from_jax_params
from openai_whisper_coreml_tpu_torch.tokenizer import get_tokenizer

# tiny tensors: one torch thread per test worker keeps parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

N_CTX = 64


@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny(n_audio_ctx=N_CTX, n_text_ctx=96)
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    jm = JaxModel(cfg=jcfg, params=params)
    tm = from_jax_params(jax.tree.map(np.asarray, params),
                         tiny_test_config(n_audio_ctx=N_CTX, n_text_ctx=96))
    mel = np.random.default_rng(7).standard_normal(
        (2, jcfg.n_mels, 2 * N_CTX)).astype(np.float32)
    return jm, tm, mel


def test_detect_language_matches_jax(models):
    jm, tm, mel = models
    codes_j, probs_j = jdecoding.detect_language(jm, mel)
    codes_t, probs_t = tdecoding.detect_language(tm, mel)
    assert codes_t == codes_j
    for pj, pt in zip(probs_j, probs_t):
        assert list(pt) == list(pj)
        np.testing.assert_allclose(list(pt.values()), list(pj.values()), atol=1e-5)
    assert tm.detect_language(mel[0])[0] == codes_j[:1]


@pytest.mark.parametrize("kw", [
    dict(language="en", sample_len=40),
    dict(sample_len=30),  # language detected per row
    dict(language="en", kv_dtype="int8", sample_len=40, without_timestamps=True),
    dict(language="de", task="translate", prompt="hello there", prefix="so",
         sample_len=30),
    dict(language="en", prompt=["one two", None], sample_len=30),
], ids=["en", "detect", "int8-notimestamps", "prompt-prefix", "per-sample"])
def test_decode_matches_jax(models, kw):
    jm, tm, mel = models
    ref = jdecoding.decode(jm, mel, jdecoding.DecodingOptions(**kw))
    ours = tdecoding.decode(tm, mel, tdecoding.DecodingOptions(**kw))
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert o.tokens == r.tokens
        assert (o.text, o.language) == (r.text, r.language)
        np.testing.assert_allclose(o.avg_logprob, r.avg_logprob, atol=1e-5)
        np.testing.assert_allclose(o.no_speech_prob, r.no_speech_prob, atol=1e-5)
        assert o.compression_ratio == r.compression_ratio


def test_model_decode_unbatched_returns_one_result(models):
    _, tm, mel = models
    res = tm.decode(mel[0], language="en", sample_len=10)
    assert isinstance(res, tdecoding.DecodingResult)
    assert res.tokens == tm.decode(mel, language="en", sample_len=10)[0].tokens


def test_masks_and_buckets_match_jax():
    jcfg = jax_tiny()
    jtok = jax_tokenizer(jcfg, language="en")
    ttok = get_tokenizer(tiny_test_config(), language="en")
    for sup in ("-1", "", [5, 7], None):
        jo = jdecoding.DecodingOptions(suppress_tokens=sup)
        to = tdecoding.DecodingOptions(suppress_tokens=sup)
        np.testing.assert_array_equal(tdecoding.build_suppress_mask(ttok, to),
                                      jdecoding.build_suppress_mask(jtok, jo))
    np.testing.assert_array_equal(tdecoding.build_blank_mask(ttok),
                                  jdecoding.build_blank_mask(jtok))
    for n in (1, 4, 5, 32, 33, 224, 300):
        for ctx in (96, 448):
            assert (tdecoding._prompt_bucket(n, ctx)
                    == jdecoding._prompt_bucket(n, ctx))
    assert ttok.encode(" hello world") == jtok.encode(" hello world")


@pytest.mark.parametrize("use_timestamps", [True, False])
@pytest.mark.parametrize("step", [0, 1, 2, 5])
def test_logit_rules_match_jax(use_timestamps, step):
    """Rules a-e on random logits and token histories that mix text and
    timestamps (rows with boosted EOT and boosted timestamp mass)."""
    import jax.numpy as jnp

    jcfg, tcfg = jax_tiny(), tiny_test_config()
    rng = np.random.default_rng(10 + step)
    b, prompt_len, v = 8, 4, jcfg.n_vocab
    ts0 = jcfg.timestamp_begin
    pos = prompt_len + step
    tokens = rng.integers(0, jcfg.eot_token, size=(b, pos + 1))
    is_ts = rng.random((b, pos + 1)) < 0.5
    tokens = np.where(is_ts, rng.integers(ts0, v, size=(b, pos + 1)), tokens)
    sampled = tokens[:, prompt_len:pos]
    ts_max = np.where(sampled >= ts0, sampled, ts0 - 1).max(axis=1,
                                                          initial=ts0 - 1)
    logits = (3 * rng.standard_normal((b, v))).astype(np.float32)
    logits[0, jcfg.eot_token] = 40.0
    logits[1, ts0:] += 6.0
    suppress = rng.random(v) < 0.01
    blank = np.zeros(v, bool)
    blank[[jcfg.eot_token, 220, 1000]] = True
    ref = np.asarray(jdecoding._apply_logit_rules(
        jnp.asarray(logits), jnp.asarray(tokens, jnp.int32), jnp.int32(pos),
        jcfg, prompt_len, jnp.asarray(suppress), jnp.asarray(blank),
        use_timestamps, jnp.asarray(ts_max, jnp.int32), jnp.int32(50)))
    ours = tdecoding._apply_logit_rules(
        torch.from_numpy(logits), torch.from_numpy(tokens), pos, tcfg,
        prompt_len, torch.from_numpy(suppress), torch.from_numpy(blank),
        use_timestamps, torch.from_numpy(ts_max), 50).numpy()
    np.testing.assert_array_equal(ours == tdecoding.NEG_INF,
                                  ref == np.float32(jdecoding.NEG_INF))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("kw", [dict(beam_size=5), dict(temperature=0.4),
                                dict(best_of=3), {}])
def test_unported_options_raise(kw):
    """Beam, sampling, best_of and the int8 self-attention cache are ported
    in every decoding mode and take the JAX package's values; the cache
    dtype is validated as JAX validates it. Speculative decoding is ported
    too (test_decode_with_draft_raises)."""
    for cache_dtype in ("bf16", "int8"):
        ours = tdecoding.DecodingOptions(cache_dtype=cache_dtype, **kw)
        ref = jdecoding.DecodingOptions(cache_dtype=cache_dtype, **kw)
        assert (ours.cache_dtype, ours.beam_size, ours.temperature,
                ours.best_of) == (ref.cache_dtype, ref.beam_size,
                                  ref.temperature, ref.best_of)
    with pytest.raises(ValueError, match="cache_dtype"):
        tdecoding.DecodingOptions(cache_dtype="fp8", **kw)


def test_option_validation_matches_jax():
    for kw in (dict(task="translit"), dict(kv_dtype="fp8"),
               dict(stage_width=12), dict(spec_k=0)):
        with pytest.raises(ValueError):
            jdecoding.DecodingOptions(**kw)
        with pytest.raises(ValueError):
            tdecoding.DecodingOptions(**kw)


def test_decode_with_draft_raises(models):
    """A draft no longer raises: speculative decoding is ported. With the
    model as its own draft, decode gives the plain loop's tokens and JAX's
    speculative decode's, and publishes a speculative wall and its stats."""
    from openai_whisper_coreml_tpu_torch import speculative

    jm, tm, mel = models
    kw = dict(language="en", sample_len=24, spec_k=3)
    plain = tdecoding.decode(tm, mel, tdecoding.DecodingOptions(**kw))
    assert speculative.LAST_TIMING["path"] == "plain"
    ours = tdecoding.decode(tm, mel, tdecoding.DecodingOptions(**kw), draft=tm)
    assert speculative.LAST_TIMING["path"] == "spec"
    assert speculative.LAST_STATS["acceptance_rate"] > 0.85
    ref = jdecoding.decode(jm, mel, jdecoding.DecodingOptions(**kw), draft=jm)
    assert [r.tokens for r in ours] == [r.tokens for r in plain]
    assert [r.tokens for r in ours] == [r.tokens for r in ref]
    for a, b in zip(ours, ref):
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-4)
