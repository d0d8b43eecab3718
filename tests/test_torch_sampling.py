"""The port's sampler and best_of ranking.

JAX draws with threefry keys that torch cannot reproduce, so sampling is
held to the distribution it must draw from, softmax(logits / T), and to
being a pure function of (seed, row, position); best_of ranking is held to
JAX's on the same candidate arrays."""

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import decoding as jdecoding
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu_torch import decoding as tdecoding
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.params import from_jax_params

# tiny tensors: one torch thread per test worker keeps parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

N_CTX = 32


@pytest.mark.parametrize("temperature", [0.5, 1.0])
def test_sampler_total_variation(temperature):
    """20,000 draws (400 rows x 50 positions) over 12 categories. The
    Monte-Carlo total variation of an exact sampler at this n is about
    0.5 * sum_i sqrt(2 p_i (1 - p_i) / (pi n)) ~ 0.01 here; 0.02 bounds
    that sampling error while a biased sampler (say, one category off by
    0.03) exceeds it."""
    logits = torch.from_numpy(
        np.random.default_rng(1).standard_normal(12).astype(np.float32) * 2)
    rows = logits.expand(400, -1)
    counts = torch.zeros(12)
    for pos in range(50):
        tok = tdecoding.sample_tokens(rows, temperature, seed=7, pos=pos)
        counts += torch.bincount(tok, minlength=12)
    p = torch.softmax(logits / temperature, dim=-1)
    tv = 0.5 * (counts / counts.sum() - p).abs().sum().item()
    assert counts.sum() == 20_000
    assert tv <= 0.02, tv


def test_uniforms_stay_inside_the_open_unit_interval():
    """The extreme 32-bit values map strictly inside (0, 1), so the Gumbel
    noise is finite: at 24 bits the top value rounded to 1.0 in fp32 and
    gave +inf noise, a uniformly random token about once in 2^24 draws."""
    u = tdecoding.open_unit(torch.tensor([0, 1, 2**31, 2**32 - 2, 2**32 - 1]))
    assert u.dtype == torch.float32
    assert (u > 0).all() and (u < 1).all() and (u[1:] >= u[:-1]).all()
    assert torch.isfinite(-torch.log(-torch.log(u))).all()


def test_sampler_is_a_function_of_seed_row_and_position():
    noise = tdecoding.gumbel_noise(3, torch.arange(8), 17, 100)
    again = tdecoding.gumbel_noise(3, torch.tensor([5, 2]), 17, 100)
    assert torch.equal(again, noise[[5, 2]])  # independent of batch makeup
    for seed, pos in ((4, 17), (3, 18)):
        assert not torch.equal(tdecoding.gumbel_noise(seed, torch.arange(8), pos, 100),
                               noise)
    assert len({tuple(r.tolist()) for r in noise}) == 8  # rows differ
    assert torch.isfinite(noise).all()
    logits = torch.randn(8, 100, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tdecoding.sample_tokens(logits, 0.7, 3, 17),
                       tdecoding.sample_tokens(logits, 0.7, 3, 17))
    assert torch.equal(tdecoding.sample_tokens(logits, 0.0, 3, 17),
                       logits.argmax(-1))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny(n_audio_ctx=N_CTX, n_text_ctx=96)
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    tm = from_jax_params(jax.tree.map(np.asarray, params),
                         tiny_test_config(n_audio_ctx=N_CTX, n_text_ctx=96))
    mel = np.random.default_rng(7).standard_normal(
        (2, jcfg.n_mels, 2 * N_CTX)).astype(np.float32)
    return JaxModel(cfg=jcfg, params=params), tm, mel


@pytest.mark.parametrize("per_sample", [False, True])
def test_best_of_ranking_matches_jax(models, monkeypatch, per_sample):
    """Both decode()s rank the same scripted candidate arrays: 2 rows x 3
    candidates with different lengths, sums and no-speech probabilities."""
    jm, tm, mel = models
    n_cand, sample_len = 3, 6
    rng = np.random.default_rng(9)
    seen = {}

    def scripted(initial, prompt_len):
        rows = initial.shape[0]
        seen.setdefault("rows", []).append(rows)
        toks = np.full((rows, prompt_len + sample_len), 50257, np.int64)
        toks[:, prompt_len:prompt_len + 4] = rng.integers(100, 400, (rows, 4))
        n = np.array([4, 2, 3, 1, 4, 2][:rows])
        for r in range(rows):
            toks[r, prompt_len + n[r]:] = 50257
        return (toks, rng.standard_normal(rows).astype(np.float32) - 3.0, n,
                rng.random(rows).astype(np.float32))

    arrays = {}

    def fake_jax(params, cfg, feats, initial, *a, prompt_len, **k):
        arrays["j"] = scripted(np.asarray(initial), prompt_len)
        return tuple(np.asarray(x) for x in arrays["j"])

    def fake_torch(decoder, feats, initial, *a, prompt_len, **k):
        return tuple(torch.from_numpy(np.asarray(x)) for x in arrays["j"])

    monkeypatch.setattr(jdecoding, "greedy_decode_core", fake_jax)
    monkeypatch.setattr(tdecoding, "greedy_decode_core", fake_torch)
    kw = dict(language="en", temperature=0.6, best_of=n_cand,
              sample_len=sample_len)
    if per_sample:
        kw["prompt"] = ["one two", None]
    ref = jdecoding.decode(jm, mel, jdecoding.DecodingOptions(**kw))
    ours = tdecoding.decode(tm, mel, tdecoding.DecodingOptions(**kw))
    assert seen["rows"] == [2 * n_cand]
    for o, r in zip(ours, ref):
        assert o.tokens == r.tokens and o.text == r.text
        assert o.avg_logprob == r.avg_logprob
        assert o.no_speech_prob == r.no_speech_prob
        assert o.temperature == r.temperature == 0.6


def test_sampled_decode_is_seeded(models):
    _, tm, mel = models
    opts = tdecoding.DecodingOptions(language="en", temperature=1.0, best_of=2,
                                     sample_len=20)
    a = tdecoding.decode(tm, mel, opts, seed=1)
    b = tdecoding.decode(tm, mel, opts, seed=1)
    c = tdecoding.decode(tm, mel, opts, seed=2)
    assert [r.tokens for r in a] == [r.tokens for r in b]
    assert [r.tokens for r in a] != [r.tokens for r in c]
    for r in a:
        assert np.isfinite(r.avg_logprob) and r.temperature == 1.0
        assert all(0 <= t < tm.cfg.n_vocab for t in r.tokens)
