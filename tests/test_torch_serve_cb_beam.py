"""Port beam search under the continuous scheduler (`serve_cb_beam`) against
the JAX package's, and against the port's static beam path.

The three geometries of the JAX engine's own tests, on one tiny fp32 model
(same weights on both sides): two windows in two group slots, five windows
through two slots (group harvest and refill), an impossible log-prob gate
that requeues every window into the sampled engine's t>0 rung, and an
`initial_prompt`. Tokens and text must equal JAX's and the port's static
beam path's, avg_logprob within 1e-4. Sampled rows draw other noise than
JAX's, so the requeue geometry is checked by its rung only."""

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import serve as jsv
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu_torch import ServeOptions, transcribe_batch
from openai_whisper_coreml_tpu_torch import serve_cb_beam as tcbb
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.params import from_jax_params

torch.set_num_threads(1)

COMMON = dict(language="en", temperature=(0.0,), sample_len=8, beam_size=2,
              no_speech_threshold=None, logprob_threshold=None,
              compression_ratio_threshold=None)


@pytest.fixture(scope="module")
def models():
    kw = dict(n_state=64, n_head=2, n_layer=2)
    params = jax_init(jax_tiny(**kw), jax.random.PRNGKey(0))
    return (JaxModel(cfg=jax_tiny(**kw), params=params),
            from_jax_params(jax.tree.map(np.asarray, params), tiny_test_config(**kw)))


def _audios(seed, seconds):
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(seconds):
        t = np.arange(int(s * 16_000)) / 16_000
        out.append((0.2 * np.sin(2 * np.pi * (180 + 40 * i) * t)
                    + 0.02 * rng.standard_normal(t.shape)).astype(np.float32))
    return out


def _tokens(results):
    return [[t for seg in r["segments"] for t in seg["tokens"]] for r in results]


def _assert_same(ours, ref):
    assert _tokens(ours) == _tokens(ref)
    for a, b in zip(ours, ref):
        assert a["text"] == b["text"]
        assert len(a["segments"]) == len(b["segments"])
        for x, y in zip(a["segments"], b["segments"]):
            assert (x["seek"], x["start"], x["end"]) == (y["seek"], y["start"], y["end"])
            assert abs(x["avg_logprob"] - y["avg_logprob"]) < 1e-4


@pytest.mark.parametrize("seconds,extra", [
    ([1.0, 1.2], {}),
    ([1.0, 1.1, 0.8, 1.3, 0.9], {}),  # 5 windows through 2 group slots
    ([1.0, 2.6], {"initial_prompt": "names: Kowalski"}),
], ids=["two-groups", "refill-across-groups", "initial-prompt"])
def test_beam_cb_matches_jax_and_static_beam(models, seconds, extra):
    jm, tm = models
    audios = _audios(len(seconds), seconds)
    opts = dict(COMMON, batch_size=2, **extra)
    ours = transcribe_batch(tm, audios, ServeOptions(scheduler="continuous", **opts))
    ref = jsv.transcribe_batch(jm, audios, jsv.ServeOptions(scheduler="continuous",
                                                            **opts))
    static = transcribe_batch(tm, audios, ServeOptions(scheduler="static", **opts))
    _assert_same(ours, ref)
    _assert_same(ours, static)
    assert any(_tokens(ours))


def test_beam_cb_gate_failure_routes_to_sampled_engine(models, monkeypatch):
    """An impossible logprob gate fails the t=0 beam rung in every window;
    each retry decodes on the sampled engine at the next rung (0.5), as in
    JAX."""
    jm, tm = models
    audios = _audios(3, [1.0, 1.2])
    opts = dict(batch_size=2, language="en", temperature=(0.0, 0.5), sample_len=6,
                beam_size=2, logprob_threshold=1e9, no_speech_threshold=None,
                compression_ratio_threshold=None)
    engines = []
    real_run = tcbb.ContinuousBatcher.run

    def spy(self, windows, arrivals=None):
        engines.append((type(self).__name__, self.options.beam_size,
                        tuple(self.options.temperature), len(windows)))
        return real_run(self, windows, arrivals)

    monkeypatch.setattr(tcbb.ContinuousBatcher, "run", spy)
    ours = transcribe_batch(tm, audios, ServeOptions(scheduler="continuous", **opts))
    ref = jsv.transcribe_batch(jm, audios, jsv.ServeOptions(scheduler="continuous",
                                                            **opts))
    assert engines == [("ContinuousBatcher", None, (0.5,), 2)]
    for r, j in zip(ours, ref):
        assert r["segments"] and j["segments"]
        assert {s["temperature"] for s in r["segments"]} == {0.5}
        assert {s["temperature"] for s in j["segments"]} == {0.5}


def test_beam_cb_int8_cache_matches_static_beam(models):
    """The port's engine also takes an int8 self-attention cache (JAX's
    takes bf16 only): token-equal to the static beam path with the same
    int8 caches."""
    _, tm = models
    audios = _audios(4, [1.0, 1.1, 0.8])
    opts = dict(COMMON, batch_size=2, kv_dtype="int8", cache_dtype="int8")
    ours = transcribe_batch(tm, audios, ServeOptions(scheduler="continuous", **opts))
    static = transcribe_batch(tm, audios, ServeOptions(scheduler="static", **opts))
    _assert_same(ours, static)


def test_scatter_beam_rows_places_groups():
    """Refill groups land at their group slots: K rows per group for the
    per-row fields, one entry per group for the per-group ones; the caches
    are written in place."""
    from openai_whisper_coreml_tpu_torch.models import decoder as dec_mod

    k, g, total, c = 2, 3, 5, 2

    def state(n, fill):
        rows = n * k
        return tcbb.CBBeamState(
            tokens=torch.full((rows, total), fill), logits=torch.full((rows, 3), fill * 1.0),
            sum_lp=torch.full((rows,), fill * 1.0), seq_len=torch.full((rows,), fill),
            ts_max=torch.full((rows,), fill), pad=torch.full((rows,), fill),
            pos=torch.full((n,), fill), finished=torch.full((n,), fill > 0),
            no_speech=torch.full((n,), fill * 1.0), fin_scores=torch.full((n, c), fill * 1.0),
            fin_tokens=torch.full((n, c, total), fill), fin_lens=torch.full((n, c), fill),
            cache=dec_mod.KVCache(torch.full((1, rows, 1, 1, 1), fill * 1.0),
                                  torch.full((1, rows, 1, 1, 1), fill * 1.0)),
            cross_kv=dec_mod.CrossKV(*(torch.full((1, rows, 1, 1, 1), fill * 1.0)
                                       for _ in range(2))))

    base = state(g, 0)
    cache_k = base.cache.k
    out = tcbb.scatter_beam_rows(base, state(1, 7), [2], beam_size=k)
    assert out.tokens[:, 0].tolist() == [0, 0, 0, 0, 7, 7]
    assert out.pos.tolist() == [0, 0, 7] and out.finished.tolist() == [False, False, True]
    assert out.fin_tokens[:, 0, 0].tolist() == [0, 0, 7]
    assert out.cache.k is cache_k and cache_k[0, :, 0, 0, 0].tolist() == [0, 0, 0, 0, 7, 7]
