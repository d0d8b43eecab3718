"""Port word timestamps on the long-form and serving entry points against
the JAX package's (tiny model, real 1500/3000 geometry, fp32 CPU, the same
weights): `transcribe(word_timestamps=True)` with and without
`hallucination_silence_threshold`, and `transcribe_batch` with word
timestamps under both schedulers, greedy and beam 2. Segments are equal,
and so are their words (text, start, end), with probabilities within
1e-5."""

import importlib

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import serve as jsv
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu_torch import ServeOptions, transcribe_batch
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.params import from_jax_params

ttr = importlib.import_module("openai_whisper_coreml_tpu_torch.transcribe")

torch.set_num_threads(1)

SR = 16_000
QUIET = dict(no_speech_threshold=None, logprob_threshold=None,
             compression_ratio_threshold=None)
SEG_KEYS = ("id", "seek", "start", "end", "tokens", "text")


@pytest.fixture(scope="module")
def models():
    kw = dict(n_state=64, n_head=2, n_layer=2)
    params = jax_init(jax_tiny(**kw), jax.random.PRNGKey(0))
    return (JaxModel(cfg=jax_tiny(**kw), params=params),
            from_jax_params(jax.tree.map(np.asarray, params), tiny_test_config(**kw)))


def speechy(seconds, seed):
    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.default_rng(seed)
    return (0.2 * np.sin(2 * np.pi * 200 * t) * (1 + 0.5 * np.sin(2 * np.pi * 2 * t))
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


def assert_words_equal(ours, ref):
    """Segments and their words equal (probabilities within 1e-5)."""
    assert ours["text"] == ref["text"]
    assert len(ours["segments"]) == len(ref["segments"])
    for o, r in zip(ours["segments"], ref["segments"]):
        assert [o[k] for k in SEG_KEYS] == [r[k] for k in SEG_KEYS], (o, r)
        assert ("words" in o) == ("words" in r)
        ow, rw = o.get("words") or [], r.get("words") or []
        assert [(w["word"], w["start"], w["end"]) for w in ow] == [
            (w["word"], w["start"], w["end"]) for w in rw], (o, r)
        for a, b in zip(ow, rw):
            assert a["probability"] == pytest.approx(b["probability"], abs=1e-5)


def check_words(result, duration):
    """Every segment carries words (a slot merged into a neighbour's word
    can leave one empty), inside the audio and in order; returns their
    count."""
    n = 0
    for seg in result["segments"]:
        assert "words" in seg
        prev = 0.0
        for w in seg["words"]:
            assert prev <= w["start"] <= w["end"] <= duration + 1e-6
            prev = w["start"]
            n += 1
    return n


@pytest.mark.parametrize("threshold", [None, 0.5, 2.0])
def test_transcribe_word_timestamps_match_jax(models, threshold):
    """A 35 s clip in 8-token windows: the word pass, the seek from the last
    word's end and, with a threshold, openai's hallucination skips (the
    random model's words are improbable, so its segments score as
    anomalies) give JAX's segments and words."""
    jm, tm = models
    audio = speechy(35, 3)
    kw = dict(language="en", temperature=0.0, sample_len=8, word_timestamps=True,
              hallucination_silence_threshold=threshold, **QUIET)
    ours = tm.transcribe(audio, **kw)
    ref = jm.transcribe(audio, **kw)
    assert_words_equal(ours, ref)
    assert ours["segments"] and check_words(ours, 35.0) > 0


def test_transcribe_short_clip_words(models):
    """JAX's own end-to-end case: 3 s of noise, every segment has words."""
    jm, tm = models
    audio = (0.1 * np.random.default_rng(2).standard_normal(SR * 3)).astype(np.float32)
    kw = dict(language="en", temperature=0.0, sample_len=8, word_timestamps=True,
              **QUIET)
    ours = tm.transcribe(audio, **kw)
    assert_words_equal(ours, jm.transcribe(audio, **kw))
    check_words(ours, 3.0)


@pytest.mark.parametrize("scheduler,beam", [("static", None), ("continuous", None),
                                            ("static", 2), ("continuous", 2)])
def test_transcribe_batch_word_timestamps_match_jax(models, scheduler, beam):
    """Three requests (one shorter than a window, two of several windows)
    with word timestamps: the port's words equal JAX's under either
    scheduler, greedy and beam."""
    jm, tm = models
    audios = [speechy(12, 21), speechy(35, 22), speechy(50, 23)]
    kw = dict(batch_size=2, language="en", temperature=(0.0,), sample_len=8,
              chunk_tokens=4, scheduler=scheduler, beam_size=beam,
              word_timestamps=True, **QUIET)
    ours = transcribe_batch(tm, audios, ServeOptions(**kw))
    ref = jsv.transcribe_batch(jm, audios, jsv.ServeOptions(**kw))
    for o, r, sec in zip(ours, ref, (12, 35, 50)):
        assert_words_equal(o, r)
        check_words(o, float(sec))


def test_word_timestamps_need_timestamps():
    with pytest.raises(ValueError, match="without_timestamps"):
        ServeOptions(word_timestamps=True, without_timestamps=True)


def test_transcribe_word_pass_reuses_window_features(models, monkeypatch):
    """The word pass aligns on the window's own features: one encode per
    decoded window (one rung each at t=0), no second encode."""
    _, tm = models
    calls = {"encode": 0, "decode": 0}
    encode, decode = type(tm).encode, ttr.decode

    def counting_encode(self, mel):
        calls["encode"] += 1
        return encode(self, mel)

    def counting_decode(*args, **kwargs):
        calls["decode"] += 1
        return decode(*args, **kwargs)

    monkeypatch.setattr(type(tm), "encode", counting_encode)
    monkeypatch.setattr(ttr, "decode", counting_decode)
    result = tm.transcribe(speechy(35, 3), language="en", temperature=0.0,
                           sample_len=8, word_timestamps=True, **QUIET)
    assert any(s["words"] for s in result["segments"])
    assert calls["encode"] == calls["decode"] >= 2
