"""Port long-form `transcribe` against the JAX package's.

With a tiny model (real 1500/3000 geometry, fp32, same weights) the
segments (seek, start, end, tokens, text) must be equal. The port's mel is
its plain K4 version and JAX's the XLA frontend; they differ by ~1e-6 and
no greedy near-tie flips on these inputs, so each side computes its own mel.
The seek, clip, prompt, no-speech and ladder logic is also driven with one
scripted decode() on both sides, whose results must be equal."""

import importlib

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import vad as jvad
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.decoding import DecodingResult as JaxResult
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu_torch import vad as tvad
from openai_whisper_coreml_tpu_torch.audio import log_mel_spectrogram
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.decoding import DecodingResult
from openai_whisper_coreml_tpu_torch.params import from_jax_params

# the packages export a `transcribe` function that shadows the module
jtr = importlib.import_module("openai_whisper_coreml_tpu.transcribe")
ttr = importlib.import_module("openai_whisper_coreml_tpu_torch.transcribe")

# tiny tensors: one torch thread per test worker keeps parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

SR = 16_000
QUIET = dict(no_speech_threshold=None, logprob_threshold=None,
             compression_ratio_threshold=None)


@pytest.fixture(scope="module")
def models():
    kw = dict(n_state=64, n_head=2, n_layer=2)
    params = jax_init(jax_tiny(**kw), jax.random.PRNGKey(0))
    return (JaxModel(cfg=jax_tiny(**kw), params=params),
            from_jax_params(jax.tree.map(np.asarray, params), tiny_test_config(**kw)))


@pytest.fixture(scope="module")
def speechy_audio():
    rng = np.random.default_rng(11)
    t = np.arange(50 * SR) / SR
    return (0.2 * np.sin(2 * np.pi * 200 * t) * (1 + 0.5 * np.sin(2 * np.pi * 2 * t))
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


def _tone(seconds, amp=0.3):
    t = np.arange(int(seconds * SR)) / SR
    return (amp * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)


def _noise(seconds, amp, seed):
    return (amp * np.random.default_rng(seed).standard_normal(int(seconds * SR))
            ).astype(np.float32)


def _assert_same(ours, ref, exact_floats=False):
    assert ours["text"] == ref["text"]
    assert ours["language"] == ref["language"]
    assert ours.get("duration") == pytest.approx(ref.get("duration"))
    assert len(ours["segments"]) == len(ref["segments"])
    for o, r in zip(ours["segments"], ref["segments"]):
        for key in ("id", "seek", "start", "end", "tokens", "text",
                    "temperature", "compression_ratio"):
            assert o[key] == r[key], (key, o, r)
        for key in ("avg_logprob", "no_speech_prob"):
            if exact_floats:
                assert o[key] == r[key]
            else:
                assert o[key] == pytest.approx(r[key], abs=1e-5)


@pytest.mark.parametrize("kw", [
    {},
    dict(without_timestamps=True),
    dict(clip_timestamps="31,45"),
    dict(clip_timestamps=[40.0]),
    dict(initial_prompt="hello there", condition_on_previous_text=False),
    dict(beam_size=2, patience=2.0),
], ids=["greedy", "no-timestamps", "clip-string", "clip-open", "prompt",
        "beam"])
def test_transcribe_matches_jax(models, speechy_audio, kw):
    jm, tm = models
    kw = dict(language="en", temperature=0.0, sample_len=12, **QUIET, **kw)
    ref = jtr.transcribe(jm, speechy_audio, **kw)
    ours = tm.transcribe(speechy_audio, **kw)
    _assert_same(ours, ref)
    assert len({s["seek"] for s in ours["segments"]}) >= (
        1 if "clip_timestamps" in kw else 2)


def test_carry_initial_prompt_matches_jax(models, speechy_audio, monkeypatch):
    jm, tm = models
    seen = {"j": [], "t": []}
    for side, mod in (("j", jtr), ("t", ttr)):
        real = mod.decode

        def spy(model, feats, opts, _side=side, _real=real, **kw):
            seen[_side].append(list(opts.prompt) if opts.prompt else [])
            return _real(model, feats, opts, **kw)

        monkeypatch.setattr(mod, "decode", spy)
    kw = dict(language="en", temperature=0.0, sample_len=8,
              initial_prompt="glossary: TPU, XLA", carry_initial_prompt=True,
              **QUIET)
    audio = np.concatenate([speechy_audio, speechy_audio[:15 * SR]])  # 3 windows
    _assert_same(ttr.transcribe(tm, audio, **kw), jtr.transcribe(jm, audio, **kw))
    assert seen["t"] == seen["j"] and len(seen["t"]) >= 3


def test_vad_filter_matches_jax(models):
    jm, tm = models
    audio = np.concatenate([_noise(35.0, 1e-5, 1), _tone(3.0), _noise(2.0, 1e-5, 2)])
    kw = dict(language="en", temperature=0.0, sample_len=6, **QUIET)
    ours = tm.transcribe(audio, vad_filter=True, **kw)
    _assert_same(ours, jtr.transcribe(jm, audio, vad_filter=True, **kw))
    assert ours["segments"] and all(3400 <= s["seek"] < 3850 for s in ours["segments"])
    silent = tm.transcribe(_noise(3.0, 1e-6, 5), vad_filter=True, **kw)
    assert silent == {"text": "", "segments": [], "language": "en"}
    with pytest.raises(ValueError, match="vad_filter"):
        tm.transcribe(audio, vad_filter=True, clip_timestamps="1,2", **kw)


@pytest.mark.parametrize("name", ["tone", "gap-click", "silence", "loud", "empty"])
def test_vad_matches_jax(name):
    audio = {
        "tone": np.concatenate([_noise(2.0, 1e-4, 1), _tone(3.0), _noise(2.0, 1e-4, 3)]),
        "gap-click": np.concatenate([_noise(1.0, 1e-4, 1), _tone(1.0),
                                     _noise(0.2, 1e-4, 2), _tone(1.0),
                                     _noise(2.0, 1e-4, 3), _tone(0.05),
                                     _noise(1.0, 1e-4, 4)]),
        "silence": _noise(3.0, 1e-6, 7),
        "loud": _tone(1.0),
        "empty": np.zeros(0, np.float32),
    }[name]
    for opts in ({}, dict(min_silence_ms=100, pad_ms=0)):
        assert (tvad.detect_speech(audio, options=tvad.VadOptions(**opts))
                == jvad.detect_speech(audio, options=jvad.VadOptions(**opts)))
    assert tvad.speech_clip_timestamps(audio) == jvad.speech_clip_timestamps(audio)


def test_progress_callback_matches_jax(models):
    jm, tm = models
    audio = (0.2 * np.random.default_rng(5).standard_normal(SR * 35)).astype(np.float32)
    calls = {"j": [], "t": []}
    kw = dict(language="en", temperature=0.0, sample_len=6, **QUIET)
    jtr.transcribe(jm, audio, progress_callback=lambda *a: calls["j"].append(a), **kw)
    ttr.transcribe(tm, audio, progress_callback=lambda *a: calls["t"].append(a), **kw)
    assert calls["t"] == calls["j"] and len(calls["t"]) >= 2


# ---------------------------------------------------------------------------
# Scripted decode: the seek, segmentation, prompt and ladder logic alone
# ---------------------------------------------------------------------------

class FakeModel:
    def __init__(self):
        self.cfg = tiny_test_config()

    def log_mel(self, audio):
        return log_mel_spectrogram(audio, self.cfg.n_mels)

    def detect_language(self, mel):
        return ["en"], [{"en": 1.0}]

    def encode(self, mel):
        return mel  # the scripted decode ignores the features


def _run_both(monkeypatch, script, audio_seconds=60, **kwargs):
    """script(call_index, options) -> dict of DecodingResult fields; both
    packages transcribe silence with decode() replaced by the script, and
    their results and the options each decode() saw must be equal."""
    seen = {}
    for side, mod, result_cls in (("j", jtr, JaxResult), ("t", ttr, DecodingResult)):
        log = seen.setdefault(side, [])

        def fake_decode(model, mel, options, from_features=False, tokenizer=None,
                        seed=0, draft=None, _log=log, _cls=result_cls):
            fields = dict(tokens=[], avg_logprob=-0.2, no_speech_prob=0.0,
                          compression_ratio=1.0)
            fields.update(script(len(_log), options))
            _log.append((options.temperature, options.beam_size,
                         options.best_of, options.prompt))
            return [_cls(text="", language="en", language_probs=None,
                         temperature=options.temperature, **fields)]

        monkeypatch.setattr(mod, "decode", fake_decode)
    audio = np.zeros(int(audio_seconds * SR), np.float32)
    kw = dict(language="en", temperature=0.0, **QUIET)
    kw.update(kwargs)
    ref = jtr.transcribe(FakeModel(), audio, **kw)
    ours = ttr.transcribe(FakeModel(), audio, **kw)
    _assert_same(ours, ref, exact_floats=True)
    assert seen["t"] == seen["j"]
    return ours, seen["t"]


def _tokens(*rows):
    return lambda i, opts: {"tokens": list(rows[min(i, len(rows) - 1)])}


TS = tiny_test_config().timestamp_begin


def test_scripted_consecutive_timestamps_advance_to_last_pair(monkeypatch):
    result, _ = _run_both(monkeypatch, _tokens(
        [TS, 100, TS + 250, TS + 250, 101, TS + 500, TS + 500, 102],
        [TS, 103, TS + 1500]), audio_seconds=40)
    segs = result["segments"]
    assert (segs[0]["start"], segs[0]["end"]) == (0.0, 5.0)
    assert (segs[1]["start"], segs[1]["end"]) == (5.0, 10.0)
    assert any(abs(s["start"] - 10.0) < 1e-6 for s in segs)


def test_scripted_single_trailing_timestamp_consumes_window(monkeypatch):
    result, calls = _run_both(monkeypatch, _tokens([TS, 100, 101, TS + 700]))
    assert len(calls) == 2
    assert abs(result["segments"][0]["end"] - 14.0) < 1e-6
    assert abs(result["segments"][1]["start"] - 30.0) < 1e-6


def test_scripted_no_timestamps_consumes_window(monkeypatch):
    result, calls = _run_both(monkeypatch, _tokens([100, 101, 102]),
                              audio_seconds=31)
    assert len(calls) == 2 and result["segments"][0]["end"] == 30.0


def test_scripted_zero_advance_guard(monkeypatch):
    _, calls = _run_both(monkeypatch, _tokens([TS, TS]), audio_seconds=35)
    assert len(calls) < 4000


def test_scripted_prompts_carry_previous_text(monkeypatch):
    _, calls = _run_both(monkeypatch, _tokens([TS, 123, TS + 1500]),
                         initial_prompt="hello context")
    assert calls[0][3] is not None and len(calls[1][3]) > len(calls[0][3])


def test_scripted_no_speech_skip(monkeypatch):
    result, calls = _run_both(
        monkeypatch,
        lambda i, o: dict(tokens=[TS, 100, TS + 1500], no_speech_prob=0.99,
                          avg_logprob=-5.0),
        audio_seconds=35, no_speech_threshold=0.6, logprob_threshold=-1.0)
    assert result["segments"] == [] and len(calls) == 2


@pytest.mark.parametrize("case", ["fallback", "silence-accepts"])
def test_scripted_temperature_ladder(monkeypatch, case):
    """t=0 runs beam search and compresses too well, t=0.2 samples best_of
    candidates with a low log-prob, t=0.4 passes. A silent window (high
    no-speech probability) is accepted at t=0 and skipped."""
    def script(i, opts):
        if case == "silence-accepts":
            return dict(tokens=[TS, 100, TS + 1500], no_speech_prob=0.9,
                        avg_logprob=-2.0)
        return {0.0: dict(tokens=[TS, 100, TS + 1500], compression_ratio=3.0),
                0.2: dict(tokens=[TS, 101, TS + 1500], avg_logprob=-2.0),
                }.get(opts.temperature, dict(tokens=[TS, 102, TS + 1500]))

    result, calls = _run_both(monkeypatch, script, audio_seconds=35,
                              temperature=(0.0, 0.2, 0.4, 0.6), beam_size=2,
                              best_of=3, compression_ratio_threshold=2.4,
                              logprob_threshold=-1.0, no_speech_threshold=0.6)
    rungs = [c[:3] for c in calls]
    if case == "silence-accepts":
        assert rungs == [(0.0, 2, None)] * 2 and result["segments"] == []
    else:
        assert rungs[:3] == [(0.0, 2, None), (0.2, None, 3), (0.4, None, 3)]
        assert {s["temperature"] for s in result["segments"]} == {0.4}


def test_segment_helpers_match_jax():
    for toks in ([TS, 1, 2, TS + 50, TS + 50, 3, TS + 100, TS + 100],
                 [TS, 1, 2, TS + 50, TS + 50, 3, TS + 100], [TS, 1, 2, TS + 75],
                 [1, 2, 3], [], [TS, TS]):
        for size in (3000, 1234):
            assert (ttr.seek_advance(toks, TS, size)
                    == jtr.seek_advance(toks, TS, size))
        ours = ttr.window_segment_spans(toks, TS, 10.0, 30.0)
        ref = jtr.window_segment_spans(toks, TS, 10.0, 30.0)
        assert [(s, e, t.tolist()) for s, e, t in ours] == [
            (s, e, t.tolist()) for s, e, t in ref]


def test_anomaly_helpers_match_jax():
    def w(word, start, end, p):
        return {"word": word, "start": start, "end": end, "probability": p}

    words = [[w(" hello", 0.0, 0.4, 0.9), w(" world", 0.4, 0.9, 0.8)],
             [w(" uh", 0.0, 0.05, 0.05), w(" uh", 0.05, 0.1, 0.05)],
             [w(".", 0.0, 0.01, 0.01)], [w(" a", 0.0, 3.0, 0.5)], []]
    for ws in words:
        for word in ws:
            assert ttr._word_anomaly_score(word) == jtr._word_anomaly_score(word)
        segs = []
        for mod in (ttr, jtr):
            s = mod.Segment(id=0, seek=0, start=0.0, end=1.0, text="x",
                            tokens=[1], temperature=0.0, avg_logprob=-0.1,
                            compression_ratio=1.0, no_speech_prob=0.0, words=ws)
            segs.append(s)
        assert ttr._is_segment_anomaly(segs[0]) == jtr._is_segment_anomaly(segs[1])
        assert ttr._get_end([segs[0]]) == jtr._get_end([segs[1]])
        assert (ttr._next_words_segment([segs[0]]) is None) == (
            jtr._next_words_segment([segs[1]]) is None)
    assert ttr._is_segment_anomaly(None) is False and ttr._get_end([]) is None


def test_sampled_ladder_end_to_end(models, speechy_audio):
    """Beam at t=0, then best_of sampling; the random model's low log-probs
    push windows up the ladder. Sampling matches JAX in distribution only,
    so this checks the schema and that the rungs ran."""
    _, tm = models
    r = tm.transcribe(speechy_audio[: 35 * SR], language="en",
                      temperature=(0.0, 0.4), beam_size=2, best_of=2,
                      sample_len=12)
    assert r["segments"] and r["duration"] == pytest.approx(35.0)
    assert [s["id"] for s in r["segments"]] == list(range(len(r["segments"])))
    assert {s["temperature"] for s in r["segments"]} <= {0.0, 0.4}
    for s in r["segments"]:
        assert s["start"] <= s["end"] and np.isfinite(s["avg_logprob"])
        assert all(0 <= t < tm.cfg.n_vocab for t in s["tokens"])


def test_unported_options_and_bad_audio_raise(models, speechy_audio):
    """Word timestamps are ported: 8 s with them give JAX's segments and
    words. A draft model (speculative decoding, ported) gives the plain
    segments; audio that is not mono raises."""
    jm, tm = models
    kw = dict(language="en", temperature=0.0, sample_len=8, word_timestamps=True,
              **QUIET)
    ours = tm.transcribe(speechy_audio[:8 * SR], **kw)
    ref = jm.transcribe(speechy_audio[:8 * SR], **kw)
    _assert_same(ours, ref)
    assert [[(w["word"], w["start"], w["end"]) for w in s["words"]]
            for s in ours["segments"]] == [[(w["word"], w["start"], w["end"])
                                            for w in s["words"]]
                                           for s in ref["segments"]]
    assert any(s["words"] for s in ours["segments"])
    drafted = tm.transcribe(speechy_audio[:8 * SR], draft_model=tm, **kw)
    _assert_same(drafted, ours)
    with pytest.raises(ValueError, match="mono"):
        tm.transcribe(np.zeros((2, SR), np.float32))
