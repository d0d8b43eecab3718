"""Port streaming (`stream.py`) against the JAX package's.

The same audio goes through JAX's and the port's `StreamingTranscriber`
and `MultiStreamTranscriber` on one tiny fp32 model (same weights): every
event (text, tokens, is_final) must be equal, through confirmation, a
trim with its dedup, per-stream conditioning and `finish`. Then the JAX
streaming tests' unit checks, on the port."""

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import stream as jst
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu_torch import stream as tst
from openai_whisper_coreml_tpu_torch.config import SAMPLE_RATE, tiny_test_config
from openai_whisper_coreml_tpu_torch.params import from_jax_params

torch.set_num_threads(1)

SR = 16_000


@pytest.fixture(scope="module")
def models():
    kw = dict(n_state=64, n_head=2, n_layer=2)
    params = jax_init(jax_tiny(**kw), jax.random.PRNGKey(0))
    return (JaxModel(cfg=jax_tiny(**kw), params=params),
            from_jax_params(jax.tree.map(np.asarray, params), tiny_test_config(**kw)))


@pytest.fixture(scope="module")
def model(models):
    return models[1]


def _tone(seconds, seed, hz=200):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.2 * np.sin(2 * np.pi * hz * t)
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


def _events(evs):
    return [(e.text, list(e.tokens), e.is_final) for e in evs]


def _stream(st, audio):
    out = []
    for off in range(0, len(audio), SR):  # 1 s chunks
        out += _events(st.feed(audio[off:off + SR]))
    return out + _events(st.finish())


@pytest.mark.parametrize("seconds,kw", [
    (8, dict(agreement=2, decode_interval=2.0, sample_len=6)),
    # 32 s at agreement 1: the buffer passes 29 s and trims, committing the
    # confirmed text as the next ticks' prompt and arming the dedup
    (32, dict(agreement=1, decode_interval=4.0, sample_len=4)),
], ids=["agreement-2", "trim"])
def test_streaming_events_match_jax(models, seconds, kw):
    jm, tm = models
    audio = _tone(seconds, 0)
    ref = _stream(jst.StreamingTranscriber(jm, language="en", **kw), audio)
    ours_st = tst.StreamingTranscriber(tm, language="en", **kw)
    ours = _stream(ours_st, audio)
    assert ours == ref
    assert ours[-1][2] is True and any(tokens for _, tokens, _ in ours)
    if seconds > 30:
        assert ours_st._prompt, "the trim must commit confirmed text"


def test_multistream_events_match_jax(models):
    """Two streams of different audio, one with a committed prompt, through
    the batched tick: each stream's events equal JAX's."""
    jm, tm = models
    audios = [_tone(6, 1), _tone(4, 2, hz=260)]

    def run(mod, model):
        mst = mod.MultiStreamTranscriber(model, n_streams=2, language="en",
                                         agreement=2, decode_interval=1.0,
                                         sample_len=6)
        mst.streams[1]._prompt = [44, 45]
        out = {0: [], 1: []}
        for off in range(0, 6 * SR, SR):
            for i, a in enumerate(audios):
                if off < len(a):
                    mst.feed(i, a[off:off + SR])
            for i, evs in mst.poll().items():
                out[i] += _events(evs)
        for i in out:
            out[i] += _events(mst.finish(i))
        return out

    ours = run(tst, tm)
    assert ours == run(jst, jm)
    assert all(evs[-1][2] is True for evs in ours.values())


def test_draft_model_raises_naming_speculative(model):
    """A draft no longer raises: both stream classes take one, each with its
    acceptance governor, and a self-draft streams the plain events."""
    from openai_whisper_coreml_tpu_torch import speculative

    audio = _tone(4, 3)
    kw = dict(language="en", agreement=1, decode_interval=2.0, sample_len=8)
    plain = _stream(tst.StreamingTranscriber(model, **kw), audio)
    st = tst.StreamingTranscriber(model, draft_model=model, spec_k=3, **kw)
    before = speculative.TOTALS["iters"]
    assert _stream(st, audio) == plain
    assert speculative.TOTALS["iters"] > before
    assert st._spec_gov is not None and not st._spec_gov.disabled
    mst = tst.MultiStreamTranscriber(model, n_streams=1, draft_model=model)
    assert mst._spec_gov is not None and mst.draft_model is model


# -- the JAX streaming tests' unit checks, on the port -----------------------

def test_streaming_confirms_monotonically(model):
    st = tst.StreamingTranscriber(model, language="en", agreement=2,
                                  decode_interval=2.0, sample_len=6)
    audio = _tone(8, 0)
    confirmed: list = []
    for off in range(0, len(audio), SR):
        for ev in st.feed(audio[off:off + SR]):
            before = list(confirmed)
            confirmed.extend(ev.tokens)
            assert confirmed[:len(before)] == before
    finals = st.finish()
    assert finals and finals[-1].is_final and isinstance(finals[-1].text, str)


def test_streaming_requires_positive_agreement(model):
    with pytest.raises(ValueError):
        tst.StreamingTranscriber(model, agreement=0)


def test_streaming_trims_long_buffer(model):
    rng = np.random.default_rng(1)
    st = tst.StreamingTranscriber(model, language="en", agreement=1,
                                  decode_interval=10.0, sample_len=4)
    for _ in range(4):  # 40 s in all; the buffer must stay near 30 s
        st.feed((0.1 * rng.standard_normal(10 * SR)).astype(np.float32))
    assert len(st._buffer) <= 30 * SR
    st.finish()


def test_finish_never_contradicts_confirmed(model, monkeypatch):
    st = tst.StreamingTranscriber(model, language="en", agreement=1)
    st._buffer = np.zeros(SR, np.float32)
    st._confirmed = [10, 11, 12]
    monkeypatch.setattr(st, "_decode_window", lambda: [10, 99, 98, 97])
    finals = st.finish()
    assert finals[-1].is_final and finals[-1].tokens == []  # diverged

    st2 = tst.StreamingTranscriber(model, language="en", agreement=1)
    st2._buffer = np.zeros(SR, np.float32)
    st2._confirmed = [10, 11]
    monkeypatch.setattr(st2, "_decode_window", lambda: [10, 11, 12, 13])
    assert st2.finish()[-1].tokens == [12, 13]


def test_tick_sample_len_scales_with_buffer(model):
    st = tst.StreamingTranscriber(model, language="en", max_tokens_per_second=8.0)
    for secs, want in ((2, 32), (10, 128), (30, None)):
        st._buffer = np.zeros(secs * SR, np.float32)
        assert st._tick_sample_len() == want
    st2 = tst.StreamingTranscriber(model, language="en", sample_len=6)
    for secs in (2, 30):  # an explicit sample_len bounds the cap
        st2._buffer = np.zeros(secs * SR, np.float32)
        assert st2._tick_sample_len() == 6
    st3 = tst.StreamingTranscriber(model, language="en", max_tokens_per_second=None)
    st3._buffer = np.zeros(2 * SR, np.float32)
    assert st3._tick_sample_len() is None


def test_multistream_batched_poll_equals_solo(model):
    audio = _tone(6, 3)
    mst = tst.MultiStreamTranscriber(model, n_streams=2, language="en",
                                     agreement=2, decode_interval=2.0, sample_len=6)
    confirmed = {0: [], 1: []}
    for off in range(0, len(audio), SR):
        mst.feed(0, audio[off:off + SR])
        mst.feed(1, audio[off:off + SR])
        for i, evs in mst.poll().items():
            for ev in evs:
                confirmed[i].extend(ev.tokens)
    assert confirmed[0] == confirmed[1]
    assert mst.finish(0)[-1].is_final
    st = tst.StreamingTranscriber(model, language="en", agreement=2,
                                  decode_interval=2.0, sample_len=6)
    solo = []
    for off in range(0, len(audio), SR):
        for ev in st.feed(audio[off:off + SR]):
            solo.extend(ev.tokens)
    assert solo == confirmed[0]


def test_multistream_due_gating(model):
    mst = tst.MultiStreamTranscriber(model, n_streams=2, language="en",
                                     decode_interval=2.0, sample_len=4)
    mst.feed(0, np.zeros(SR, np.float32))  # 1 s: not due
    assert mst.poll() == {}
    mst.feed(0, np.zeros(2 * SR, np.float32))  # 3 s: due
    mst.poll()
    assert mst.streams[0]._since_decode == 0
    assert len(mst.streams[1]._buffer) == 0


def test_make_event_dedups_once_after_trim(model):
    st = tst.StreamingTranscriber(model, language="en")
    st._emitted_tail = [5, 6, 7]
    st._dedup_pending = True
    assert st._make_event([6, 7, 8]).tokens == [8]
    assert st._make_event([8, 9]).tokens == [8, 9]  # one-shot
    st2 = tst.StreamingTranscriber(model, language="en")
    st2._emitted_tail = [5, 6, 7]
    assert st2._make_event([6, 7]).tokens == [6, 7]  # no trim pending
    st3 = tst.StreamingTranscriber(model, language="en")
    st3._emitted_tail = [1, 2]
    st3._dedup_pending = True
    assert st3._make_event([1, 2]) is None


def test_multistream_per_stream_conditioning(model):
    audio = _tone(3, 5, hz=220)
    mst = tst.MultiStreamTranscriber(model, n_streams=2, language="en",
                                     agreement=1, decode_interval=1.0, sample_len=8)
    mst.streams[0]._prompt = [41, 42, 43]
    mst.streams[1]._prompt = [44, 45]
    mst.feed(0, audio)
    mst.feed(1, audio)
    mst.poll()

    def solo_hyp(prompt):
        st = tst.StreamingTranscriber(model, language="en", agreement=1,
                                      decode_interval=1.0, sample_len=8)
        st._prompt = list(prompt)
        st._buffer_samples(audio)
        return st._decode_window()

    hyp0 = mst.streams[0]._hyps[-1]
    assert hyp0 == solo_hyp([41, 42, 43])
    assert mst.streams[1]._hyps[-1] == solo_hyp([44, 45])
    off = tst.MultiStreamTranscriber(model, n_streams=2, language="en", agreement=1,
                                     decode_interval=1.0, sample_len=8,
                                     condition_on_committed_text=False)
    off.streams[0]._prompt = [41, 42, 43]
    off.feed(0, audio)
    off.feed(1, audio)
    off.poll()
    assert off.streams[0]._hyps[-1] != hyp0


def test_vad_gate_skips_silent_ticks(model, monkeypatch):
    st = tst.StreamingTranscriber(model, language="en", decode_interval=0.5,
                                  vad_gate=True)
    calls = []
    real = st._decode_window
    monkeypatch.setattr(st, "_decode_window", lambda: calls.append(1) or real())
    silence = (1e-6 * np.random.default_rng(0).standard_normal(8000)).astype(np.float32)
    for _ in range(4):
        st.feed(silence)
    assert calls == []
    t = np.arange(SR) / SR
    st.feed((0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32))
    assert calls


def test_multistream_vad_gate_drops_silent_rows(model, monkeypatch):
    mst = tst.MultiStreamTranscriber(model, n_streams=2, language="en",
                                     decode_interval=0.25, vad_gate=True)
    t = np.arange(8000) / SR
    rows = []
    real = tst.decode

    def spy(model_, mel, opts, **kw):
        rows.append(mel.shape[0])
        return real(model_, mel, opts, **kw)

    monkeypatch.setattr(tst, "decode", spy)
    mst.feed(0, (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32))
    mst.feed(1, (1e-6 * np.random.default_rng(1).standard_normal(8000)).astype(np.float32))
    mst.poll()
    assert mst.streams[1]._since_decode == 0
    assert rows == [1]  # the silent stream took no batch row


def test_vad_gate_bounds_silent_buffer(model):
    st = tst.StreamingTranscriber(model, language="en", decode_interval=0.5,
                                  vad_gate=True)
    silence = (1e-6 * np.random.default_rng(2).standard_normal(8000)).astype(np.float32)
    for _ in range(20):
        st.feed(silence)
    assert len(st._buffer) <= 5 * SAMPLE_RATE
