"""Port batched serving (`serve.transcribe_batch`, `serve_cb`) against the
JAX package's.

With a tiny model (real 1500/3000 geometry, fp32, same weights) the
segments of every request (seek, start, end, tokens, text) must be equal to
JAX's under the static and the continuous scheduler, with bf16 and with
int8 caches, with `initial_prompt` and with the VAD gate. The speculative
seek and its repair rounds are driven with one scripted decode() on both
sides. Sampled continuous-batching rows draw other noise than JAX's
`jax.random` keys, so they are checked in distribution only."""

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import serve as jsv
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.decoding import DecodingResult as JaxResult
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu_torch import ServeOptions, build_model, transcribe_batch
from openai_whisper_coreml_tpu_torch import serve_cb as tcb
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.decoding import DecodingResult, NEG_INF
from openai_whisper_coreml_tpu_torch.models import decoder as dec_mod
from openai_whisper_coreml_tpu_torch.params import from_jax_params

tsv = importlib.import_module("openai_whisper_coreml_tpu_torch.serve")

# tiny tensors: one torch thread per test worker keeps parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

SR = 16_000
COMMON = dict(batch_size=2, language="en", temperature=(0.0,), sample_len=12,
              chunk_tokens=8, no_speech_threshold=None, logprob_threshold=None,
              compression_ratio_threshold=None)


@pytest.fixture(scope="module")
def models():
    kw = dict(n_state=64, n_head=2, n_layer=2)
    params = jax_init(jax_tiny(**kw), jax.random.PRNGKey(0))
    return (JaxModel(cfg=jax_tiny(**kw), params=params),
            from_jax_params(jax.tree.map(np.asarray, params), tiny_test_config(**kw)))


def _speechy(seconds, seed):
    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.default_rng(seed)
    return (0.2 * np.sin(2 * np.pi * 200 * t) * (1 + 0.5 * np.sin(2 * np.pi * 2 * t))
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def clips():
    return [_speechy(20, 1), _speechy(35, 2), _speechy(50, 3)]


def _key(results):
    return [(r["text"], r["language"], r["duration"],
             [(s["id"], s["seek"], s["start"], s["end"], s["tokens"], s["text"],
               s["temperature"]) for s in r["segments"]]) for r in results]


def _assert_same(ours, ref):
    assert _key(ours) == _key(ref)
    for o, r in zip(ours, ref):
        for so, sr in zip(o["segments"], r["segments"]):
            for k in ("avg_logprob", "no_speech_prob", "compression_ratio"):
                assert so[k] == pytest.approx(sr[k], abs=1e-5), k


@pytest.mark.parametrize("scheduler,cache_dtype", [
    ("static", "bf16"), ("continuous", "bf16"), ("static", "int8"),
    ("continuous", "int8")])
def test_transcribe_batch_matches_jax(models, clips, scheduler, cache_dtype):
    """Three requests (1, 2 and 2 windows) through two rows: fp32 segments
    equal JAX's. The int8 case quantises the cross-KV and the self cache."""
    jm, tm = models
    kw = dict(COMMON, scheduler=scheduler, cache_dtype=cache_dtype,
              kv_dtype=cache_dtype)
    ours = transcribe_batch(tm, clips, ServeOptions(**kw))
    ref = jsv.transcribe_batch(jm, clips, jsv.ServeOptions(**kw))
    assert [len(r["segments"]) for r in ours] == [len(r["segments"]) for r in ref]
    assert all(r["segments"] for r in ours)
    _assert_same(ours, ref)


@pytest.mark.parametrize("scheduler,beam_size", [
    ("static", None), ("continuous", None), ("static", 2)])
def test_initial_prompt_matches_jax(models, clips, scheduler, beam_size):
    """initial_prompt conditions each request's first window: per-row
    prompts (static), per-row pads (continuous), and the prompted/unprompted
    partition under beam search."""
    jm, tm = models
    kw = dict(COMMON, scheduler=scheduler, beam_size=beam_size,
              initial_prompt="glossary: TPU, XLA, Pallas")
    ours = transcribe_batch(tm, clips[:2], ServeOptions(**kw))
    _assert_same(ours, jsv.transcribe_batch(jm, clips[:2], jsv.ServeOptions(**kw)))
    if beam_size is None:
        bare = transcribe_batch(tm, clips[:2], ServeOptions(
            **dict(kw, initial_prompt=None)))
        assert _key(bare) != _key(ours)  # the prompt changes the decode


def test_vad_filter_matches_jax(models):
    """A silent first window is gated by the VAD (no segments, full
    advance); the speech after it is decoded as JAX decodes it."""
    jm, tm = models
    audio = np.concatenate([np.zeros(31 * SR, np.float32), _speechy(20, 4)])
    # the gated window is a no-speech skip under the default thresholds
    kw = dict(COMMON, scheduler="continuous", vad_filter=True,
              no_speech_threshold=0.6, logprob_threshold=-1.0)
    ours = transcribe_batch(tm, [audio], ServeOptions(**kw))
    _assert_same(ours, jsv.transcribe_batch(jm, [audio], jsv.ServeOptions(**kw)))
    assert ours[0]["segments"] and min(s["seek"] for s in ours[0]["segments"]) > 0


def _fake_mel(frames, rid):
    """A 'mel' whose column 0 row 0 holds its frame index and row 1 the frame
    index plus 100000 times the request id, so a scripted decode knows
    which window of which request it got."""
    col = np.arange(frames, dtype=np.float32)
    out = np.broadcast_to(col, (80, frames)).copy()
    out[1] = col + rid * 100000
    return out


class _FakeJax:
    def __init__(self):
        self.cfg = jax_tiny()
        self.mesh = None


class _FakePort:
    def __init__(self):
        self.cfg = tiny_test_config()
        self.device = torch.device("cpu")

    def log_mel(self, audio):
        audio = np.asarray(audio)
        frames = audio.shape[-1] // 160
        return torch.from_numpy(np.stack([
            _fake_mel(frames, 0 if frames >= 6750 else 1) for _ in audio]))


def test_speculative_seek_repair_matches_jax(monkeypatch):
    """The scripted decode of tests/test_serve_seek.py on both sides:
    request 0 advances mid-window (to 6 s, then to 36 s), request 1 by
    full windows. The speculative windows at 30 s are decoded and dropped,
    the repair windows are decoded in batched rounds, one call each, and
    the segments equal JAX's."""
    ts = tiny_test_config().timestamp_begin
    script = {
        (0, 0): [ts, 100, ts + 300, ts + 300, 101],
        (0, 600): [ts, 102, ts + 1450],
        (0, 3600): [ts, 103, ts + 190],
        (0, 3000): [ts, 107],
        (1, 0): [ts, 104, ts + 1450],
        (1, 3000): [ts, 105, ts + 500],
    }
    calls = {"jax": [], "port": []}

    def scripted(side, result_type):
        def decode(model, x, options, **kw):
            x = np.asarray(x)
            seen, out = set(), []
            for row in (x if x.ndim == 3 else x[None]):
                off = int(row[0, 0])
                rid = int(round(float(row[1, 0]) - off)) // 100000
                seen.add((rid, off))
                out.append(result_type(
                    tokens=list(script[(rid, off)]), text="", language="en",
                    language_probs=None, avg_logprob=-0.2, no_speech_prob=0.0,
                    temperature=0.0, compression_ratio=1.0))
            calls[side].append(seen)
            return out
        return decode

    def jax_mel(x, n_mels=80, **kw):
        x = np.asarray(x)
        mels = [_fake_mel(row.shape[-1] // 160,
                          0 if row.shape[-1] // 160 >= 6750 else 1)
                for row in x.reshape(-1, x.shape[-1])]
        return np.stack(mels) if x.ndim == 2 else mels[0]

    monkeypatch.setattr(jsv, "decode", scripted("jax", JaxResult))
    monkeypatch.setattr(jsv, "log_mel_spectrogram", jax_mel)
    monkeypatch.setattr(tsv, "decode", scripted("port", DecodingResult))
    audios = [np.zeros(40 * SR, np.float32), np.zeros(35 * SR, np.float32)]
    kw = dict(COMMON, batch_size=4)
    kw.pop("chunk_tokens")
    ref = jsv.transcribe_batch(_FakeJax(), audios, jsv.ServeOptions(**kw))
    ours = transcribe_batch(_FakePort(), audios, ServeOptions(**kw))
    _assert_same(ours, ref)
    assert {s["seek"] for s in ours[0]["segments"]} == {0, 600, 3600}
    assert {s["seek"] for s in ours[1]["segments"]} == {0, 3000}
    assert sum(1 for c in calls["port"] if (0, 600) in c) == 1
    assert calls["port"] == calls["jax"]


def test_serve_options_match_jax_but_speculative_fields():
    """The port's ServeOptions are JAX's, with JAX's defaults, the three
    fields a draft model reads included (speculative decoding is ported);
    word timestamps are taken, and refused without timestamps as JAX
    refuses them, and continuous with beam_size is taken."""
    ours = {f.name: f.default for f in dataclasses.fields(ServeOptions)}
    ref = {f.name: f.default for f in dataclasses.fields(jsv.ServeOptions)}
    assert set(ref) == set(ours)
    assert {"spec_k", "spec_fallback", "spec_fallback_threshold"} <= set(ours)
    assert ours == ref
    assert ServeOptions(temperature=0.4).temperature == (0.4,)
    assert ServeOptions(word_timestamps=True).word_timestamps
    for cls in (ServeOptions, jsv.ServeOptions):
        with pytest.raises(ValueError, match="requires timestamps"):
            cls(word_timestamps=True, without_timestamps=True)
    # beam under the continuous scheduler is ported (serve_cb_beam.py)
    assert ServeOptions(scheduler="continuous", beam_size=2).beam_size == 2
    with pytest.raises(ValueError, match="scheduler"):
        ServeOptions(scheduler="round-robin")


@pytest.fixture(scope="module")
def narrow():
    """A port model with an 8-position audio context for decode-level tests
    at many rows."""
    return build_model(tiny_test_config(n_state=64, n_head=2, n_layer=2,
                                        n_audio_ctx=8), seed=3, device="cpu")


def _prefill(model, rows, sample_len, cache_len, temps):
    cfg = model.cfg
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (rows, cfg.n_audio_ctx, cfg.n_audio_state)).astype(np.float32) * 0.1)
    cross = dec_mod.precompute_cross_kv(model.decoder, feats)
    initial = torch.tensor([[cfg.eot_token, cfg.sot_token, cfg.lang_token_start,
                             cfg.transcribe_token]] * rows)
    return tcb.prefill_from_cross(
        model.decoder, cross, initial, temps, torch.zeros(rows, dtype=torch.long),
        torch.ones(rows, dtype=torch.long), sample_len=sample_len, prompt_len=4,
        cache_len=cache_len)


def test_sampled_rows_follow_the_softmax(narrow, monkeypatch):
    """Continuous-batching rows at temperature T draw token v with
    probability softmax(logits / T)[v]. The decoder step is stubbed to give
    every row the same logits over four tokens at every step, so 24 sampled
    rows times 48 steps give that histogram (total variation below 0.05);
    rows at temperature 0 in the same batch take the argmax at every step."""
    rows, steps, temp = 32, 48, 0.7
    temps = torch.where(torch.arange(rows) % 4 == 0, 0.0, temp)
    state = _prefill(narrow, rows, sample_len=steps, cache_len=128, temps=temps)
    vocab = [400, 401, 402, 403]
    values = torch.tensor([1.0, 0.5, 0.0, -1.0])
    logits = torch.full_like(state.logits, NEG_INF)
    logits[:, vocab] = values
    monkeypatch.setattr(tcb.dec_mod, "decode_step",
                        lambda decoder, tok, cross, cache, pos, **kw:
                        (logits[:, None], cache))
    none = torch.zeros(logits.shape[-1], dtype=torch.bool)
    state, step = tcb.decode_chunk(
        narrow.decoder, state._replace(logits=logits), none, none, -1,
        chunk=steps, use_timestamps=False, prompt_len=4, total_len=4 + steps,
        sampled=True)
    drawn = state.tokens[:, 4:]
    assert step == steps and (drawn[temps == 0] == vocab[0]).all()
    sampled = drawn[temps > 0]
    freq = torch.stack([(sampled == v).float().mean() for v in vocab])
    assert float(freq.sum()) == pytest.approx(1.0)
    want = torch.softmax(values / temp, dim=0)
    assert 0.5 * (freq - want).abs().sum() < 0.05


def test_finished_row_keeps_its_tokens_and_cache_at_448(narrow):
    """total_len == cache_len == 448 (sample_len clipped to the context): a
    finished row frozen at pos == 448 keeps the token it sampled at 447 and
    its cache while the other row decodes on (tests/test_serve_cb.py's
    sentinel check, and the out-of-cache write guard)."""
    cfg = narrow.cfg
    total = cfg.n_text_ctx
    for cache_dtype in ("bf16", "int8"):
        state = _prefill(narrow, 2, sample_len=total - 4, cache_len=total,
                         temps=torch.zeros(2))
        if cache_dtype == "int8":
            cache = dec_mod.init_kv_cache_int8(cfg, 2, "cpu", ctx=total)
            state = state._replace(cache=cache)
        sentinel = 1234
        state.tokens[0, total - 1] = sentinel
        state = state._replace(finished=torch.tensor([True, False]),
                               pos=torch.tensor([total, 4]))
        before = [t[:, 0].clone() for t in state.cache]
        none = torch.zeros(cfg.n_vocab, dtype=torch.bool)
        no_eot = none.clone()
        no_eot[cfg.eot_token] = True  # row 1 decodes all three steps
        state, _ = tcb.decode_chunk(
            narrow.decoder, state, no_eot, none, -1, chunk=3, use_timestamps=False,
            prompt_len=4, total_len=total)
        assert int(state.tokens[0, total - 1]) == sentinel
        assert state.pos.tolist() == [total, 7]
        for a, t in zip(before, state.cache):
            torch.testing.assert_close(t[:, 0], a, rtol=0, atol=0)


def test_continuous_ladder_arrivals_and_empty_stream(models, clips):
    """Sampled rows through the whole engine: an impossible log-prob gate
    sends every window down the ladder, so every segment ends at the last
    temperature (as in JAX), the same on two runs. Windows arriving in
    waves (open loop) decode to the closed run's tokens; a stream that
    closes empty returns."""
    _, tm = models
    kw = dict(COMMON, scheduler="continuous", temperature=(0.0, 0.5),
              logprob_threshold=1e9)
    first = transcribe_batch(tm, clips[:2], ServeOptions(**kw))
    assert all(r["segments"] for r in first)
    assert {s["temperature"] for r in first for s in r["segments"]} == {0.5}
    assert _key(transcribe_batch(tm, clips[:2], ServeOptions(**kw))) == _key(first)

    opts = ServeOptions(**dict(COMMON, scheduler="continuous"))
    mels = tsv._batched_mels(tm, clips)

    def windows():
        return [w for i, a in enumerate(clips)
                for w in tsv._windows_for(mels[i], len(a), i)]

    wins = windows()
    waves = [wins[:1], [], wins[1:3], [], wins[3:]]
    polls = {"n": 0}

    def arrivals():
        i = polls["n"]
        polls["n"] += 1
        return waves[i] if i < len(waves) else None

    tcb.ContinuousBatcher(tm, opts).run([], arrivals=arrivals)
    closed = windows()
    tcb.ContinuousBatcher(tm, opts).run(closed)
    assert [w.result.tokens for w in wins] == [w.result.tokens for w in closed]
    assert polls["n"] > len(waves)
    tcb.ContinuousBatcher(tm, opts).run([], arrivals=lambda: None)
