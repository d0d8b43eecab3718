"""Port HTTP server (`serve_http.py`): the JAX server's tests on the port's
tiny CPU model (in-process server on a free loopback port, urllib client),
plus its transcripts and words against JAX's `transcribe_batch` on the
same weights, and `main`'s refusals of what is not ported."""

import io
import json
import threading
import time
import urllib.error
import urllib.request
import wave

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import serve as jsv
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu_torch import serve_http as tsh
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.params import from_jax_params
from openai_whisper_coreml_tpu_torch.serve_http import WhisperHTTPServer
from openai_whisper_coreml_tpu_torch.utils.audio_io import decode_wav_bytes

torch.set_num_threads(1)

NO_GATES = {"no_speech_threshold": None, "logprob_threshold": None,
            "compression_ratio_threshold": None}


@pytest.fixture(scope="module")
def models():
    kw = dict(n_state=64, n_head=2, n_layer=2)
    params = jax_init(jax_tiny(**kw), jax.random.PRNGKey(0))
    return (JaxModel(cfg=jax_tiny(**kw), params=params),
            from_jax_params(jax.tree.map(np.asarray, params), tiny_test_config(**kw)))


@pytest.fixture(scope="module")
def model(models):
    return models[1]


@pytest.fixture(scope="module")
def server(model):
    srv = WhisperHTTPServer(model, port=0, batch_size=2, batch_window_ms=20)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def oa_server(model):
    """Deterministic defaults for the OpenAI-compatible API (random
    weights: quality gates off, a short decode)."""
    srv = WhisperHTTPServer(model, port=0, batch_size=2, batch_window_ms=20,
                            default_options={**NO_GATES, "sample_len": 6})
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def _wav_bytes(audio, rate=16000):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(rate)
        wf.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _url(srv, path):
    return f"http://127.0.0.1:{srv.port}{path}"


def _post(srv, path, body, headers=None):
    req = urllib.request.Request(_url(srv, path), data=body, headers=headers or {},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def _post_raw(srv, path, body, headers):
    req = urllib.request.Request(_url(srv, path), data=body, headers=headers,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _get(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=30) as r:
        return r.status, json.loads(r.read())


def _multipart(fields, file_bytes=None, filename="a.wav"):
    bound = "whisperportboundary42"
    body = b""
    for k, vals in fields.items():
        for v in (vals if isinstance(vals, list) else [vals]):
            body += (f"--{bound}\r\nContent-Disposition: form-data; "
                     f"name=\"{k}\"\r\n\r\n{v}\r\n").encode()
    if file_bytes is not None:
        body += (f"--{bound}\r\nContent-Disposition: form-data; "
                 f"name=\"file\"; filename=\"{filename}\"\r\n"
                 "Content-Type: application/octet-stream\r\n\r\n").encode()
        body += file_bytes + b"\r\n"
    body += f"--{bound}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={bound}"}


def _speechy(seconds, seed):
    t = np.arange(int(seconds * 16_000)) / 16_000
    rng = np.random.default_rng(seed)
    return (0.2 * np.sin(2 * np.pi * 200 * t) * (1 + 0.5 * np.sin(2 * np.pi * 2 * t))
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


def test_transcripts_equal_jax_transcribe_batch(models):
    """Two concurrent /transcribe requests, micro-batched into one batch:
    each answer equals JAX's transcribe_batch of the same audio (text and
    every segment)."""
    jm, tm = models
    audios = [_speechy(6, 1), _speechy(35, 2)]
    opts = dict(language="en", sample_len=8, temperature=(0.0,), **NO_GATES)
    ref = jsv.transcribe_batch(jm, audios, jsv.ServeOptions(batch_size=2, **opts))
    srv = WhisperHTTPServer(tm, port=0, batch_size=2, batch_window_ms=500,
                            default_options=opts)
    srv.start()
    try:
        out = [None, None]

        def hit(i):
            out[i] = _post(srv, "/transcribe", _wav_bytes(audios[i]))[1]

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert srv.metrics.counter("batches_total") == 1
    finally:
        srv.stop()
    keys = ("seek", "start", "end", "tokens", "text")
    for ours, theirs in zip(out, ref):
        assert ours["text"] == theirs["text"] and ours["segments"]
        assert ([[s[k] for k in keys] for s in ours["segments"]]
                == [[s[k] for k in keys] for s in theirs["segments"]])


def test_word_timestamps_on_both_routes_match_jax(models, oa_server):
    """Word timestamps on both routes: /transcribe?word_timestamps=1 puts
    JAX's words (transcribe_batch on the same audio and options) on each
    segment, and the OpenAI route with timestamp_granularities[]=word
    answers verbose_json with the same words, flat and per segment. No
    batch fails, and the server goes on serving."""
    jm, _ = models
    raw = _wav_bytes(_speechy(6, 5))
    audio = decode_wav_bytes(raw)
    ref = jsv.transcribe_batch(jm, [audio], jsv.ServeOptions(
        batch_size=2, language="en", word_timestamps=True, sample_len=6,
        **NO_GATES))[0]
    ref_words = [[(w["word"], w["start"], w["end"]) for w in s["words"]]
                 for s in ref["segments"]]
    assert any(ref_words)
    failed = oa_server.metrics.counter("batches_failed")
    status, out = _post(oa_server, "/transcribe?language=en&word_timestamps=1", raw)
    assert status == 200 and out["text"] == ref["text"]
    assert [[(w["word"], w["start"], w["end"]) for w in s["words"]]
            for s in out["segments"]] == ref_words
    for s, r in zip(out["segments"], ref["segments"]):
        for a, b in zip(s["words"], r["words"]):
            assert a["probability"] == pytest.approx(b["probability"], abs=1e-5)
    body, headers = _multipart({"language": "en", "response_format": "verbose_json",
                                "timestamp_granularities[]": ["segment", "word"]}, raw)
    status, _, body = _post_raw(oa_server, "/v1/audio/transcriptions", body, headers)
    oa = json.loads(body)
    assert status == 200 and oa["segments"] == out["segments"]
    assert oa["words"] == [w for s in out["segments"] for w in s["words"]]
    assert oa_server.metrics.counter("batches_failed") == failed
    status, out = _post(oa_server, "/transcribe?language=en", raw)
    assert status == 200 and "segments" in out and "words" not in out["segments"][0]


class _Started(Exception):
    pass


def _main_server(monkeypatch, model, argv):
    """Run main up to the server's start; returns (server, load_model
    calls). Each load_model call gets its own shallow copy of the model, so
    a draft set on it stays in this test."""
    import copy

    made, loads = {}, []

    def fake_load(name, **kw):
        loads.append((name, kw))
        return copy.copy(model)

    def fake_start(self):
        made["server"] = self
        raise _Started

    monkeypatch.setattr("openai_whisper_coreml_tpu_torch.load_model", fake_load)
    monkeypatch.setattr(WhisperHTTPServer, "start", fake_start)
    with pytest.raises(_Started):
        tsh.main(["--port", "0"] + argv)
    return made["server"], loads


@pytest.mark.parametrize("argv,what", [
    (["--draft-model", "tiny"], "speculative.py"),
    (["--tensor-parallel", "2"], "parallel/"),
])
def test_main_loads_draft_and_refuses_tensor_parallel(argv, what, model, monkeypatch):
    """--tensor-parallel > 1 outside a torchrun launch raises, saying how
    to launch the server's ranks (the mesh server itself:
    test_torch_parallel_serve_http.py). --draft-model is ported: the draft
    loads through load_model with the server's quantisation, is checked
    against the target, and becomes model.draft."""
    if what != "speculative.py":
        for name in ("WORLD_SIZE", "NUM_PROCESSES"):
            monkeypatch.delenv(name, raising=False)
        with pytest.raises(RuntimeError,
                           match="torchrun.*openai_whisper_coreml_tpu_torch.serve_http"):
            tsh.main(argv)
        return
    srv, loads = _main_server(monkeypatch, model,
                              argv + ["--draft-checkpoint", "d.safetensors"])
    assert [name for name, _ in loads] == ["tiny", "tiny"]
    assert loads[1][1]["checkpoint"] == "d.safetensors"
    assert srv.model.draft is not None and srv.model.draft is not srv.model
    assert model.draft is None


@pytest.mark.parametrize("argv", [["--draft-checkpoint", "x"], ["--spec-k", "6"]])
def test_main_takes_speculative_flags(argv, model, monkeypatch):
    """The draft's flags are JAX's and are taken: --spec-k reaches the
    serving options; without --draft-model no draft is loaded."""
    srv, loads = _main_server(monkeypatch, model, argv)
    assert len(loads) == 1 and srv.model.draft is None
    assert srv.default_options["spec_k"] == (6 if "--spec-k" in argv else 4)


def test_main_default_options_carry_spec_k(model, monkeypatch):
    """main's default_options are ServeOptions fields, spec_k among them
    as in JAX; the model comes from load_model."""
    srv, _ = _main_server(monkeypatch, model,
                          ["--kv-dtype", "int8", "--scheduler", "continuous",
                           "--spec-k", "3"])
    assert srv.default_options == {"kv_dtype": "int8", "scheduler": "continuous",
                                   "spec_k": 3}
    from openai_whisper_coreml_tpu_torch import ServeOptions

    assert ServeOptions(**srv.default_options).spec_k == 3


# -- the JAX server's tests, on the port ----------------------------------------

def test_healthz(server):
    status, body = _get(server, "/healthz")
    assert status == 200 and body["ok"] is True
    assert body["model"] == "test" and body["backend"] == "cpu"


def test_transcribe_endpoint(server, rng):
    audio = (0.2 * rng.standard_normal(16000 * 2)).astype(np.float32)
    status, body = _post(
        server, "/transcribe?language=en&sample_len=6&no_speech_threshold=none"
        "&logprob_threshold=none&compression_ratio_threshold=none&temperature=0.0",
        _wav_bytes(audio))
    assert status == 200 and "segments" in body and "text" in body
    assert abs(body["duration"] - 2.0) < 0.01


def test_detect_endpoint(server, rng):
    status, body = _post(server, "/detect",
                         _wav_bytes((0.2 * rng.standard_normal(16000)).astype(np.float32)))
    assert status == 200 and body["language"] in body["probs"]


def test_raw_audio_header(server, rng):
    audio = (0.1 * rng.standard_normal(16000)).astype(np.float32)
    status, body = _post(
        server, "/transcribe?language=en&sample_len=4&no_speech_threshold=none"
        "&logprob_threshold=none&compression_ratio_threshold=none&temperature=0.0",
        audio.tobytes(), headers={"X-Raw-Audio": "1"})
    assert status == 200 and abs(body["duration"] - 1.0) < 0.01


@pytest.mark.parametrize("path,body,code", [
    ("/transcribe", b"this is not audio", 400),
    ("/transcribe?language=en", b"RIFFgarbagenotawav", 400),
    ("/nope", b"", 404),
])
def test_bad_requests(server, path, body, code):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, path, body)
    assert e.value.code == code


class _FlakyModel:
    """A real model whose encoder raises while `poisoned`."""

    def __init__(self, model):
        self._model = model
        self.cfg = model.cfg
        self.poisoned = False

    def __getattr__(self, name):
        return getattr(self._model, name)

    def encode(self, mel):
        if self.poisoned:
            raise RuntimeError("injected encoder failure")
        return self._model.encode(mel)


def test_failing_request_gets_500_server_keeps_serving(model, rng):
    flaky = _FlakyModel(model)
    srv = WhisperHTTPServer(flaky, port=0, batch_size=2, batch_window_ms=20)
    srv.start()
    try:
        q = ("?language=en&sample_len=4&no_speech_threshold=none"
             "&logprob_threshold=none&compression_ratio_threshold=none")
        flaky.poisoned = True
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv, "/transcribe" + q,
                  _wav_bytes((0.2 * rng.standard_normal(16000)).astype(np.float32)))
        assert exc.value.code == 500
        assert "injected encoder failure" in json.loads(exc.value.read())["error"]
        flaky.poisoned = False
        status, body = _post(srv, "/transcribe" + q, _wav_bytes(
            (0.2 * rng.standard_normal(16000)).astype(np.float32)))
        assert status == 200 and "text" in body
    finally:
        srv.stop()


@pytest.mark.parametrize("defaults", [
    {"scheduler": "continuous", "sample_len": 6},
    {"scheduler": "continuous", "beam_size": 2, "sample_len": 6, **NO_GATES},
], ids=["continuous", "continuous-beam"])
def test_server_default_options_continuous(model, rng, defaults):
    srv = WhisperHTTPServer(model, port=0, batch_size=2, batch_window_ms=20,
                            default_options=defaults)
    srv.start()
    try:
        status, out = _post(srv, "/transcribe?language=en", _wav_bytes(
            (0.1 * rng.standard_normal(12800)).astype(np.float32)))
        assert status == 200 and isinstance(out["text"], str)
    finally:
        srv.stop()


def test_stream_endpoint_incremental_ndjson(server, rng):
    t = np.arange(4 * 16000) / 16000
    audio = (0.2 * np.sin(2 * np.pi * 220 * t)
             + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
    req = urllib.request.Request(_url(server, "/stream?language=en"),
                                 data=_wav_bytes(audio), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.status == 200
        lines = [json.loads(line) for line in r.read().decode().splitlines() if line]
    assert lines and lines[-1]["final"] is True
    assert all("text" in line for line in lines)


def test_stream_endpoint_chunked_raw_pcm(server, rng):
    """A chunked upload of raw float32 PCM: the same events as a
    StreamingTranscriber fed the same pieces."""
    from openai_whisper_coreml_tpu_torch.stream import StreamingTranscriber

    audio = (0.2 * np.sin(2 * np.pi * 240 * np.arange(3 * 16000) / 16000)
             ).astype(np.float32)
    pieces = [audio[i:i + 16000].tobytes() for i in range(0, len(audio), 16000)]

    def chunked():
        for p in pieces:
            yield p

    req = urllib.request.Request(_url(server, "/stream?language=en"), data=chunked(),
                                 headers={"Transfer-Encoding": "chunked"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        lines = [json.loads(line) for line in r.read().decode().splitlines() if line]
    st = StreamingTranscriber(server.model, language="en")
    want = [{"text": ev.text, "final": False}
            for i in range(0, len(audio), 16000) for ev in st.feed(audio[i:i + 16000])]
    want += [{"text": ev.text, "final": True} for ev in st.finish()]
    assert lines == want


def test_stream_of_an_int8_server_equals_jax(models, monkeypatch):
    """A server whose batches decode with int8 cross-KV and cache streams
    with a bf16 cross-KV and cache, as JAX's does: its /stream events equal
    JAX's StreamingTranscriber on the same weights, and every tick decodes
    with bf16 caches."""
    from openai_whisper_coreml_tpu.stream import StreamingTranscriber as JaxStream
    from openai_whisper_coreml_tpu_torch import stream as tstream

    jm, tm = models
    caches = []

    def recording_decode(model, mel, options):
        caches.append((options.kv_dtype, options.cache_dtype))
        return decode(model, mel, options)

    decode = tstream.decode
    monkeypatch.setattr(tstream, "decode", recording_decode)
    audio = (0.2 * np.sin(2 * np.pi * 260 * np.arange(3 * 16000) / 16000)
             ).astype(np.float32)
    srv = WhisperHTTPServer(tm, port=0, batch_size=2, batch_window_ms=20,
                            default_options={"kv_dtype": "int8",
                                             "cache_dtype": "int8"})
    srv.start()
    try:
        req = urllib.request.Request(_url(srv, "/stream?language=en"),
                                     data=audio.tobytes(),
                                     headers={"X-Raw-Audio": "1"}, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            lines = [json.loads(line) for line in r.read().decode().splitlines()
                     if line]
    finally:
        srv.stop()
    st = JaxStream(jm, language="en")
    want = [{"text": ev.text, "final": False}
            for i in range(0, len(audio), 16000) for ev in st.feed(audio[i:i + 16000])]
    want += [{"text": ev.text, "final": True} for ev in st.finish()]
    assert lines == want and lines[-1]["final"] is True
    assert caches and set(caches) == {("bf16", "bf16")}


def test_metrics_endpoint_counts_requests(server, rng):
    _, before = _get(server, "/metrics")
    status, _ = _post(server, "/transcribe?language=en&sample_len=4", _wav_bytes(
        (0.1 * rng.standard_normal(16000)).astype(np.float32)))
    assert status == 200
    _, after = _get(server, "/metrics")
    assert (after["counters"].get("requests_total", 0)
            >= before["counters"].get("requests_total", 0) + 1)
    assert after["counters"].get("batches_total", 0) >= 1
    lat = after["summaries"]["request_latency_s"]
    assert lat["count"] >= 1 and lat["p50"] is not None and lat["p50"] > 0
    assert "queue_depth" in after["gauges"] and after["uptime_s"] > 0


def test_obs_logger_and_metrics_unit():
    from openai_whisper_coreml_tpu_torch.utils.obs import Metrics, get_logger, kv

    assert get_logger("test").name == "whisper_tpu.test"
    assert kv(a=1, b="x") == "a=1 b=x"
    m = Metrics()
    m.inc("c")
    m.inc("c", 2)
    m.set_gauge("g", 7)
    for v in (1.0, 2.0, 3.0, 10.0):
        m.observe("lat", v)
    snap = m.snapshot()
    assert snap["counters"]["c"] == 3 and snap["gauges"]["g"] == 7
    assert snap["summaries"]["lat"]["count"] == 4
    assert 1.0 <= snap["summaries"]["lat"]["p50"] <= 3.0
    assert snap["summaries"]["lat"]["p95"] == 10.0


def test_obs_prometheus_matches_jax():
    """The same observations give the JAX package's exposition, line for
    line (one scraper reads both servers)."""
    from openai_whisper_coreml_tpu.utils.obs import Metrics as JaxMetrics
    from openai_whisper_coreml_tpu_torch.utils.obs import Metrics

    out = []
    for m in (Metrics(), JaxMetrics()):
        m.inc("requests_total", 3)
        m.inc("batches")
        m.set_gauge("queue_depth", 2)
        for v in (0.5, 1.5, 2.5):
            m.observe("batch_latency_s", v)
        out.append([line for line in m.prometheus().splitlines()
                    if not line.startswith("whisper_tpu_uptime_seconds")])
    assert out[0] == out[1] and "whisper_tpu_requests_total 3.0" in out[0]


def test_openai_transcriptions_json(oa_server, rng):
    body, headers = _multipart({"model": "whisper-1", "language": "en", "temperature": "0"},
                               _wav_bytes((0.2 * rng.standard_normal(32000)).astype(np.float32)))
    status, ctype, raw = _post_raw(oa_server, "/v1/audio/transcriptions", body, headers)
    assert status == 200 and ctype.startswith("application/json")
    out = json.loads(raw)
    assert set(out) == {"text"} and isinstance(out["text"], str)


def test_openai_transcriptions_verbose_json(oa_server, rng):
    body, headers = _multipart({"language": "en", "response_format": "verbose_json"},
                               _wav_bytes((0.2 * rng.standard_normal(32000)).astype(np.float32)))
    status, _, raw = _post_raw(oa_server, "/v1/audio/transcriptions", body, headers)
    out = json.loads(raw)
    assert status == 200 and out["task"] == "transcribe" and out["language"] == "en"
    assert abs(out["duration"] - 2.0) < 0.01 and isinstance(out["segments"], list)
    assert "words" not in out


@pytest.mark.parametrize("fmt", ["srt", "text", "vtt"])
def test_openai_transcriptions_srt_and_text(oa_server, rng, fmt):
    body, headers = _multipart({"language": "en", "response_format": fmt},
                               _wav_bytes((0.2 * rng.standard_normal(32000)).astype(np.float32)))
    status, ctype, raw = _post_raw(oa_server, "/v1/audio/transcriptions", body, headers)
    assert status == 200 and ctype.startswith("text/plain")
    if fmt == "srt":
        assert b"-->" in raw or raw.strip() == b""
    if fmt == "vtt":
        assert raw.startswith(b"WEBVTT")


def test_openai_translations_and_prompt(oa_server, rng):
    body, headers = _multipart(
        {"language": "en", "prompt": "glossary: kappa", "response_format": "verbose_json"},
        _wav_bytes((0.2 * rng.standard_normal(32000)).astype(np.float32)))
    status, _, raw = _post_raw(oa_server, "/v1/audio/translations", body, headers)
    assert status == 200 and json.loads(raw)["task"] == "translate"


def test_openai_bad_requests(oa_server, rng):
    wav = _wav_bytes((0.1 * rng.standard_normal(16000)).astype(np.float32))
    cases = [({"language": "en"}, None, "file"),
             ({"response_format": "yaml"}, wav, "response_format"),
             ({"timestamp_granularities[]": "word"}, wav, "verbose_json"),
             ({"temperature": "abc"}, wav, "temperature")]
    for fields, data, what in cases:
        body, headers = _multipart(fields, data)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_raw(oa_server, "/v1/audio/transcriptions", body, headers)
        assert e.value.code == 400
        assert what in json.loads(e.value.read())["error"]["message"]


def test_openai_flac_upload_without_native_decoder_is_400(oa_server, monkeypatch):
    """A FLAC upload goes to the native decoder; without it the request is
    a 400 with the decoder's message, not a dropped connection."""
    from openai_whisper_coreml_tpu_torch.utils import audio_io

    monkeypatch.setattr(audio_io, "_find_native_lib", lambda: None)
    body, headers = _multipart({"language": "en"}, b"fLaC" + b"\0" * 64,
                               filename="a.flac")
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_raw(oa_server, "/v1/audio/transcriptions", body, headers)
    assert e.value.code == 400 and "native" in json.loads(e.value.read())["error"]["message"]


def test_openai_prompt_overrides_continuous_scheduler(model, rng):
    srv = WhisperHTTPServer(model, port=0, batch_size=2, batch_window_ms=20,
                            default_options={"scheduler": "continuous", **NO_GATES,
                                             "sample_len": 6})
    srv.start()
    try:
        body, headers = _multipart({"language": "en", "prompt": "hello"}, _wav_bytes(
            (0.2 * rng.standard_normal(16000)).astype(np.float32)))
        status, _, raw = _post_raw(srv, "/v1/audio/transcriptions", body, headers)
        assert status == 200 and "text" in json.loads(raw)
    finally:
        srv.stop()


def test_metrics_prometheus_format(server, rng):
    _post(server, "/transcribe?language=en&sample_len=4&no_speech_threshold=none"
          "&logprob_threshold=none&compression_ratio_threshold=none",
          _wav_bytes((0.1 * rng.standard_normal(16000)).astype(np.float32)))
    with urllib.request.urlopen(_url(server, "/metrics?format=prometheus"),
                                timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    assert "whisper_tpu_requests_total" in text and "whisper_tpu_uptime_seconds" in text
    assert 'quantile="0.5"' in text
    assert "counters" in _get(server, "/metrics")[1]


def test_body_size_limit_413(model):
    srv = WhisperHTTPServer(model, port=0, batch_size=2, max_body_bytes=1024)
    srv.start()
    try:
        req = urllib.request.Request(_url(srv, "/transcribe"), data=b"\0" * 4096,
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 413
    finally:
        srv.stop()


def test_cors_preflight_and_headers(server, model):
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=30) as r:
        assert r.headers["Access-Control-Allow-Origin"] is None
    srv = WhisperHTTPServer(model, port=0, allow_origin="*")
    srv.start()
    try:
        req = urllib.request.Request(_url(srv, "/v1/audio/transcriptions"),
                                     method="OPTIONS")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 204 and r.headers["Access-Control-Allow-Origin"] == "*"
            assert "POST" in r.headers["Access-Control-Allow-Methods"]
        with urllib.request.urlopen(_url(srv, "/healthz"), timeout=30) as r:
            assert r.headers["Access-Control-Allow-Origin"] == "*"
    finally:
        srv.stop()


def test_concurrent_requests_all_served(oa_server, rng):
    """8 simultaneous clients across endpoints (/stream and /detect decode
    in handler threads beside the batch worker): every one gets a 200."""
    wav = _wav_bytes((0.2 * rng.standard_normal(16000)).astype(np.float32))
    results = [None] * 8

    def hit(i):
        try:
            if i % 4 == 1:
                body, headers = _multipart({"language": "en"}, wav)
                status = _post_raw(oa_server, "/v1/audio/transcriptions", body, headers)[0]
            elif i % 4 == 2:
                status = _post(oa_server, "/detect", wav)[0]
            elif i % 4 == 3:
                status = _post_raw(oa_server, "/stream?language=en", wav, {})[0]
            else:
                status = _post(oa_server, "/transcribe?language=en", wav)[0]
            results[i] = status
        except Exception as e:  # the failure's detail, for the assertion
            results[i] = repr(e)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert results == [200] * 8, results


def test_stop_unblocks_queued_jobs(model, rng):
    srv = WhisperHTTPServer(model, port=0, batch_size=2)
    # the HTTP loop runs (so shutdown() returns), the batch worker does not
    threading.Thread(target=srv.httpd.serve_forever, daemon=True).start()
    out = {}

    def submit():
        out["job"] = srv.submit((0.1 * rng.standard_normal(16000)).astype(np.float32),
                                {}, timeout=60.0)

    t = threading.Thread(target=submit)
    t.start()
    time.sleep(0.2)
    t0 = time.monotonic()
    srv.stop()
    t.join(timeout=10)
    assert not t.is_alive() and time.monotonic() - t0 < 5
    assert out["job"].error == "server shutting down"


def test_openai_models_endpoint(server):
    ids = [m["id"] for m in _get(server, "/v1/models")[1]["data"]]
    assert "whisper-1" in ids and server.model.cfg.name in ids


def test_stream_rejects_bad_task(server, rng):
    req = urllib.request.Request(_url(server, "/stream?task=transcibe"), method="POST",
                                 data=_wav_bytes((0.1 * rng.standard_normal(16000))
                                                 .astype(np.float32)))
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_models_retrieve_by_id(server):
    body = _get(server, "/v1/models/whisper-1")[1]
    assert body["id"] == "whisper-1" and body["object"] == "model"
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server, "/v1/models/gpt-4")
    assert e.value.code == 404


def test_submit_after_stop_fails_fast(model, rng):
    srv = WhisperHTTPServer(model, port=0)
    srv.start()
    srv.stop()
    t0 = time.monotonic()
    job = srv.submit((0.1 * rng.standard_normal(16000)).astype(np.float32), {},
                     timeout=60.0)
    assert job.error == "server shutting down" and time.monotonic() - t0 < 2


def test_readyz_immediate_without_warmup(server):
    status, body = _get(server, "/readyz")
    assert status == 200 and body["ready"] is True
    assert _get(server, "/healthz")[1]["warmed"] is True


def test_warmup_gates_readyz_then_serves(model, monkeypatch, rng):
    from openai_whisper_coreml_tpu_torch import serve as serve_mod

    gate = threading.Event()
    warm_batches = []
    real = serve_mod.transcribe_batch

    def gated(model_, audios, options):
        warm_batches.append(len(audios))
        assert gate.wait(timeout=120), "test gate never opened"
        return real(model_, audios, options)

    monkeypatch.setattr(serve_mod, "transcribe_batch", gated)
    srv = WhisperHTTPServer(model, port=0, batch_size=2, batch_window_ms=20, warmup=True,
                            default_options={"language": "en", "sample_len": 4, **NO_GATES})
    srv.start()
    try:
        deadline = time.monotonic() + 30
        while not warm_batches and time.monotonic() < deadline:
            time.sleep(0.01)
        assert warm_batches == [2]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv, "/readyz")
        assert e.value.code == 503
        assert _get(srv, "/healthz")[1]["warmed"] is False
        gate.set()
        deadline = time.monotonic() + 120
        ready = False
        while time.monotonic() < deadline and not ready:
            try:
                ready = _get(srv, "/readyz")[1]["ready"]
            except urllib.error.HTTPError:
                time.sleep(0.05)
        assert ready is True
        status, body = _post(srv, "/transcribe", _wav_bytes(
            (0.2 * rng.standard_normal(16000)).astype(np.float32)))
        assert status == 200 and "segments" in body
    finally:
        srv.stop()
