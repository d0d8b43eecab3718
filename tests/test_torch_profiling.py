"""The port's spans and device traces (`utils/profiling.py`): device_trace
as a no-op without a directory, and on the CPU a torch.profiler trace file
that names the ops and the spans run inside it; with spans off no
`record_function` at all on the language-ID and batch paths; the spans
each path opens, nested as the port's layers are; outputs bitwise equal
with spans on and off; and the server's `queue_wait_s`."""

import glob
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu_torch import ServeOptions, build_model, transcribe_batch
from openai_whisper_coreml_tpu_torch.audio import log_mel_spectrogram
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.decoding import detect_language
from openai_whisper_coreml_tpu_torch.serve_http import WhisperHTTPServer
from openai_whisper_coreml_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

NO_GATES = dict(no_speech_threshold=None, logprob_threshold=None,
                compression_ratio_threshold=None)
BATCH = ServeOptions(batch_size=2, language="en", temperature=(0.0,), sample_len=4,
                     **NO_GATES)
# an impossible log-prob gate sends every window down to the second rung
FALLBACK = ServeOptions(batch_size=2, language="en", temperature=(0.0, 0.5),
                        sample_len=4, scheduler="static",
                        **dict(NO_GATES, logprob_threshold=1e9))


@pytest.fixture(scope="module")
def model():
    """d_model 128: the MLP's weights pass the int8 rule's floor, so the
    int8 weight's cast runs."""
    return build_model(tiny_test_config(n_state=128, n_head=2, n_layer=2),
                       quantize="int8", device="cpu", seed=0)


def _speechy(seconds, seed):
    t = np.arange(int(seconds * 16_000)) / 16_000
    rng = np.random.default_rng(seed)
    return (0.2 * np.sin(2 * np.pi * 200 * t) * (1 + 0.5 * np.sin(2 * np.pi * 2 * t))
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def audio():
    return _speechy(30, 1)


def _spans(logdir):
    """The trace's spans: (name, start, end) in µs, by start."""
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e.get("ph") == "X"),
                  key=lambda s: s[1])


def _inside(spans, outer, inner):
    """Whether some `inner` span lies within some `outer` span."""
    return any(o[1] <= i[1] and i[2] <= o[2]
               for o in spans if o[0] == outer for i in spans if i[0] == inner)


def test_device_trace_without_dir_does_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for logdir in ("", None):
        with tprof.device_trace(logdir):
            torch.ones(4).sum()
            assert not tprof.SPANS
    assert os.listdir(tmp_path) == []
    assert not torch.autograd.profiler._is_profiler_enabled


def test_device_trace_writes_a_trace_on_cpu(tmp_path):
    """A Chrome-trace JSON file lands in the directory, holding the ops run
    inside the context and the annotated region."""
    logdir = str(tmp_path / "trace")
    with tprof.device_trace(logdir):
        with tprof.annotate("my_region"):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert not tprof.SPANS
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "my_region" in names and "aten::mm" in names


def test_spans_off_make_no_record_function(model, audio, monkeypatch):
    """With spans off, language ID and a batch transcription enter no
    record_function anywhere (counted on both of torch's names for it);
    inside spans_on the same calls enter them, so the count sees the
    port's spans."""
    calls = []
    real = torch.profiler.record_function

    def counting(*args, **kwargs):
        calls.append(args[0] if args else kwargs.get("name"))
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)

    def run():
        detect_language(model, log_mel_spectrogram(audio, n_mels=80))
        transcribe_batch(model, [audio[:16_000 * 5]], BATCH)

    run()
    assert calls == []
    with tprof.spans_on():
        run()
    assert not tprof.SPANS
    assert {"mel", "encoder", "lang_step", "decode_step", "reassemble"} <= set(calls)


def test_spans_on_nest_and_count_across_contexts():
    """spans_on contexts nest: spans stay on until the last one closes, and
    a failing body still turns them off."""
    assert tprof.annotate("x") is tprof.annotate("y")  # the shared no-op
    with tprof.spans_on():
        with tprof.spans_on():
            assert tprof.SPANS
        assert tprof.SPANS
    assert not tprof.SPANS
    with pytest.raises(RuntimeError):
        with tprof.spans_on():
            raise RuntimeError("the body failed")
    assert not tprof.SPANS


def test_language_id_trace_holds_its_spans(model, audio, tmp_path):
    """The language-ID path's trace: `mel`, `encoder` holding the norm and
    the linears' spans, `lang_step` holding `cross_kv` and `decode_step`,
    and `lang_results`."""
    logdir = str(tmp_path / "trace")
    with tprof.device_trace(logdir):
        mel = log_mel_spectrogram(np.stack([audio, audio[::-1].copy()]), n_mels=80)
        detect_language(model, mel)
    spans = _spans(logdir)
    names = {s[0] for s in spans}
    assert {"mel", "encoder", "layer_norm", "linear.epilogue", "linear.weight_cast",
            "lang_step", "cross_kv", "decode_step", "lang_results"} <= names
    for inner in ("layer_norm", "linear.epilogue", "linear.weight_cast"):
        assert _inside(spans, "encoder", inner), inner
    for inner in ("cross_kv", "decode_step"):
        assert _inside(spans, "lang_step", inner), inner
    assert _inside(spans, "cross_kv", "linear.epilogue")
    assert not _inside(spans, "lang_step", "lang_results")


@pytest.mark.parametrize("options,want", [
    (BATCH, {"mel", "encoder", "cross_kv", "decode_step", "reassemble"}),
    (FALLBACK, {"decode_step", "fallback_round", "reassemble"}),
], ids=["greedy", "fallback"])
def test_batch_trace_holds_its_spans(model, audio, tmp_path, options, want):
    """A transcribe_batch trace holds the decode steps and the reassembly;
    a forced fallback holds a repair round, with decode steps in it."""
    logdir = str(tmp_path / "trace")
    with tprof.device_trace(logdir):
        transcribe_batch(model, [audio[:16_000 * 5]], options)
    spans = _spans(logdir)
    assert want <= {s[0] for s in spans}
    if "fallback_round" in want:
        assert _inside(spans, "fallback_round", "decode_step")
    else:
        assert "fallback_round" not in {s[0] for s in spans}


def test_outputs_bitwise_equal_with_spans_on_and_off(model, audio, tmp_path):
    """The features, the language probabilities and the transcripts are the
    same, bit for bit, in a trace with spans on and without."""
    mel = log_mel_spectrogram(audio, n_mels=80)[None]
    clip = [audio[:16_000 * 5]]

    def run():
        feats = model.encode(mel)
        return feats, detect_language(model, mel), transcribe_batch(model, clip, FALLBACK)

    off = run()
    with tprof.device_trace(str(tmp_path / "trace")):
        on = run()
    assert torch.equal(off[0], on[0])
    assert off[1] == on[1]
    assert off[2] == on[2]


def test_server_reports_queue_wait(tmp_path):
    """After one request the server's /metrics holds `queue_wait_s`, in the
    JSON and in the Prometheus text, no longer than the request took."""
    model = build_model(tiny_test_config(n_state=64, n_head=2, n_layer=2),
                        device="cpu", seed=0)
    srv = WhisperHTTPServer(model, port=0, batch_size=1, batch_window_ms=1,
                            default_options={**NO_GATES, "sample_len": 4})
    srv.start()
    try:
        audio = (0.1 * np.random.default_rng(0).standard_normal(16_000)).astype(np.float32)
        job = srv.submit(audio, {"language": "en"})
        assert job.error is None
        url = f"http://127.0.0.1:{srv.port}/metrics"
        with urllib.request.urlopen(url, timeout=30) as r:
            snap = json.loads(r.read())
        with urllib.request.urlopen(url + "?format=prometheus", timeout=30) as r:
            text = r.read().decode()
    finally:
        srv.stop()
    wait = snap["summaries"]["queue_wait_s"]
    latency = snap["summaries"]["request_latency_s"]
    assert wait["count"] == 1 and 0.0 <= wait["p50"] <= latency["p50"]
    assert "whisper_tpu_queue_wait_s_count 1" in text

