"""Port CLI, writers and audio loading against the JAX package's."""

import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import cli as jcli
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu.utils import audio_io as jaudio_io
from openai_whisper_coreml_tpu.utils import writers as jwriters
from openai_whisper_coreml_tpu_torch import cli as tcli
from openai_whisper_coreml_tpu_torch.audio import load_audio
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.params import from_jax_params
from openai_whisper_coreml_tpu_torch.utils import audio_io as taudio_io
from openai_whisper_coreml_tpu_torch.utils import writers as twriters

# tiny tensors: one torch thread per test worker keeps parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

FORMATS = ("txt", "srt", "vtt", "tsv", "json")


def _segment(i, start, end, text, **extra):
    return {"id": i, "seek": 0, "start": start, "end": end, "text": text,
            "tokens": [i + 1], "temperature": 0.0, "avg_logprob": -0.1,
            "compression_ratio": 1.0, "no_speech_prob": 0.0, **extra}


RESULT = {"text": " héllo wörld ünïcode",
          "segments": [_segment(0, 0.0, 2.5, " héllo"),
                       _segment(1, 2.5, 3723.456, " wörld ünïcode")],
          "language": "en", "duration": 3723.5}

WORDS = [{"word": w, "start": s, "end": s + 0.5, "probability": 0.9}
         for w, s in ((" alpha", 0.0), (" beta", 0.5), (" gamma", 1.0),
                      (" delta", 1.5))]
WORDY = {"text": " alpha beta gamma delta", "language": "en", "duration": 2.0,
         "segments": [_segment(0, 0.0, 2.0, " alpha beta gamma delta",
                               words=WORDS)]}


@pytest.mark.parametrize("result,options", [
    (RESULT, {}),
    (WORDY, dict(max_line_width=10, max_line_count=2)),
    (WORDY, dict(highlight_words=True)),
    (WORDY, dict(max_words_per_line=3)),
], ids=["segments", "wrap", "highlight", "words-per-line"])
def test_writers_byte_identical_to_jax(result, options):
    for fmt in FORMATS:
        ours, ref = io.StringIO(), io.StringIO()
        twriters.WRITERS[fmt](result, ours, **options)
        jwriters.WRITERS[fmt](result, ref, **options)
        assert ours.getvalue() == ref.getvalue(), fmt


def test_write_result_all_formats(tmp_path):
    out = twriters.write_result(RESULT, "x/audio.wav", str(tmp_path), "all")
    assert out.endswith("audio.json")
    assert sorted(os.listdir(tmp_path)) == sorted(f"audio.{f}" for f in FORMATS)
    assert (tmp_path / "audio.txt").read_text() == "héllo\nwörld ünïcode\n"
    with pytest.raises(ValueError, match="unknown output format"):
        twriters.write_result(RESULT, "a.wav", str(tmp_path), "docx")


@pytest.fixture(scope="module")
def models():
    kw = dict(n_state=64, n_head=2, n_layer=2)
    params = jax_init(jax_tiny(**kw), jax.random.PRNGKey(0))
    return (JaxModel(cfg=jax_tiny(**kw), params=params),
            from_jax_params(jax.tree.map(np.asarray, params), tiny_test_config(**kw)))


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    rng = np.random.default_rng(11)
    t = np.arange(20 * 16000) / 16000
    audio = (0.2 * np.sin(2 * np.pi * 200 * t) * (1 + 0.5 * np.sin(2 * np.pi * 2 * t))
             + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("audio") / "clip.wav")
    taudio_io.save_wav(path, audio)
    return path


def test_cli_writes_what_the_jax_cli_writes(models, wav, tmp_path, monkeypatch):
    """Both CLIs, all formats, on one WAV with the same tiny model: the text
    formats are byte-identical; json equal up to fp32 log-prob rounding."""
    jm, tm = models
    monkeypatch.setattr("openai_whisper_coreml_tpu.load_model", lambda *a, **k: jm)
    monkeypatch.setattr("openai_whisper_coreml_tpu_torch.load_model",
                        lambda *a, **k: tm)
    args = [wav, "--language", "en", "--output-format", "all",
            "--temperature-increment-on-fallback", "0", "--beam-size", "2",
            "--logprob-threshold=-1e9", "--no-speech-threshold", "1.1"]
    assert jcli.main(args + ["--output-dir", str(tmp_path / "j")]) == 0
    assert tcli.main(args + ["--output-dir", str(tmp_path / "t")]) == 0
    for fmt in FORMATS:
        ours = (tmp_path / "t" / f"clip.{fmt}").read_text()
        ref = (tmp_path / "j" / f"clip.{fmt}").read_text()
        if fmt != "json":
            assert ours == ref, fmt
            continue
        ours, ref = json.loads(ours), json.loads(ref)
        assert ours["text"] == ref["text"] and ours["segments"]
        for o, r in zip(ours["segments"], ref["segments"]):
            assert o.keys() == r.keys()
            for k in o:
                assert o[k] == pytest.approx(r[k], abs=1e-5), k


def test_cli_lang_id_prints_a_code(models, wav, monkeypatch, capsys):
    _, tm = models
    monkeypatch.setattr("openai_whisper_coreml_tpu_torch.load_model",
                        lambda *a, **k: tm)
    assert tcli.main([wav, "--task", "lang-id"]) == 0
    path, code = capsys.readouterr().out.split()[:2]
    assert path == wav + ":" and code.isalpha() and len(code) <= 3


def test_cli_skips_unreadable_files(models, tmp_path, monkeypatch, capsys):
    _, tm = models
    monkeypatch.setattr("openai_whisper_coreml_tpu_torch.load_model",
                        lambda *a, **k: tm)
    assert tcli.main([str(tmp_path / "missing.wav"), "-o", str(tmp_path)]) == 1
    assert "skipped" in capsys.readouterr().err


@pytest.mark.parametrize("flags,what", [
    (["--draft-model", "tiny"], "speculative.py"),
    (["--profile-dir", "trace"], "profile"),
    (["--tensor-parallel", "2"], "parallel"),
])
def test_cli_draft_profile_and_tensor_parallel_flags(flags, what, models, wav,
                                                     tmp_path, monkeypatch):
    """--tensor-parallel > 1 outside torchrun raises, saying how to launch
    it (a launch under torchrun is test_torch_parallel_train's). --profile-dir writes a
    torch.profiler trace of the file's transcription (on the CPU here), with
    the spans of its path, and leaves the transcript as it is. --draft-model loads the draft through
    load_model with the target's dtype and quantisation and
    --draft-checkpoint, and the file decodes speculatively to the plain
    run's transcript."""
    if what == "parallel":
        with pytest.raises(RuntimeError, match="(?s)torchrun.*--tensor-parallel 2"):
            tcli.main(["a.wav"] + flags)
        return
    from openai_whisper_coreml_tpu_torch import speculative

    _, tm = models
    loads = []

    def fake_load(name, **kw):
        loads.append((name, kw))
        return tm

    monkeypatch.setattr("openai_whisper_coreml_tpu_torch.load_model", fake_load)
    args = [wav, "--language", "en", "--temperature-increment-on-fallback", "0",
            "--output-format", "json", "--spec-k", "3"]
    assert tcli.main(args + ["-o", str(tmp_path / "plain")]) == 0
    plain = json.loads((tmp_path / "plain" / "clip.json").read_text())
    if what == "profile":
        trace_dir = tmp_path / flags[1]
        assert tcli.main(args + ["--profile-dir", str(trace_dir),
                                 "-o", str(tmp_path / "traced")]) == 0
        (trace,) = list(trace_dir.glob("*.pt.trace.json"))
        events = json.loads(trace.read_text())["traceEvents"]
        assert any(e.get("name") == "aten::mm" for e in events)
        spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
        assert {"mel", "encoder", "layer_norm", "linear.epilogue", "cross_kv",
                "decode_step"} <= spans, spans
        traced = json.loads((tmp_path / "traced" / "clip.json").read_text())
        assert traced["segments"] == plain["segments"]
        return
    before = speculative.TOTALS["iters"]
    assert tcli.main(args + flags + ["--draft-checkpoint", "d.safetensors",
                                     "-o", str(tmp_path / "spec")]) == 0
    assert speculative.TOTALS["iters"] > before
    assert [name for name, _ in loads] == ["tiny", "tiny", "tiny"]
    assert loads[2][1]["checkpoint"] == "d.safetensors"
    spec = json.loads((tmp_path / "spec" / "clip.json").read_text())
    assert spec["text"] == plain["text"]
    assert [s["tokens"] for s in spec["segments"]] == [
        s["tokens"] for s in plain["segments"]]


@pytest.mark.parametrize("fmt", ["srt", "vtt", "json"])
def test_cli_word_timestamps_write_what_the_jax_cli_writes(models, wav, tmp_path,
                                                          monkeypatch, fmt):
    """`--word-timestamps` with the word-level subtitle options: srt and vtt
    byte-identical to JAX's CLI, json's words equal (probabilities within
    1e-5)."""
    jm, tm = models
    monkeypatch.setattr("openai_whisper_coreml_tpu.load_model", lambda *a, **k: jm)
    monkeypatch.setattr("openai_whisper_coreml_tpu_torch.load_model",
                        lambda *a, **k: tm)
    args = [wav, "--language", "en", "--output-format", fmt,
            "--temperature-increment-on-fallback", "0", "--word-timestamps",
            "--max-line-width", "42", "--highlight-words",
            "--logprob-threshold=-1e9", "--no-speech-threshold", "1.1"]
    assert jcli.main(args + ["--output-dir", str(tmp_path / "j")]) == 0
    assert tcli.main(args + ["--output-dir", str(tmp_path / "t")]) == 0
    ours = (tmp_path / "t" / f"clip.{fmt}").read_text()
    ref = (tmp_path / "j" / f"clip.{fmt}").read_text()
    if fmt != "json":
        assert ours == ref and "<u>" in ours
        return
    ours, ref = json.loads(ours), json.loads(ref)
    words = [w for s in ours["segments"] for w in s["words"]]
    assert words and len(ours["segments"]) == len(ref["segments"])
    for o, r in zip(ours["segments"], ref["segments"]):
        assert [(w["word"], w["start"], w["end"]) for w in o["words"]] == [
            (w["word"], w["start"], w["end"]) for w in r["words"]]
        for a, b in zip(o["words"], r["words"]):
            assert a["probability"] == pytest.approx(b["probability"], abs=1e-5)


def test_cli_stream_prints_what_jax_prints(models, tmp_path, monkeypatch, capsys):
    """`--stream` feeds the file in 1 s chunks through StreamingTranscriber
    and prints the confirmed text as it comes, then the final flush: the
    same output as JAX's CLI."""
    jm, tm = models
    monkeypatch.setattr("openai_whisper_coreml_tpu.load_model", lambda *a, **k: jm)
    monkeypatch.setattr("openai_whisper_coreml_tpu_torch.load_model",
                        lambda *a, **k: tm)
    t = np.arange(4 * 16000) / 16000
    path = str(tmp_path / "short.wav")
    taudio_io.save_wav(path, (0.2 * np.sin(2 * np.pi * 230 * t)).astype(np.float32))
    outs = []
    for main in (jcli.main, tcli.main):
        assert main([path, "--stream", "--language", "en"]) == 0
        out, err = capsys.readouterr()
        outs.append(out)
        assert "streamed 4.0s" in err
    assert outs[1] == outs[0] and outs[1].endswith("\n")


def test_cli_stream_ignores_the_cache_flags_as_jax_does(models, tmp_path, monkeypatch,
                                                       capsys):
    """`--stream` decodes with a bf16 cross-KV and cache whatever
    `--kv-dtype` and `--cache-dtype` say, as JAX's CLI does: with both set
    to int8 the port prints JAX's output, which is the default flags', and
    every tick decodes with bf16 caches."""
    from openai_whisper_coreml_tpu_torch import stream as tstream

    jm, tm = models
    monkeypatch.setattr("openai_whisper_coreml_tpu.load_model", lambda *a, **k: jm)
    monkeypatch.setattr("openai_whisper_coreml_tpu_torch.load_model",
                        lambda *a, **k: tm)
    caches = []

    def recording_decode(model, mel, options):
        caches.append((options.kv_dtype, options.cache_dtype))
        return decode(model, mel, options)

    decode = tstream.decode
    monkeypatch.setattr(tstream, "decode", recording_decode)
    t = np.arange(3 * 16000) / 16000
    path = str(tmp_path / "short.wav")
    taudio_io.save_wav(path, (0.2 * np.sin(2 * np.pi * 250 * t)).astype(np.float32))
    outs = []
    for main, flags in ((jcli.main, ["--kv-dtype", "int8", "--cache-dtype", "int8"]),
                        (tcli.main, ["--kv-dtype", "int8", "--cache-dtype", "int8"]),
                        (tcli.main, [])):
        assert main([path, "--stream", "--language", "en"] + flags) == 0
        outs.append(capsys.readouterr()[0])
    assert outs[1] == outs[0] == outs[2]
    assert caches and set(caches) == {("bf16", "bf16")}


def test_cli_cache_dtype_int8_raises(models, wav, tmp_path, monkeypatch):
    """`--cache-dtype int8` no longer raises: both CLIs run the int8
    self-attention cache (with int8 cross-KV) and write the same
    transcript."""
    jm, tm = models
    monkeypatch.setattr("openai_whisper_coreml_tpu.load_model", lambda *a, **k: jm)
    monkeypatch.setattr("openai_whisper_coreml_tpu_torch.load_model",
                        lambda *a, **k: tm)
    args = [wav, "--language", "en", "--cache-dtype", "int8", "--kv-dtype",
            "int8", "--output-format", "all",
            "--temperature-increment-on-fallback", "0",
            "--logprob-threshold=-1e9", "--no-speech-threshold", "1.1"]
    assert jcli.main(args + ["--output-dir", str(tmp_path / "j")]) == 0
    assert tcli.main(args + ["--output-dir", str(tmp_path / "t")]) == 0
    for fmt in ("txt", "srt", "vtt", "tsv"):
        assert ((tmp_path / "t" / f"clip.{fmt}").read_text()
                == (tmp_path / "j" / f"clip.{fmt}").read_text()), fmt
    ours = json.loads((tmp_path / "t" / "clip.json").read_text())
    ref = json.loads((tmp_path / "j" / "clip.json").read_text())
    assert ours["segments"] and ([s["tokens"] for s in ours["segments"]]
                                 == [s["tokens"] for s in ref["segments"]])


def test_build_model_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """No silent CPU fallback: without a CUDA device, build_model/load_model
    (and so the CLI) raise unless the caller passes device="cpu"."""
    import openai_whisper_coreml_tpu_torch as wt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wt.load_model("tiny")
    cfg = tiny_test_config(n_state=64, n_head=2, n_layer=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wt.build_model(cfg)
    model = wt.build_model(cfg, device="cpu")
    assert model.device.type == "cpu"
    assert model.decoder.token_embedding.dtype == torch.float32
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["a.wav", "--model", "tiny"])


def test_cli_flags_match_jax():
    """The port takes the JAX CLI's flags with their defaults, except
    `--batch`, which the JAX CLI accepts and never reads."""
    def flags(parser):
        return {a.dest: a.default for a in parser._actions if a.dest != "help"}

    ours, ref = flags(tcli.build_parser()), flags(jcli.build_parser())
    assert set(ref) - set(ours) == {"batch"}
    assert set(ours) <= set(ref)
    assert {k: ours[k] for k in ours} == {k: ref[k] for k in ours}


@pytest.mark.parametrize("flags", [["--spec-k", "3"],
                                   ["--draft-checkpoint", "d.safetensors"]])
def test_cli_takes_speculative_flags_as_jax(flags, capsys):
    """The flags a draft model reads are taken, with JAX's values, since
    speculative decoding is ported."""
    ours = vars(tcli.build_parser().parse_args(["a.wav"] + flags))
    ref = vars(jcli.build_parser().parse_args(["a.wav"] + flags))
    assert {k: ours[k] for k in ("spec_k", "draft_checkpoint", "draft_model")} == {
        k: ref[k] for k in ("spec_k", "draft_checkpoint", "draft_model")}
    assert ours["spec_k"] == (3 if "--spec-k" in flags else 4)
    assert not capsys.readouterr().err


@pytest.mark.parametrize("rate", [16000, 8000, 44100])
def test_load_audio_matches_jax(tmp_path, rate):
    audio = (0.3 * np.sin(np.arange(rate) * 0.05)).astype(np.float32)
    path = str(tmp_path / f"a{rate}.wav")
    jaudio_io.save_wav(path, audio, rate)
    ours = load_audio(path)
    np.testing.assert_array_equal(ours, jaudio_io.load_audio(path))
    assert ours.dtype == np.float32 and len(ours) == pytest.approx(16000, abs=1)
    with pytest.raises(ValueError, match="non-WAV"):
        load_audio(str(tmp_path / "a.mp3"))


def test_main_module_runs_the_cli():
    from openai_whisper_coreml_tpu_torch import __main__

    assert __main__.main is tcli.main
