"""The port's evaluation harness (`eval/harness.py`) and batch audio loader
against the JAX package's: `discover` on both layouts, `evaluate` on a flat
corpus with the same fp32 weights (hypotheses, WER and CER equal to JAX's
report), `load_audio_batch` against per-file `load_audio` (serially, and
through the native threaded loader where a C++ compiler builds it), and
`main --device cpu --json`."""

import functools
import json
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.eval import harness as jharness
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.eval import harness as tharness
from openai_whisper_coreml_tpu_torch.params import from_jax_params
from openai_whisper_coreml_tpu_torch.utils import audio_io

# tiny tensors: one torch thread per test worker keeps parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(no_speech_threshold=None, logprob_threshold=None,
             compression_ratio_threshold=None, temperature=(0.0,), sample_len=8)
KEYS = {"n_utterances", "audio_seconds", "wall_seconds", "rtfx", "substitutions",
        "deletions", "insertions", "hits", "examples"}


@pytest.fixture(scope="module")
def models():
    kw = dict(n_state=64, n_head=2, n_layer=2)
    params = jax_init(jax_tiny(**kw), jax.random.PRNGKey(0))
    return (JaxModel(cfg=jax_tiny(**kw), params=params),
            from_jax_params(jax.tree.map(np.asarray, params), tiny_test_config(**kw)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three tone-in-noise WAVs of 2-4 s, flat layout."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for i in range(3):
        t = np.arange(int((2 + i) * 16000)) / 16000
        x = (0.2 * np.sin(2 * np.pi * (150 + 40 * i) * t)
             + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
        audio_io.save_wav(str(root / f"utt{i}.wav"), x, 16000)
        (root / f"utt{i}.txt").write_text(f"reference text {i}")
    return str(root)


def test_discover_flat_equals_jax(corpus):
    ours = tharness.discover(corpus)
    assert [vars(u) for u in ours] == [vars(u) for u in jharness.discover(corpus)]
    assert len(ours) == 3 and ours[0].reference == "reference text 0"


def test_discover_librispeech_equals_jax(tmp_path):
    d = tmp_path / "19" / "198"
    d.mkdir(parents=True)
    for i in range(2):
        audio_io.save_wav(str(d / f"19-198-000{i}.wav"),
                          np.zeros(16000, np.float32), 16000)
    (d / "19-198.trans.txt").write_text(
        "19-198-0000 HELLO WORLD\n19-198-0001 SECOND LINE\n\n")
    ours = tharness.discover(str(tmp_path))
    assert [vars(u) for u in ours] == [vars(u) for u in jharness.discover(str(tmp_path))]
    assert [u.reference for u in ours] == ["HELLO WORLD", "SECOND LINE"]


@pytest.mark.parametrize("language", ["en", "zh"])
def test_evaluate_equals_jax(models, corpus, language):
    """Same weights, fp32, same corpus: the hypotheses, the word (or, for a
    space-less language, character) error counts and the report's keys are
    JAX's; only the walls differ."""
    jm, tm = models
    ours = tharness.evaluate(tm, corpus, batch_size=2, language=language, **QUIET)
    ref = jharness.evaluate(jm, corpus, batch_size=2, language=language, **QUIET)
    assert set(ours) == set(ref)
    score = {"cer", "ref_chars"} if language == "zh" else {"wer", "ref_words"}
    assert set(ours) == KEYS | score
    for k in ("wall_seconds", "rtfx"):
        assert ours.pop(k) > 0
        ref.pop(k)
    assert ours == ref
    assert ours["n_utterances"] == 3 and ours["audio_seconds"] == 9.0


def test_evaluate_limit_and_empty(models, corpus, tmp_path):
    _, tm = models
    report = tharness.evaluate(tm, corpus, limit=1, batch_size=2, **QUIET)
    assert report["n_utterances"] == 1 and len(report["examples"]) == 1
    with pytest.raises(FileNotFoundError):
        tharness.evaluate(tm, str(tmp_path), **QUIET)


def _wavs(tmp_path, rates=(16000, 8000, 44100)):
    rng = np.random.default_rng(2)
    paths = []
    for i, rate in enumerate(rates):
        p = str(tmp_path / f"a{i}.wav")
        audio_io.save_wav(p, (0.2 * rng.standard_normal(rate)).astype(np.float32), rate)
        paths.append(p)
    return paths


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(audio_io, "_native_checked", True)
    monkeypatch.setattr(audio_io, "_native_lib", None)


def test_load_audio_batch_serial_equals_load_audio(tmp_path, no_native):
    paths = _wavs(tmp_path)
    assert not audio_io.native_batch_loader()
    got = audio_io.load_audio_batch(paths)
    assert len(got) == 3 and audio_io.load_audio_batch([]) == []
    for p, a in zip(paths, got):
        np.testing.assert_array_equal(a, audio_io.load_audio(p))


@pytest.fixture
def native(tmp_path_factory, monkeypatch):
    """The native library built from native/audio_io.cpp (needs a C++
    compiler), loaded fresh through $WHISPER_TPU_AUDIO_LIB."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build native/audio_io.cpp")
    so = str(tmp_path_factory.mktemp("native") / "libwhisper_audio.so")
    subprocess.run([cxx, "-O2", "-fPIC", "-std=c++17", "-shared", "-pthread",
                    "-o", so, os.path.join(REPO, "native", "audio_io.cpp")],
                   check=True, capture_output=True, timeout=300)
    monkeypatch.setenv("WHISPER_TPU_AUDIO_LIB", so)
    monkeypatch.setattr(audio_io, "_native_checked", False)
    monkeypatch.setattr(audio_io, "_native_lib", None)
    yield audio_io._find_native_lib()
    monkeypatch.setattr(audio_io, "_native_checked", False)
    monkeypatch.setattr(audio_io, "_native_lib", None)


def test_load_audio_batch_native_equals_load_audio(tmp_path, native):
    """Through the threaded loader: each file equals its own native
    load_audio, a G.711 WAV included (retried per file through the Python
    decoder where the batch cannot decode it)."""
    assert native is not None and audio_io.native_batch_loader()
    paths = _wavs(tmp_path)
    mulaw = str(tmp_path / "mulaw.wav")
    data = np.arange(256, dtype=np.uint8).tobytes() * 8
    fmt = (7).to_bytes(2, "little") + (1).to_bytes(2, "little") + \
        (8000).to_bytes(4, "little") + (8000).to_bytes(4, "little") + \
        (1).to_bytes(2, "little") + (8).to_bytes(2, "little")
    body = b"WAVE" + b"fmt " + len(fmt).to_bytes(4, "little") + fmt + \
        b"data" + len(data).to_bytes(4, "little") + data
    with open(mulaw, "wb") as f:
        f.write(b"RIFF" + len(body).to_bytes(4, "little") + body)
    paths.append(mulaw)
    got = audio_io.load_audio_batch(paths, n_threads=2)
    assert len(got) == len(paths)
    for p, a in zip(paths, got):
        np.testing.assert_array_equal(a, audio_io.load_audio(p))


def test_main_prints_one_json_line(models, corpus, monkeypatch, capsys):
    _, tm = models
    loads = []

    def fake_load(name, **kw):
        loads.append((name, kw))
        return tm

    monkeypatch.setattr("openai_whisper_coreml_tpu_torch.load_model", fake_load)
    # main's own options, but short windows without the fallback ladder
    monkeypatch.setattr(tharness, "evaluate",
                        functools.partial(tharness.evaluate, **QUIET))
    assert tharness.main([corpus, "--device", "cpu", "--json", "--limit", "2",
                          "--batch-size", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    report = json.loads(lines[0])
    assert set(report) == KEYS | {"wer", "ref_words"} and report["n_utterances"] == 2
    assert loads == [("tiny", {"checkpoint": None, "device": "cpu"})]


def test_main_flags_are_jax_plus_device():
    """main takes JAX's flags with JAX's defaults, and --device."""
    import argparse

    seen = []

    class Stop(Exception):
        pass

    def capture(self, args=None, namespace=None):
        seen.append(vars(original(self, args, namespace)))
        raise Stop

    original = argparse.ArgumentParser.parse_args
    try:
        argparse.ArgumentParser.parse_args = capture
        for mod in (tharness, jharness):
            with pytest.raises(Stop):
                mod.main(["corpus"])
    finally:
        argparse.ArgumentParser.parse_args = original
    ours, ref = seen
    assert ours.pop("device") is None
    assert ours == ref
