"""The port's framework-free config equals the JAX package's, field by field."""

import dataclasses
import pathlib
import re

import pytest

from openai_whisper_coreml_tpu import config as jcfg
from openai_whisper_coreml_tpu_torch import available_models
from openai_whisper_coreml_tpu_torch import config as tcfg

PROPERTIES = [
    name for name, v in vars(jcfg.WhisperConfig).items()
    if isinstance(v, property)
]


def _assert_same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for name in PROPERTIES:
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("name", sorted(jcfg.CONFIGS))
def test_config_matches_jax(name):
    a, b = jcfg.get_config(name), tcfg.get_config(name)
    _assert_same(a, b)
    b.validate()


def test_config_tables_and_constants_match():
    assert sorted(tcfg.CONFIGS) == sorted(jcfg.CONFIGS) == available_models()
    for const in ("SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "CHUNK_LENGTH",
                  "N_SAMPLES", "N_FRAMES", "FRAMES_PER_SECOND",
                  "TOKENS_PER_SECOND", "PREPEND_PUNCTUATIONS",
                  "APPEND_PUNCTUATIONS"):
        assert getattr(tcfg, const) == getattr(jcfg, const), const
    _assert_same(jcfg.tiny_test_config(), tcfg.tiny_test_config())
    _assert_same(jcfg.tiny_test_config(n_state=128, n_head=2, n_audio_ctx=64),
                 tcfg.tiny_test_config(n_state=128, n_head=2, n_audio_ctx=64))
    with pytest.raises(ValueError, match="unknown model"):
        tcfg.get_config("huge")


def test_port_imports_no_jax():
    """The port must run where JAX is not installed."""
    pkg = pathlib.Path(tcfg.__file__).parent
    pattern = re.compile(r"^\s*(import jax|from jax|import openai_whisper_coreml_tpu\b"
                         r"|from openai_whisper_coreml_tpu\b)", re.M)
    files = list(pkg.rglob("*.py")) + [pkg.parent / "chip_smoke.py"]
    for f in files:
        assert not pattern.search(f.read_text()), f
    for f in files:
        text = f.read_text()
        assert "torch.compile" not in text, f
        if f.name == "chip_smoke.py":
            # the smoke times PyTorch's SDPA as the library reference of the
            # kernel table (`library_ms`); every call of it is inside a timing
            calls = re.findall(r"(.{0,16})F\.scaled_dot_product_attention\(", text)
            assert calls and all(c.endswith("cuda_ms(lambda: ") for c in calls), f
        elif f.relative_to(pkg).as_posix() == "models/audio_lm.py":
            # the audio LM's GQA attention (28 query heads over 4 K/V heads of
            # 128), which no kernel of the port computes: K1 is fixed at head
            # dim 64 with equal q and kv heads. Its prefill and its step call
            # SDPA, each under the span `attention`, until a kernel takes it
            calls = [m.start() for m in re.finditer(r"F\.scaled_dot_product_attention\(", text)]
            assert len(calls) == 2, f
            for at in calls:
                assert text[:at].rsplit("with annotate(", 1)[1].startswith('"attention")'), f
        else:
            assert "scaled_dot_product_attention" not in text, f
