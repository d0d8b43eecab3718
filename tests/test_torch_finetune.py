"""The port's fine-tune entry point (`python -m
openai_whisper_coreml_tpu_torch.finetune`) on a tiny corpus, on the CPU:
it trains, evaluates and saves; a resume from its saved state is bit-exact
against the uninterrupted run; the held-out padding carries no weight."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu_torch import config as tconfig
from openai_whisper_coreml_tpu_torch import finetune
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.models.whisper import load_model
from openai_whisper_coreml_tpu_torch.params import to_jax_params
from openai_whisper_coreml_tpu_torch.tokenizer import get_tokenizer
from openai_whisper_coreml_tpu_torch.utils import audio_io
from openai_whisper_coreml_tpu_torch.utils.checkpoint import read_safetensors

torch.set_num_threads(1)

MODEL = "finetune-test"
CFG = tiny_test_config(n_state=128, n_head=2, n_layer=2)  # D=64, T=1500


@pytest.fixture(autouse=True)
def _register_config(monkeypatch):
    monkeypatch.setitem(tconfig.CONFIGS, MODEL, CFG)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("ft_corpus")
    rng = np.random.default_rng(0)
    for i in range(4):
        t = np.arange(16000) / 16000
        x = (0.2 * np.sin(2 * np.pi * (160 + 30 * i) * t)
             + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
        audio_io.save_wav(str(root / f"u{i}.wav"), x, 16000)
        (root / f"u{i}.txt").write_text(f"utterance number {i}")
    return str(root)


def _run(corpus, out, *extra):
    return finetune.main([corpus, "--model", MODEL, "--device", "cpu",
                          "--batch-size", "2", "--max-len", "12",
                          "--log-every", "1", "--output", out, *extra])


def test_finetune_trains_evaluates_and_saves(corpus, tmp_path, capsys):
    out, state = str(tmp_path / "ft"), str(tmp_path / "state")
    assert _run(corpus, out, "--steps", "2", "--schedule", "cosine",
                "--warmup-steps", "1", "--holdout", "0.25", "--eval-every",
                "2", "--save-every", "2", "--save-state", state, "--flash") == 0
    text = capsys.readouterr().out
    assert "3 train / 1 held-out" in text and "device: cpu" in text
    assert "step 1: loss=" in text and "eval step 2:" in text
    assert os.path.exists(out + "-2.safetensors") and os.path.isdir(state)
    model = load_model(MODEL, checkpoint=out + "-final.safetensors", device="cpu")
    start = to_jax_params(load_model(MODEL, device="cpu"))
    # the warmup's first update runs at lr 0; the second moves the weights
    assert not np.array_equal(to_jax_params(model)["decoder"]["ln"]["bias"],
                              start["decoder"]["ln"]["bias"])
    assert _run(corpus, out, "--steps", "3", "--resume", state, "--flash") == 0
    text = capsys.readouterr().out
    assert "resumed" in text and "at step 2" in text and "step 3: loss=" in text


@pytest.mark.parametrize("extra", [
    # a decaying schedule's horizon is --steps, which the split run changes;
    # the warmup's position rides in the optimizer state
    ("--accum-steps", "2", "--warmup-steps", "1", "--learning-rate", "1e-3"),
    ("--lora-rank", "4", "--trainable", "lora_|ln"),
])
def test_resume_is_bit_exact(corpus, tmp_path, extra):
    """4 steps in one run against 2 steps, a saved state, and 2 more after
    --resume: the final checkpoints are the same bytes."""
    whole, split, state = (str(tmp_path / n) for n in ("whole", "split", "state"))
    assert _run(corpus, whole, "--steps", "4", *extra) == 0
    assert _run(corpus, split, "--steps", "2", "--save-state", state, *extra) == 0
    assert _run(corpus, split, "--steps", "4", "--resume", state, *extra) == 0
    a, meta_a = read_safetensors(whole + "-final.safetensors")
    b, meta_b = read_safetensors(split + "-final.safetensors")
    assert meta_a == meta_b and set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if "--lora-rank" in extra:
        assert not any("lora_" in k for k in a)  # merged at the end


def test_eval_batches_pad_rows_carry_zero_weight(tmp_path):
    tok = get_tokenizer(CFG)
    utts = []
    for i in range(3):
        p = str(tmp_path / f"e{i}.wav")
        audio_io.save_wav(p, np.zeros(16000, np.float32), 16000)
        utts.append(SimpleNamespace(utt_id=f"e{i}", audio_path=p,
                                    reference=f"ref number {i}"))
    batches = finetune.eval_batches(utts, 2, CFG, tok, max_len=12)
    assert len(batches) == 2
    mel, _, mask_last = batches[-1]
    assert tuple(mel.shape) == (2, CFG.n_mels, 3000)
    assert mask_last[0].sum() > 0 and mask_last[1].sum() == 0

    fake = iter([{"loss": 1.0, "accuracy": 1.0, "tokens": 3.0},
                 {"loss": 2.0, "accuracy": 0.0, "tokens": 1.0}])
    loss, acc = finetune.run_eval(lambda *a: next(fake), None,
                                  [(None, None, None)] * 2)
    assert loss == pytest.approx((1.0 * 3 + 2.0 * 1) / 4)
    assert acc == pytest.approx(3 / 4)


def test_data_iterator_skip_replays_the_draws(corpus):
    from openai_whisper_coreml_tpu_torch.eval.harness import discover

    utts = discover(corpus)
    tok = get_tokenizer(CFG)
    it = finetune.data_iterator(utts, 2, CFG, tok, seed=3, max_len=12)
    next(it)
    want = next(it)
    got = next(finetune.data_iterator(utts, 2, CFG, tok, seed=3, max_len=12,
                                      skip=1))
    assert torch.equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_flags_the_port_does_not_take(corpus, tmp_path, monkeypatch):
    # outside torchrun (a launch under it is test_torch_parallel_train's)
    with pytest.raises(RuntimeError, match="torchrun"):
        _run(corpus, str(tmp_path / "x"), "--mesh-model", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        finetune.main([corpus, "--model", MODEL])
