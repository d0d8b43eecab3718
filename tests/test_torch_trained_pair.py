"""The trained-pair tools (`tools/torch_int8_agreement_trained.py`,
`tools/torch_spec_acceptance_trained.py`) on the CPU: their corpus equals
the JAX scripts' in `benchmarks/`, two training steps of each on a tiny
config print well-formed JSON lines, and the draft's encoder is a frozen
copy of the target's."""

import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu_torch.config import tiny_test_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _import(directory, name):
    path = os.path.join(REPO, directory)
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


@pytest.fixture(scope="module")
def tools():
    return (_import("tools", "torch_int8_agreement_trained"),
            _import("tools", "torch_spec_acceptance_trained"))


@pytest.fixture(scope="module")
def jax_scripts():
    return (_import("benchmarks", "int8_agreement_trained"),
            _import("benchmarks", "spec_acceptance_trained"))


def test_corpus_equals_jax_scripts(tools, jax_scripts):
    int8_tool, spec_tool = tools
    j_int8, j_spec = jax_scripts
    assert int8_tool.PHRASES == j_int8.PHRASES == j_spec.PHRASES_SHORT
    assert spec_tool.PHRASES_LONG == j_spec.PHRASES_LONG
    for cls in range(len(j_int8.PHRASES)):
        for seed in (0, 49, 777, 555 + cls):
            np.testing.assert_array_equal(int8_tool.tone_audio(cls, seed),
                                          j_int8.tone_audio(cls, seed))
    np.testing.assert_array_equal(int8_tool.tone_audio(3, 5, seconds=2.5),
                                  j_int8.tone_audio(3, 5, seconds=2.5))


def _tiny(monkeypatch, tool):
    monkeypatch.setattr(tool, "get_config",
                        lambda name: tiny_test_config(n_state=64, n_head=2, n_layer=2))


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_int8_agreement_tool_two_steps(tools, tmp_path, monkeypatch, capsys):
    """Two training steps, a saved checkpoint, then the same variants from
    that checkpoint: one line per logged step, the training report, and one
    line per variant (three against fp32 and fp32's own WER), the same
    lines again from the checkpoint."""
    tool = tools[0]
    _tiny(monkeypatch, tool)
    ckpt, out = str(tmp_path / "t.safetensors"), str(tmp_path / "o.jsonl")
    common = ["--batch", "2", "--sample-len", "6", "--device", "cpu", "--out", out]
    assert tool.main(["--steps", "2", "--save-checkpoint", ckpt] + common) == 0
    trained = _lines(capsys)
    assert [r["step"] for r in trained[:2]] == [0, 1]
    assert all(np.isfinite(r["loss"]) and 0 <= r["acc"] <= 1 for r in trained[:2])
    assert trained[2]["trained"]["steps"] == 2 and trained[2]["card"] == "cpu"
    variants = trained[3:]
    assert [r["config"] for r in variants] == ["bf16", "bf16_kvint8",
                                               "wint8_kvint8", "fp32"]
    for r in variants[:3]:
        assert 0 <= r["token_agreement_vs_fp32"] <= 1
        assert r["earliest_divergence_step"] is None or \
            0 <= r["earliest_divergence_step"] < 6
    assert all(r["wer_vs_ground_truth"] >= 0 for r in variants)
    assert tool.main(["--checkpoint", ckpt] + common) == 0
    assert _lines(capsys) == variants
    with open(out) as f:
        assert [json.loads(line) for line in f] == trained + variants


def test_spec_acceptance_tool_two_steps(tools, monkeypatch, capsys):
    """Two steps for the target and two for the half-depth draft, then one
    line per K (acceptance in [0, 1], speculative tokens equal to plain,
    equal WERs) and one timed line per (batch, K)."""
    tool = tools[1]
    _tiny(monkeypatch, tool)
    assert tool.main(["--steps", "2", "--draft-steps", "2", "--batch", "2",
                      "--ks", "2,3", "--time-batches", "2", "--repeats", "1",
                      "--device", "cpu"]) == 0
    lines = _lines(capsys)
    steps = [r for r in lines if "step" in r]
    assert [(r["model"], r["step"]) for r in steps] == [
        ("test", 0), ("test", 1), ("test-draft", 0), ("test-draft", 1)]
    per_k = [r for r in lines if "spec_k" in r and "metric" not in r]
    timed = [r for r in lines if r.get("metric") == "spec_trained_e2e"]
    assert [r["spec_k"] for r in per_k] == [2, 3] == [r["spec_k"] for r in timed]
    for r in per_k + timed:
        assert r["draft_layers"] == 1 and r["target_steps"] == r["draft_steps"] == 2
        assert 0 <= r["acceptance_rate"] <= 1 and r["tokens_per_iter"] >= 1
        assert r["token_exact_vs_plain"]
    for r in per_k:
        assert r["wer_plain"] == r["wer_spec"]
    for r in timed:
        assert r["batch"] == 2 and r["card"] == "cpu"
        assert min(r["frontend_s"], r["decode_plain_s"], r["decode_spec_s"]) > 0
        assert r["break_even_tokens_per_iter"] > 0


def test_draft_encoder_is_a_frozen_copy(tools):
    """The draft's encoder starts equal to the target's in tensors of its
    own, stays bit-identical through decoder-only training, while its
    decoder moves and the target's weights do not."""
    tool = tools[1]
    cfg = tiny_test_config(n_state=64, n_head=2, n_layer=2)
    from openai_whisper_coreml_tpu_torch.tokenizer import get_tokenizer

    tok = get_tokenizer(cfg, language="en")
    target, _ = tool.train_model(cfg, tok, tool.PHRASES_SHORT, 1, 2, 0.0,
                                 device="cpu")
    before = {k: v.clone() for k, v in target.state_dict().items()}
    draft, report = tool.train_model(tool.draft_config(cfg), tok,
                                     tool.PHRASES_SHORT, 2, 2, 0.0, device="cpu",
                                     trainable="^decoder", encoder_from=target,
                                     seed=1)
    assert report["steps"] == 2 and draft.cfg.n_text_layer == 1
    t_enc, d_enc = target.encoder.state_dict(), draft.encoder.state_dict()
    for k in t_enc:
        assert torch.equal(t_enc[k], d_enc[k])
        assert t_enc[k].data_ptr() != d_enc[k].data_ptr()
    assert all(torch.equal(v, before[k]) for k, v in target.state_dict().items())
    start = tool.train_model(tool.draft_config(cfg), tok, tool.PHRASES_SHORT, 0,
                             2, 0.0, device="cpu", seed=1)[0]
    assert not torch.equal(start.decoder.token_embedding, draft.decoder.token_embedding)
    assert not any(p.requires_grad for p in draft.parameters())
