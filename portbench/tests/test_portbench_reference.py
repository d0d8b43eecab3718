"""The plain reference against the port at a tiny size on the CPU (both in
float32): the log-mel, the encoder and the teacher-forced logits, the
language log-probabilities, and the byte-level text rule. And the
control: the reference at 4 bits reads a wider gap than the port."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu_torch import audio as port_audio
from openai_whisper_coreml_tpu_torch.decoding import detect_language
from openai_whisper_coreml_tpu_torch.tokenizer import get_tokenizer
from portbench.families import whisper
from portbench.lib import signals, weights
from portbench.reference import model as refm
from portbench.reference import tokens as reft
from portbench.tests.conftest import TINY, WIDE


@pytest.fixture(scope="module")
def pair():
    d = whisper.dims(WIDE)
    params = weights.make_params(d, 2**31 + 7, torch.device("cpu"), torch.float32)
    model = whisper.program(WIDE, d, params)
    return d, model, refm.Reference(params, d), refm.Reference(params, d, weight_bits=4)


def test_log_mel_agrees():
    audio = signals.speechy_np(480_000, 3, 0)
    want = refm.log_mel(torch.from_numpy(audio), 80)
    got = port_audio.log_mel_spectrogram(audio, n_mels=80)
    assert got.shape == want.shape == (80, 3000)
    assert torch.allclose(got, want, atol=2e-4)


def test_quantized_weights_agree(pair):
    d, model, ref, _ = pair
    w_q = model.encoder.blocks[1].mlp.fc1
    assert w_q.w_q is not None, "the int8 rule should take fc1 at d_model 128"
    want = ref.p["encoder"]["blocks"]["mlp"]["fc1"]["w"][1]
    assert torch.equal(w_q.w_q.float() * w_q.scale, want)


def test_logits_agree(pair):
    d, model, ref, _ = pair
    mel = refm.log_mel(torch.from_numpy(signals.speechy_np(480_000, 3, 1)), 80)[None]
    tokens = torch.tensor([reft.prompt(d) + [104, 101, 108, 108, 111]])
    with torch.no_grad():
        feats = model.encode(mel)
        got = model.logits(tokens, feats)
        want_feats = ref.encode(mel)
        want = ref.logits(tokens, ref.cross_kv(want_feats, quantized=False))
    assert torch.allclose(feats, want_feats, atol=1e-4)
    assert torch.allclose(got, want, atol=1e-3)


def test_language_logprobs_agree(pair):
    d, model, ref, _ = pair
    ids = reft.special(d)
    mel = torch.stack([refm.log_mel(torch.from_numpy(signals.speechy_np(480_000, 3, i)), 80)
                       for i in range(2)])
    with torch.no_grad():
        codes, probs = detect_language(model, mel)
        want = ref.language_logprobs(mel, ids["sot"], ids["lang0"])
    got = torch.tensor([[np.log(p[c]) for c in reft.LANGUAGES[:99]] for p in probs],
                       dtype=torch.float32)
    assert torch.allclose(got, want, atol=1e-4)


def test_the_control_reads_wider_than_the_port(pair):
    """At each position of the same tokens, the token that the 4-bit
    control puts first lies further below the reference's best than the
    port's: the comparison tells the precision step apart."""
    d, model, ref, ctl = pair
    mel = refm.log_mel(torch.from_numpy(signals.speechy_np(480_000, 3, 2)), 80)[None]
    prompt = reft.prompt(d)
    with torch.no_grad():
        feats = model.encode(mel)
        served = model.logits(torch.tensor([prompt]), feats)  # greedy by the port
        toks = []
        for _ in range(12):
            lg = model.logits(torch.tensor([prompt + toks]), feats)[0, -1]
            allowed = reft.allowed(d, "cpu", first=not toks)
            toks.append(int(lg.masked_fill(~allowed, -1e30).argmax()))
        from portbench.lib.judge import _gaps

        want = refm.window_logits(ref, mel[0], prompt, toks, quantized_kv=False)[:12]
        port_gap = float(_gaps(want, torch.tensor(toks), d).max())
        c = refm.window_logits(ctl, mel[0], prompt, toks, quantized_kv=False)[:12]
        allowed = reft.allowed(d, "cpu", first=False).expand(12, -1).clone()
        allowed[0] = reft.allowed(d, "cpu", first=True)
        pick = c.masked_fill(~allowed, -1e30).argmax(dim=-1)
        ctl_gap = float(_gaps(want, pick, d).max())
    assert served.shape[-1] == d["n_vocab"]
    assert port_gap < 1e-3 < ctl_gap


def test_text_rule_matches_the_port():
    cfg = whisper.program_config(TINY, whisper.dims(TINY))
    tok = get_tokenizer(cfg, language="en")
    for toks in ([104, 105, 32, 300, 50000], [32, 32], [226, 130, 172, 65], []):
        port = tok.decode([t for t in toks if t < tok.eot])
        assert reft.text(toks) == (port if port.strip() else "")
