"""End-to-end transcription QUALITY through the port's HTTP server (port of
tests/test_e2e_quality.py), over the serving engines.

A small model is trained on a synthetic tone->phrase corpus (4 multi-tone
signatures of 8 s, 4 phrases) through the port's `train.make_train_step`,
on the log-mel windows serving feeds it (JAX's test trains on the audio
padded to 30 s, whose mel differs past the clip), then held-out noisy variants of the tones are POSTed to the OpenAI route of
`WhisperHTTPServer` and scored with the port's `compute_wer`: WER <= 0.30.
The same trained target serves three engines:

  * static      — the default static scheduler;
  * continuous  — the continuous-batching scheduler;
  * speculative — the static scheduler with a distilled half-depth draft on
                  the model (turbo's recipe at test scale: a copied, frozen
                  encoder and decoder-only training), so the draft's
                  accept/reject walk is under the WER gate too.

A 192-wide 2-layer model memorises the corpus in a few hundred steps (a
96-wide one plateaus at fragments). Marked slow, as JAX's is. It imports no
JAX, so it runs on a machine with a card and no JAX, where the `cuda` cases
run the kernels (K4 frontend, K1 encoder; ~45 s on an H100, minutes on a
CPU for the `cpu` cases):

    python -m pytest --noconftest -m slow tests/test_torch_e2e_quality.py -k cuda
"""

import io
import json
import sys
import urllib.request
import wave

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.slow

PHRASES = [
    "the quick brown fox",
    "hello world again",
    "seven forty two",
    "cold and clear weather",
]


def tone(cls: int, seed: int, seconds: float = 8.0) -> np.ndarray:
    rng = np.random.default_rng(1000 * cls + seed)
    t = np.arange(int(seconds * 16000)) / 16000
    f0 = 180 + 70 * cls
    x = (0.30 * np.sin(2 * np.pi * f0 * t)
         + 0.20 * np.sin(2 * np.pi * (f0 * 1.5 + 17) * t)
         + 0.10 * np.sin(2 * np.pi * (f0 * 0.5 + 5) * t))
    x *= 1 + 0.4 * np.sin(2 * np.pi * (1.3 + 0.2 * cls) * t)
    x += 0.02 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


def _wav_bytes(audio: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(16000)
        wf.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _window_mels(model, audio: np.ndarray) -> torch.Tensor:
    """The log-mel windows serving feeds the model for (B, n) clips
    (`serve.transcribe_batch`): the clip's content frames, then zeros in the
    mel domain. Training on `pad_or_trim(audio)`'s log-mel instead puts the
    mel of silence there, a difference a CPU-trained model of this size
    failed on alone (one class of four read as another through the server,
    never through the audio-padded frontend)."""
    from openai_whisper_coreml_tpu_torch.config import HOP_LENGTH
    from openai_whisper_coreml_tpu_torch.serve import _batched_mels, _window_mel

    content = -(-audio.shape[-1] // HOP_LENGTH)
    return torch.stack([_window_mel(m, 0, content)
                        for m in _batched_mels(model, list(audio))])


def _train(cfg, tok, device, *, steps, target_loss, trainable=None,
           encoder_from=None, seed=0):
    """Fit the toy corpus; returns the trained model. encoder_from +
    trainable="^decoder" is the turbo distillation shape (a copied, frozen
    encoder, decoder-only updates)."""
    from openai_whisper_coreml_tpu_torch.models.whisper import build_model
    from openai_whisper_coreml_tpu_torch.train import (
        TrainConfig, make_batch, make_train_step)

    model = build_model(cfg, dtype=torch.float32, seed=seed, device=device)
    if encoder_from is not None:
        # a copy: the draft's training must not move the target's encoder
        model.encoder.load_state_dict(encoder_from.encoder.state_dict())
    init_fn, step_fn = make_train_step(
        cfg, TrainConfig(learning_rate=3e-4, remat=True, trainable=trainable))
    model, opt_state = init_fn(model)

    longest = max(len(tok.encode(" " + p.strip())) for p in PHRASES)
    train_len = len(tok.sot_sequence_including_notimestamps) + longest + 1

    rng = np.random.default_rng(seed)
    loss = float("inf")
    for step in range(steps):
        cls = rng.integers(0, len(PHRASES), 4)
        audio = np.stack([tone(c, int(rng.integers(64))) for c in cls])
        mel = _window_mels(model, audio)
        _, tokens, mask = make_batch(cfg, tok, mel, [PHRASES[c] for c in cls],
                                     max_len=train_len)
        model, opt_state, metrics = step_fn(model, opt_state, mel, tokens, mask)
        if step % 25 == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            if loss < target_loss:
                break
    del opt_state
    model.requires_grad_(False)
    assert loss < 0.1, f"trainer failed to fit the toy corpus (loss={loss})"
    return model


DEVICES = [pytest.param("cpu", id="cpu"),
           pytest.param("cuda", id="cuda", marks=pytest.mark.cuda)]


@pytest.fixture(scope="module", params=DEVICES)
def trained(request):
    """One trained target + one distilled draft shared by all engines, on
    the device of the parameter."""
    import dataclasses

    from openai_whisper_coreml_tpu_torch.config import tiny_test_config
    from openai_whisper_coreml_tpu_torch.tokenizer import get_tokenizer

    device = request.param
    if device == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU with nvcc (the kernels have no CPU mode)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_test_config(n_state=192, n_head=3, n_layer=2)
    tok = get_tokenizer(cfg, language="en")
    model = _train(cfg, tok, device, steps=400, target_loss=0.02)
    cfg_d = dataclasses.replace(cfg, name="tiny-test-draft", n_text_layer=1)
    draft = _train(cfg_d, tok, device, steps=400, target_loss=0.05,
                   trainable="^decoder", encoder_from=model, seed=1)
    return model, draft


def _serve_wer(model, default_options):
    from openai_whisper_coreml_tpu_torch.eval.wer import compute_wer
    from openai_whisper_coreml_tpu_torch.serve_http import WhisperHTTPServer

    srv = WhisperHTTPServer(model, port=0, batch_size=4, batch_window_ms=30,
                            default_options=default_options)
    srv.start()
    try:
        hyps, refs = [], []
        for i in range(4):  # held-out noise seeds, one per class
            body_file = _wav_bytes(tone(i, seed=977 + i))
            boundary = b"xxbndxx"
            body = (b"--" + boundary + b"\r\n"
                    b'Content-Disposition: form-data; name="file"; '
                    b'filename="t.wav"\r\nContent-Type: audio/wav\r\n\r\n'
                    + body_file + b"\r\n--" + boundary + b"\r\n"
                    b'Content-Disposition: form-data; name="language"'
                    b"\r\n\r\nen\r\n"
                    b"--" + boundary + b"\r\n"
                    b'Content-Disposition: form-data; name="temperature"'
                    b"\r\n\r\n0\r\n"
                    b"--" + boundary + b"--\r\n")
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/audio/transcriptions",
                data=body,
                headers={"Content-Type": "multipart/form-data; "
                                         f"boundary={boundary.decode()}"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                out = json.load(io.TextIOWrapper(resp, encoding="utf-8"))
            hyps.append(out["text"])
            refs.append(PHRASES[i])
        return compute_wer(refs, hyps).wer, hyps
    finally:
        srv.stop()


# training (train.make_batch) uses the notimestamps sot sequence, so
# serving decodes without the timestamp grammar: the forced timestamp
# tokens the model never saw would wreck the toy transcripts
_BASE_OPTS = {
    "without_timestamps": True,
    "logprob_threshold": None,
    "compression_ratio_threshold": None,
    "no_speech_threshold": None,
}


@pytest.mark.parametrize("engine", ["static", "continuous", "speculative"])
def test_e2e_quality_http_wer(trained, engine):
    from openai_whisper_coreml_tpu_torch import speculative

    model, draft = trained
    opts = dict(_BASE_OPTS)
    if engine == "continuous":
        opts["scheduler"] = "continuous"
    elif engine == "speculative":
        model.draft = draft
        opts["spec_k"] = 3

    before = dict(speculative.TOTALS)
    try:
        wer, hyps = _serve_wer(model, opts)
    finally:
        model.draft = None
    print(f"\ne2e quality gate [{model.device.type} {engine}]: WER={wer:.4f} "
          f"hyps={hyps!r}", file=sys.stderr)
    assert wer <= 0.30, f"[{engine}] end-to-end WER {wer} (hyps={hyps!r})"
    if engine == "speculative":
        # the draft really ran: the accept/reject walk is what was gated
        assert speculative.TOTALS["iters"] > before["iters"]
