#!/usr/bin/env python
"""int8 serving evidence on TRAINED weights, for the PyTorch port (port of
`benchmarks/int8_agreement_trained.py`).

    python3 tools/torch_int8_agreement_trained.py [--model tiny] [--steps 400]
        [--batch 8] [--sample-len 0] [--target-loss 0.002]
        [--save-checkpoint f.safetensors | --checkpoint f.safetensors]
        [--out f.jsonl] [--device cpu]

Random weights are degenerate for an agreement ladder in both directions:
near-tie argmaxes exaggerate flips, and real failure modes (outlier
channels that per-column int8 scaling can clip) cannot appear. So:

  1. train the real `tiny` config on a synthetic tone->phrase task until
     its logit landscape is peaked (loss << 1), through the port's
     `train.make_train_step` (lr 3e-4, remat, no flash), on the log-mel
     windows serving feeds a model (`window_mel`);
  2. greedy-decode HELD-OUT noisy variants of the tones with the fp32
     oracle, bf16, bf16 + int8 cross-KV, and int8 weights + int8 cross-KV;
  3. report token agreement against fp32 AND the WER against the known
     ground-truth phrases.

One JSON line per training report and per variant, on stdout (and appended
to `--out` when given); `--save-checkpoint` keeps the trained weights
(safetensors) for reuse. On the card (the default; fp32 with TF32 off) the
frontend runs K4, the encoder K1, and the bf16-cache steps K3, the int8
cross-KV steps K6. `--device cpu` runs it all on the CPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from openai_whisper_coreml_tpu_torch.config import get_config  # noqa: E402

# training stops at the first logged loss (every 25 steps) below this. The
# held-out WER keeps falling well past the training fit: stopped at JAX's
# 0.05, the tiny target read a held-out WER of 0.40 on an H100 (PERF.md);
# `torch_spec_acceptance_trained.py --heldout-wer` logs the curve
TARGET_LOSS = 0.002

PHRASES = [
    "the quick brown fox jumps over the lazy dog",
    "speech recognition on tensor processing units",
    "hello world this is a synthetic utterance",
    "quantization should not change the transcript",
    "we measure word error rate against ground truth",
    "a completely different sentence about boats",
    "numbers like seven forty two and nineteen",
    "the weather tomorrow will be cold and clear",
]


def tone_audio(class_id: int, seed: int, seconds: float = 8.0) -> np.ndarray:
    """Distinct multi-tone signature per class + noise; 16 kHz mono."""
    rng = np.random.default_rng(1000 * class_id + seed)
    t = np.arange(int(seconds * 16000)) / 16000
    f0 = 180 + 60 * class_id
    x = (0.30 * np.sin(2 * np.pi * f0 * t)
         + 0.20 * np.sin(2 * np.pi * (f0 * 1.5 + 17) * t)
         + 0.10 * np.sin(2 * np.pi * (f0 * 0.5 + 5) * t))
    x *= 1 + 0.4 * np.sin(2 * np.pi * (1.3 + 0.2 * class_id) * t)
    x += 0.02 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


def device_of(name) -> torch.device:
    if name is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run on "
                               "the CPU")
        name = "cuda"
    if torch.device(name).type == "cuda":
        # fp32 means fp32: the oracle and the training run without TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return torch.device(name)


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" off
    the card): every timed or measured line carries it."""
    if device.type != "cuda":
        return "cpu"
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def window_mel(model, audio: np.ndarray) -> torch.Tensor:
    """(B, n_mels, 3000) log-mel of (B, n) clips of up to 30 s as serving
    feeds the model (`serve.transcribe_batch`, openai's transcribe): each
    clip's log-mel over the clip and 30 s of silence, its content frames
    kept and the rest of the window zero in the mel domain. A model trained
    on `pad_or_trim(audio)`'s log-mel instead sees the silence's mel there,
    and a small one can fail on that difference alone (PERF.md)."""
    from openai_whisper_coreml_tpu_torch.config import HOP_LENGTH
    from openai_whisper_coreml_tpu_torch.serve import _batched_mels, _window_mel

    content = -(-audio.shape[-1] // HOP_LENGTH)
    return torch.stack([_window_mel(m, 0, content)
                        for m in _batched_mels(model, list(audio))])


def train(model, tok, phrases, *, steps: int, batch: int, target_loss: float,
          trainable=None, seed: int = 0, emit=print, probe=None) -> dict:
    """Fit the tone->phrase corpus in place: `steps` AdamW steps of `batch`
    random (class, noise seed) pairs, stopping at the first logged loss
    (every 25 steps and the last) below `target_loss`. `probe(model)`, when
    given, adds its dict to each logged line (its time counts in the
    seconds). Returns the stop step, the last logged loss and accuracy, and
    the wall seconds to it (the loss read is the fence); the weights are
    left without gradients, ready to decode."""
    from openai_whisper_coreml_tpu_torch.train import (
        TrainConfig, make_batch, make_train_step)

    cfg = model.cfg
    init_fn, step_fn = make_train_step(
        cfg, TrainConfig(learning_rate=3e-4, remat=True, trainable=trainable))
    model, opt_state = init_fn(model)
    sot_len = len(tok.sot_sequence_including_notimestamps)
    longest = max(len(tok.encode(" " + p.strip())) for p in phrases)
    train_len = sot_len + longest + 1  # the full target with eot, no cut

    rng = np.random.default_rng(seed)
    out = {"model": cfg.name, "steps": 0, "loss": float("inf"), "acc": 0.0}
    t0 = time.perf_counter()
    for step in range(steps):
        cls = rng.integers(0, len(phrases), batch)
        audio = np.stack([tone_audio(c, int(rng.integers(50))) for c in cls])
        mel = window_mel(model, audio)
        _, tokens, mask = make_batch(cfg, tok, mel, [phrases[c] for c in cls],
                                     max_len=train_len)
        model, opt_state, metrics = step_fn(model, opt_state, mel, tokens, mask)
        if step % 25 == 0 or step == steps - 1:
            out.update(steps=step + 1, loss=round(float(metrics["loss"]), 4),
                       acc=round(float(metrics["accuracy"]), 4),
                       seconds=round(time.perf_counter() - t0, 3))
            extra = {}
            if probe is not None:
                with torch.no_grad():
                    extra = probe(model)
            emit(json.dumps({"model": cfg.name, "step": step,
                             "loss": out["loss"], "acc": out["acc"],
                             "seconds": out["seconds"], **extra}))
            if out["loss"] < target_loss:
                break
    del opt_state
    model.requires_grad_(False)
    return out


def notimestamps_prompt(tok) -> list:
    """The prompt `train.make_batch` teaches: sot, en, transcribe,
    notimestamps."""
    return [tok.sot, tok.language_token("en"), tok.transcribe, tok.no_timestamps]


def decode_tokens(model, audio: np.ndarray, sample_len: int,
                  kv_dtype: str) -> np.ndarray:
    """Greedy decode of (B, n) clips (their `window_mel`) on the training
    prompt with the timestamp grammar off and the production suppression
    masks; returns the (B, sample_len) sampled tokens (eot after the end)."""
    from openai_whisper_coreml_tpu_torch.decoding import (
        DecodingOptions, build_blank_mask, build_suppress_mask,
        greedy_decode_core)
    from openai_whisper_coreml_tpu_torch.tokenizer import get_tokenizer

    tok = get_tokenizer(model.cfg, language="en")
    dev = model.device
    opts = DecodingOptions(language="en")
    suppress = torch.as_tensor(build_suppress_mask(tok, opts), device=dev)
    blank = torch.as_tensor(build_blank_mask(tok), device=dev)
    row = notimestamps_prompt(tok)
    initial = torch.tensor([row] * audio.shape[0], device=dev)
    feats = model.encode(window_mel(model, audio))
    tokens, *_ = greedy_decode_core(
        model.decoder, feats, initial, suppress, blank, 50, 0, 0,
        sample_len=sample_len, use_timestamps=False, prompt_len=len(row),
        kv_dtype=kv_dtype, cache_dtype="bf16")
    return tokens[:, len(row):].cpu().numpy()


def agreement(a: np.ndarray, b: np.ndarray):
    """(token agreement, earliest divergence step over rows or None)."""
    agree = float((a == b).mean())
    div = np.argmax(a != b, axis=1)  # first divergence per row (0 if equal)
    any_div = (a != b).any(axis=1)
    first = [int(d) for d, x in zip(div, any_div) if x]
    return agree, (min(first) if first else None)


def texts_of(tok, toks: np.ndarray) -> list:
    return [tok.decode([int(t) for t in row if t < tok.eot]).strip()
            for row in toks]


VARIANTS = ("fp32", "bf16", "bf16_kvint8", "wint8_kvint8")


def variant(cfg, tree32, label: str, device):
    """(model, cross-KV dtype) of one serving configuration of the trained
    fp32 weights `tree32` (a JAX-layout tree on the host)."""
    from openai_whisper_coreml_tpu_torch.models.whisper import WhisperModel
    from openai_whisper_coreml_tpu_torch.params import tree_from_numpy
    from openai_whisper_coreml_tpu_torch.quantize import quantize_params

    def cast(tree, dtype):
        return {k: cast(v, dtype) if isinstance(v, dict) else
                v.to(device=device, dtype=dtype) for k, v in tree.items()}

    tree = tree_from_numpy(tree32)
    if label == "fp32":
        return WhisperModel(cfg, cast(tree, torch.float32)), "bf16"
    p16 = cast(tree, torch.bfloat16)
    if label == "bf16":
        return WhisperModel(cfg, p16), "bf16"
    if label == "bf16_kvint8":
        return WhisperModel(cfg, p16), "int8"
    if label == "wint8_kvint8":
        return WhisperModel(cfg, quantize_params(p16)), "int8"
    raise ValueError(label)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--sample-len", type=int, default=0,
                    help="0 = auto: longest target + eot + slack (a shorter "
                    "horizon cuts the eot off the longest rows)")
    ap.add_argument("--target-loss", type=float, default=TARGET_LOSS)
    ap.add_argument("--save-checkpoint", default="")
    ap.add_argument("--checkpoint", default="",
                    help="skip training, load these trained weights")
    ap.add_argument("--out", default="", help="append the JSON lines here too")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    from openai_whisper_coreml_tpu_torch.eval.wer import compute_wer
    from openai_whisper_coreml_tpu_torch.models.whisper import (
        WhisperModel, build_model)
    from openai_whisper_coreml_tpu_torch.params import to_jax_params
    from openai_whisper_coreml_tpu_torch.tokenizer import get_tokenizer
    from openai_whisper_coreml_tpu_torch.utils.checkpoint import (
        load_params, save_params)

    out = open(args.out, "a") if args.out else None

    def emit(line: str) -> None:
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")

    where = card(device)
    cfg = get_config(args.model)
    tok = get_tokenizer(cfg, language="en")
    n_cls = len(PHRASES)
    longest = max(len(tok.encode(" " + p.strip())) for p in PHRASES)
    if args.sample_len <= 0:
        args.sample_len = longest + 5  # room for eot + a little drift

    # -- 1. train ----------------------------------------------------------
    if args.checkpoint:
        model = WhisperModel(cfg, load_params(args.checkpoint, cfg=cfg)).to(device)
    else:
        model = build_model(cfg, dtype=torch.float32, seed=0, device=device)
        report = train(model, tok, PHRASES, steps=args.steps, batch=args.batch,
                       target_loss=args.target_loss, emit=emit)
        emit(json.dumps({"model": args.model, "trained": report, "card": where}))
        if args.save_checkpoint:
            save_params(model, args.save_checkpoint, model_name=args.model)
    fence(device)
    tree32 = to_jax_params(model)
    del model
    gc.collect()

    # -- 2. decode held-out variants under each serving config -------------
    eval_cls = [i % n_cls for i in range(args.batch)]
    eval_audio = np.stack([tone_audio(c, seed=777 + i)
                           for i, c in enumerate(eval_cls)])
    refs = [PHRASES[c] for c in eval_cls]

    runs, texts = {}, {}
    for label in VARIANTS:
        model, kv = variant(cfg, tree32, label, device)
        runs[label] = decode_tokens(model, eval_audio, args.sample_len, kv)
        texts[label] = texts_of(tok, runs[label])
        del model
        gc.collect()

    for label in VARIANTS[1:]:
        agree, first = agreement(runs["fp32"], runs[label])
        emit(json.dumps({
            "model": args.model, "weights": "trained", "config": label,
            "token_agreement_vs_fp32": round(agree, 4),
            "earliest_divergence_step": first,
            "wer_vs_ground_truth": round(compute_wer(refs, texts[label]).wer, 4),
            "card": where}))
    emit(json.dumps({
        "model": args.model, "weights": "trained", "config": "fp32",
        "wer_vs_ground_truth": round(compute_wer(refs, texts["fp32"]).wer, 4),
        "card": where}))
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
