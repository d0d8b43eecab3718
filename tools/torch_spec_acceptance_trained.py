#!/usr/bin/env python
"""Acceptance of speculative decoding on TRAINED weights, for the PyTorch
port (port of `benchmarks/spec_acceptance_trained.py`).

    python3 tools/torch_spec_acceptance_trained.py [--model tiny]
        [--steps 400] [--draft-steps 400] [--batch 8] [--target-loss 0.002]
        [--ks 2,4,8] [--long] [--time-batches 8,16,24,32] [--repeats 3]
        [--heldout-wer] [--out f.jsonl] [--device cpu]

Random weights have no draftable signal (acceptance sits at the floor), so
this reproduces the large-v3 -> large-v3-turbo distillation recipe at tiny
scale, with no download:

  1. train the real `tiny` config on the synthetic tone->phrase corpus of
     `tools/torch_int8_agreement_trained.py` to a peaked logit landscape;
  2. build a HALF-DEPTH draft (tiny widths, n_text_layer // 2), give it a
     COPY of the trained encoder, freeze it, and train only its decoder on
     the same corpus (turbo's recipe: frozen encoder, shallow decoder,
     which is what lets the pair share the encoder features);
  3. greedy-decode HELD-OUT noisy tone variants with the plain loop and
     with `speculative.spec_decode_core` at each K, in fp32 (TF32 off on
     the card): acceptance per offered token, tokens per iteration, and
     the WER of both paths (equal: speculative greedy is token-exact).

One JSON line per K (with each model's stop step and loss). Each model
logs its loss every 25 steps, with `--heldout-wer` also its held-out WER.

  --long          ~4x longer utterances (four phrases joined by
                  connectives), a decode horizon like a real transcript's;
  --time-batches  then wall-clock the pipeline at each batch: the frontend
                  (serving's log-mel window, K4, + encoder K1) and a decode
                  to EOT, plain (the
                  flat greedy loop) against speculative at each K, with bf16
                  weights, int8 cross-KV (K6) and a bf16 self-cache (K3);
                  every stage fenced by torch.cuda.synchronize(), best of
                  --repeats after a warm-up. One JSON line per (batch, K),
                  with the card's name and power limit, the ms per
                  iteration over the plain ms per token (the break-even
                  tokens per iteration) and the measured tokens per
                  iteration beside it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from openai_whisper_coreml_tpu_torch.config import get_config  # noqa: E402
from torch_int8_agreement_trained import PHRASES as PHRASES_SHORT  # noqa: E402
from torch_int8_agreement_trained import (TARGET_LOSS, card, device_of,  # noqa: E402
                                          fence, notimestamps_prompt,
                                          tone_audio, train, window_mel)

# --long corpus: short phrases joined with distinct connectives, so the
# timed decode horizon is a real transcript's rather than a fragment's
PHRASES_LONG = [
    (PHRASES_SHORT[i] + " and then "
     + PHRASES_SHORT[(i + 1) % len(PHRASES_SHORT)] + " while "
     + PHRASES_SHORT[(i + 3) % len(PHRASES_SHORT)] + " although "
     + PHRASES_SHORT[(i + 5) % len(PHRASES_SHORT)])
    for i in range(len(PHRASES_SHORT))
]


def draft_config(cfg):
    """The half-depth draft of `cfg`: its widths, n_text_layer // 2."""
    return dataclasses.replace(cfg, name=f"{cfg.name}-draft",
                               n_text_layer=max(1, cfg.n_text_layer // 2))


def train_model(cfg, tok, phrases, steps, batch, target_loss, *, device,
                trainable=None, encoder_from=None, seed=0, emit=print,
                probe=None):
    """A model of `cfg` from random fp32 weights (`seed`), trained on the
    corpus of `phrases`; with `encoder_from`, the encoder starts as a COPY
    of that model's (its own tensors: training one must not move the
    other's). Returns (model, train report)."""
    from openai_whisper_coreml_tpu_torch.models.whisper import build_model

    model = build_model(cfg, dtype=torch.float32, seed=seed, device=device)
    if encoder_from is not None:
        model.encoder.load_state_dict(encoder_from.encoder.state_dict())
    report = train(model, tok, phrases, steps=steps, batch=batch,
                   target_loss=target_loss, trainable=trainable, seed=seed,
                   emit=emit, probe=probe)
    return model, report


def train_pair(model_name, phrases, *, steps, draft_steps, batch, target_loss,
               device, emit=print, heldout_wer=False):
    """The trained target and its half-depth draft (frozen copied encoder,
    decoder-only training): (target, draft, target report, draft report).
    With `heldout_wer` each logged step also carries the model's WER on
    the held-out variants (`wer_probe`)."""
    from openai_whisper_coreml_tpu_torch.tokenizer import get_tokenizer

    cfg = get_config(model_name)
    tok = get_tokenizer(cfg, language="en")
    probe = wer_probe(cfg, phrases, batch) if heldout_wer else None
    target, rep_t = train_model(cfg, tok, phrases, steps, batch, target_loss,
                                device=device, emit=emit, probe=probe)
    draft, rep_d = train_model(draft_config(cfg), tok, phrases, draft_steps,
                               batch, target_loss, device=device,
                               trainable="^decoder", encoder_from=target,
                               seed=1, emit=emit, probe=probe)
    return target, draft, rep_t, rep_d


def wer_probe(cfg, phrases, batch: int):
    """probe(model) -> {"heldout_wer": ...}: the plain greedy WER of a model
    under training on `batch` held-out variants."""
    from openai_whisper_coreml_tpu_torch.eval.wer import compute_wer

    audio, refs = held_out(phrases, batch)
    sample_len = horizon(cfg, phrases)

    def probe(model):
        cores = Cores(model, model, sample_len)
        hyps = cores.texts(cores.plain(cores.frontend(audio))[0])
        return {"heldout_wer": round(compute_wer(refs, hyps).wer, 4)}

    return probe


def horizon(cfg, phrases) -> int:
    """The decode horizon: the longest phrase's tokens, eot and some slack."""
    from openai_whisper_coreml_tpu_torch.tokenizer import get_tokenizer

    tok = get_tokenizer(cfg, language="en")
    return max(len(tok.encode(" " + p.strip())) for p in phrases) + 5


def held_out(phrases, batch: int, seed0: int = 777):
    """(B, 8 s) held-out tone variants, class i % n, and their phrases."""
    cls = [i % len(phrases) for i in range(batch)]
    audio = np.stack([tone_audio(c, seed=seed0 + i) for i, c in enumerate(cls)])
    return audio, [phrases[c] for c in cls]


class Cores:
    """The plain and speculative decode cores of one target/draft pair on
    the training prompt (timestamp grammar off), at a fixed horizon."""

    def __init__(self, target, draft, sample_len: int, kv_dtype: str = "bf16"):
        from openai_whisper_coreml_tpu_torch.decoding import (
            DecodingOptions, build_blank_mask, build_suppress_mask)
        from openai_whisper_coreml_tpu_torch.tokenizer import get_tokenizer

        self.target, self.draft = target, draft
        self.tok = tok = get_tokenizer(target.cfg, language="en")
        dev = target.device
        opts = DecodingOptions(language="en", without_timestamps=True)
        self.suppress = torch.as_tensor(build_suppress_mask(tok, opts), device=dev)
        self.blank = torch.as_tensor(build_blank_mask(tok), device=dev)
        self.seq = notimestamps_prompt(tok)
        self.sot_idx = self.seq.index(tok.sot)
        self.sample_len, self.kv_dtype = sample_len, kv_dtype

    def frontend(self, audio: np.ndarray) -> torch.Tensor:
        return self.target.encode(window_mel(self.target, audio))

    def _initial(self, b: int) -> torch.Tensor:
        return torch.tensor([self.seq] * b, device=self.target.device)

    def plain(self, feats: torch.Tensor):
        from openai_whisper_coreml_tpu_torch.decoding import greedy_decode_core

        return greedy_decode_core(
            self.target.decoder, feats, self._initial(feats.shape[0]),
            self.suppress, self.blank, -1, 0, self.sot_idx,
            sample_len=self.sample_len, use_timestamps=False,
            prompt_len=len(self.seq), kv_dtype=self.kv_dtype)

    def spec(self, feats: torch.Tensor, k: int):
        from openai_whisper_coreml_tpu_torch.speculative import spec_decode_core

        return spec_decode_core(
            self.target.decoder, self.draft.decoder, feats, feats,
            self._initial(feats.shape[0]), self.suppress, self.blank, -1, 0,
            self.sot_idx, sample_len=self.sample_len, use_timestamps=False,
            prompt_len=len(self.seq), spec_k=k, kv_dtype=self.kv_dtype)

    def texts(self, tokens: torch.Tensor) -> list:
        out = []
        for row in tokens[:, len(self.seq):].cpu().numpy():
            eots = np.nonzero(row == self.tok.eot)[0]
            cut = int(eots[0]) if len(eots) else len(row)
            out.append(self.tok.decode([int(t) for t in row[:cut]]).strip())
        return out


def stats_of(spec_out) -> dict:
    from openai_whisper_coreml_tpu_torch.speculative import spec_stats

    return spec_stats(spec_out[2].cpu().numpy(), spec_out[4].cpu().numpy(),
                      spec_out[5].cpu().numpy())


def acceptance(cores: Cores, audio: np.ndarray, refs: list, ks) -> list:
    """One record per K: acceptance, tokens per iteration, the WER of the
    plain and the speculative paths, and whether their tokens are equal."""
    from openai_whisper_coreml_tpu_torch.eval.wer import compute_wer

    feats = cores.frontend(audio)
    base = cores.plain(feats)[0]
    wer_plain = compute_wer(refs, cores.texts(base)).wer
    records = []
    for k in ks:
        out = cores.spec(feats, k)
        st = stats_of(out)
        spec_tokens = out[0][:, :base.shape[1]]
        records.append({
            "spec_k": k,
            "acceptance_rate": round(st["acceptance_rate"], 4),
            "tokens_per_iter": round(st["tokens_per_iter"], 3),
            "wer_plain": round(wer_plain, 4),
            "wer_spec": round(compute_wer(refs, cores.texts(spec_tokens)).wer, 4),
            "token_exact_vs_plain": bool(torch.equal(base, spec_tokens)),
        })
    return records


def race(cores: Cores, audio: np.ndarray, ks, repeats: int) -> list:
    """Walls of the frontend and of a decode to EOT, plain against
    speculative at each K, on `audio` (best of `repeats` after a warm-up,
    each fenced by torch.cuda.synchronize() on the card)."""
    dev = cores.target.device

    def timed(fn):
        fence(dev)
        out = fn()  # warm-up: kernel builds, the allocator's first growth
        fence(dev)
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = fn()
            fence(dev)
            ts.append(time.perf_counter() - t0)
        return min(ts), out

    b = audio.shape[0]
    t_front, feats = timed(lambda: cores.frontend(audio))
    t_plain, plain = timed(lambda: cores.plain(feats))
    plain_steps = int(plain[2].max())  # the slowest row's tokens
    audio_seconds = b * audio.shape[-1] / 16000  # the clips, not their windows
    rtfx_plain = audio_seconds / (t_front + t_plain)
    records = []
    for k in ks:
        t_spec, out = timed(lambda k=k: cores.spec(feats, k))
        st = stats_of(out)
        ms_iter = 1e3 * t_spec / int(out[4].max())
        ms_token = 1e3 * t_plain / plain_steps
        rtfx_spec = audio_seconds / (t_front + t_spec)
        records.append({
            "metric": "spec_trained_e2e", "batch": b, "spec_k": k,
            "sample_len": cores.sample_len, "audio_s": round(audio_seconds, 2),
            "frontend_s": round(t_front, 4),
            "decode_plain_s": round(t_plain, 4),
            "decode_spec_s": round(t_spec, 4),
            "rtfx_plain": round(rtfx_plain, 2),
            "rtfx_spec": round(rtfx_spec, 2),
            "speedup_e2e": round(rtfx_spec / rtfx_plain, 3),
            "speedup_decode": round(t_plain / max(t_spec, 1e-9), 3),
            "plain_ms_per_token": round(ms_token, 3),
            "spec_ms_per_iter": round(ms_iter, 3),
            "break_even_tokens_per_iter": round(ms_iter / ms_token, 3),
            "tokens_per_iter": round(st["tokens_per_iter"], 3),
            "acceptance_rate": round(st["acceptance_rate"], 4),
            "token_exact_vs_plain": bool(torch.equal(
                plain[0], out[0][:, :plain[0].shape[1]])),
        })
    return records


def bf16_copy(model):
    """The model with bf16 weights (the serving dtype), as a new module."""
    import copy

    return copy.deepcopy(model).to(torch.bfloat16)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--draft-steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--target-loss", type=float, default=TARGET_LOSS)
    ap.add_argument("--ks", default="2,4,8")
    ap.add_argument("--out", default="", help="append the JSON lines here too")
    ap.add_argument("--long", action="store_true",
                    help="~4x longer utterances (a real transcript's horizon)")
    ap.add_argument("--time-batches", default="",
                    help="comma list: wall-clock plain against speculative "
                         "end to end at each batch")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--heldout-wer", action="store_true",
                    help="log each model's held-out WER at every logged step")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    phrases = PHRASES_LONG if args.long else PHRASES_SHORT
    ks = [int(s) for s in args.ks.split(",") if s]

    out = open(args.out, "a") if args.out else None

    def emit(line: str) -> None:
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")

    where = card(device)
    target, draft, rep_t, rep_d = train_pair(
        args.model, phrases, steps=args.steps, draft_steps=args.draft_steps,
        batch=args.batch, target_loss=args.target_loss, device=device,
        emit=emit, heldout_wer=args.heldout_wer)
    from openai_whisper_coreml_tpu_torch.speculative import check_pair

    check_pair(target.cfg, draft.cfg)
    sample_len = horizon(target.cfg, phrases)
    common = {"model": args.model, "long": bool(args.long),
              "draft_layers": draft.cfg.n_text_layer,
              "target_steps": rep_t["steps"], "target_loss": rep_t["loss"],
              "draft_steps": rep_d["steps"], "draft_loss": rep_d["loss"],
              "card": where}

    # -- 3. held-out decode, fp32: plain vs speculative ----------------------
    audio, refs = held_out(phrases, args.batch)
    for rec in acceptance(Cores(target, draft, sample_len), audio, refs, ks):
        emit(json.dumps({**common, **rec}))

    # -- 4. end-to-end walls at the serving dtype ----------------------------
    if args.time_batches:
        cores = Cores(bf16_copy(target), bf16_copy(draft), sample_len,
                      kv_dtype="int8")
        for b in [int(s) for s in args.time_batches.split(",") if s]:
            audio_b, _ = held_out(phrases, b, seed0=555)
            for rec in race(cores, audio_b, ks, args.repeats):
                emit(json.dumps({**common, **rec}))
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
