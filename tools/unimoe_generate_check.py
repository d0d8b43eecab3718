"""Check `lm_decoding.generate` of the audio language model at its published
widths on the card: prefill and cached greedy steps against the plain
reference's one teacher-forced forward over the grown sequence.

    python tools/unimoe_generate_check.py [--seed N] [--steps 16] [--limit 0.25]

Builds `uni-moe-2.0-omni` with random weights from the seed, int8 weights
made and quantized one layer at a time (`models/audio_lm.init_params`,
`model_from_params`), and generates for 4 clips of 30 s (a 24-token prefix, the audio, and
questions of 8, 40, 90 and 136 tokens): the prefill's pick, then `--steps`
cached steps. With the model freed, the reference (`portbench/reference/
unimoe.py`, float32, the same int8 rule) runs each clip's prompt and its
first `--steps` picks once under the program's routes; every pick's
log-probabilities over the whole vocabulary are compared with the
reference's at the same position. It prints one JSON line: the largest
gap per step, the routing decisions that differ where the reference's
margin is above the `omni-audio-langid` cell's `check.margin` (and the
widest margin of any that differs), the picks that differ from the
reference's argmax,
the prefill's and the steps' times (CUDA events), the device memory peak
and the card. It exits 1 when a gap is above `--limit` or a sure routing
decision differs, 3 without a card."""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

QUESTIONS = (8, 40, 90, 136)
PREFIX = 24


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--limit", type=float, default=0.25)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from openai_whisper_coreml_tpu_torch.audio import log_mel_spectrogram
    from openai_whisper_coreml_tpu_torch.config import UNIMOE_CONFIGS
    from openai_whisper_coreml_tpu_torch.lm_decoding import generate
    from openai_whisper_coreml_tpu_torch.models.audio_lm import init_params, model_from_params
    from portbench.lib import signals, spec
    from portbench.reference import unimoe as refu

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    cfg = UNIMOE_CONFIGS["uni-moe-2.0-omni"]
    gen = np.random.default_rng([args.seed & 0xFFFFFFFF, args.seed >> 32])
    prefix = gen.integers(0, cfg.n_vocab, PREFIX).tolist()
    prompts = [(prefix, gen.integers(0, cfg.n_vocab, q).tolist()) for q in QUESTIONS]
    audio = torch.stack([signals.speechy_torch(480_000, args.seed, i, dev)
                         for i in range(len(QUESTIONS))])
    mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)

    params = init_params(cfg, args.seed, torch.bfloat16, dev)
    model = model_from_params(cfg, params, quantize="int8")
    torch.cuda.synchronize(dev)
    built_peak = torch.cuda.max_memory_allocated(dev)
    generate(model, mel, prompts, 2)  # builds the kernels
    torch.cuda.synchronize(dev)
    t = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t[0].record()
    generate(model, mel, prompts, 1)
    t[1].record()
    out = generate(model, mel, prompts, args.steps + 1, logprobs=True, routes=True)
    t[2].record()
    torch.cuda.synchronize(dev)
    prefill_ms = t[0].elapsed_time(t[1])
    step_ms = (t[1].elapsed_time(t[2]) - prefill_ms) / args.steps
    peak = torch.cuda.max_memory_allocated(dev)
    picks = out.tokens.cpu()
    logprobs = out.logprobs.float().cpu()
    routes = [r.cpu() for r in out.routes]
    del model, out
    torch.cuda.empty_cache()

    refu.exact_float32()
    ref = refu.Reference(params, dataclasses.asdict(cfg), weight_bits=8)
    grown = [(a, list(b) + picks[i, :args.steps].tolist()) for i, (a, b) in enumerate(prompts)]
    with torch.no_grad():
        want = ref.forward(list(mel), grown, routes=routes, tail=args.steps + 1)
    gaps = [0.0] * (args.steps + 1)
    flips = 0
    for b in range(len(prompts)):
        w = want["logprobs"][b].cpu()
        for s in range(args.steps + 1):
            gaps[s] = max(gaps[s], float((logprobs[s, b] - w[s]).abs().max()))
        flips += int((w.argmax(dim=-1) != picks[b]).sum())
    margin = spec.cell_file("omni-audio-langid")["check"]["margin"]
    bad, seen, widest = refu.route_mismatch(routes, want["pick"], want["margin"], margin)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    row = {"seed": args.seed, "clips": len(prompts), "steps": args.steps,
           "lengths": [PREFIX + cfg.audio_tokens + q for q in QUESTIONS],
           "max_gap_by_step": gaps, "max_gap": max(gaps), "limit": args.limit,
           "margin": margin, "route_mismatch": bad, "sure_decisions": seen,
           "widest_differing_margin": widest, "argmax_differs": flips,
           "prefill_ms": prefill_ms, "step_ms": step_ms, "built_peak_bytes": built_peak,
           "peak_bytes": peak, "card": card}
    print(json.dumps(row), flush=True)
    return 0 if max(gaps) <= args.limit and bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
