"""Time the PyTorch port's word-timestamp alignment pass on one NVIDIA GPU
(the card's counterpart of `benchmarks/wordts_bench.py`).

    PYTHONPATH=. python3 tools/torch_wordts_time.py [--batches 1,8,24]
                                                    [--tokens 48] [--repeats 3]

Builds large-v3 with random weights from seed 0 (bf16 activations, int8
weights), then for each batch size B aligns B full 30 s windows of random
bf16 features (seed 0) and the same `--tokens` random text tokens: B=1
through `timing.find_word_alignment` (the single-window path, with the
host tail fix), B>1 through `find_word_alignment_batch` (one forward per
token bucket), as serving runs it. For each B it prints one JSON line:
the best wall over `--repeats` runs after a warm-up (host clock; the
host's DTW ends each run), ms per window, the peak device memory of a
run (`torch.cuda.max_memory_allocated`, beyond what was allocated
before it), the device-busy time of one run under torch.profiler with the
flash kernel's share (every flash launch of the pass is K1's causal mode,
one per decoder layer per forward), its causal launches, and the card's
name and power limit. The package is whichever `import
openai_whisper_coreml_tpu_torch` finds (PYTHONPATH picks the checkout).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

FLASH_KERNEL = "fa_fwd"  # the flash kernel's name (bf16 and fp32 entries)


def measure(model, tok, text, batch: int, repeats: int) -> dict:
    """Walls, peak memory and one profiled run of aligning `batch` windows."""
    from torch.profiler import ProfilerActivity, profile

    from openai_whisper_coreml_tpu_torch import timing
    from openai_whisper_coreml_tpu_torch.ops import flash_attention as fa

    cfg = model.cfg
    rng = np.random.default_rng(0)
    feats = torch.as_tensor(
        rng.standard_normal((batch, cfg.n_audio_ctx, cfg.n_audio_state),
                            dtype=np.float32) * 0.05).to("cuda", torch.bfloat16)
    num_frames = 2 * cfg.n_audio_ctx  # full windows
    jobs = [(list(text), feats[i], num_frames) for i in range(batch)]

    def run():
        if batch == 1:
            return [timing.find_word_alignment(model, tok, text, feats[0], num_frames,
                                               language="en")]
        return timing.find_word_alignment_batch(model, tok, jobs, language="en")

    out = run()  # warm-up
    if len(out) != batch or any(len(words) == 0 for words in out):
        raise AssertionError(f"alignment gave {[len(w) for w in out]} words")
    walls = []
    for _ in range(repeats):
        t = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    peak = torch.cuda.max_memory_allocated()
    before = fa.launches_causal
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    launches = fa.launches_causal - before
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(us for _, us in kernels) / 1e3
    flash = sum(us for name, us in kernels if FLASH_KERNEL in name) / 1e3
    best = min(walls)
    return {"batch": batch, "tokens_per_window": len(text),
            "wall_s": walls, "best_wall_s": best,
            "ms_per_window": best / batch * 1e3, "windows_per_s": batch / best,
            "peak_bytes_beyond_start": peak - base, "peak_bytes": peak,
            "device_busy_ms": busy, "k1_causal_device_ms": flash,
            "k1_causal_share": flash / busy, "k1_causal_launches": launches,
            "device_busy_share_of_wall": busy / 1e3 / best}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batches", default="1,8,24")
    parser.add_argument("--tokens", type=int, default=48)
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_wordts_time: no CUDA device", file=sys.stderr)
        return 1
    import openai_whisper_coreml_tpu_torch as wt
    from openai_whisper_coreml_tpu_torch.tokenizer import get_tokenizer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    model = wt.load_model("large-v3", dtype=torch.bfloat16, quantize="int8",
                          device="cuda")
    tok = get_tokenizer(model.cfg, language="en")
    # text tokens below the specials, as a transcript's are
    text = np.random.default_rng(0).integers(300, 20_000, args.tokens).tolist()
    for batch in (int(b) for b in args.batches.split(",") if b):
        print(json.dumps({**measure(model, tok, text, batch, args.repeats),
                          "card": card, "package": wt.__file__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
