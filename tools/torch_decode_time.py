"""Wall time of the PyTorch port's batched greedy decode on one NVIDIA GPU.

    python3 tools/torch_decode_time.py [--batch 4] [--tokens 224] [--runs 1]

Builds large-v3 with random weights from seed 0 (bf16 activations, int8
weights), makes the log-mel of a batch of 30 s noise windows, decodes a
short warm-up, then times `WhisperModel.decode` with int8 cross-KV,
language "en", greedy, `--tokens` sampled tokens per row (the serve path
of chip_smoke.py). Prints one JSON line per timed run: seconds, tokens
per row, seconds per step, the card's name and power limit, and the file
of the package that ran. The package is whichever `import
openai_whisper_coreml_tpu_torch` finds, so setting PYTHONPATH to another
checkout times that checkout's port; alternate two checkouts in separate
processes to compare them on one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--tokens", type=int, default=224)
    parser.add_argument("--runs", type=int, default=1)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_time: no CUDA device", file=sys.stderr)
        return 1
    import openai_whisper_coreml_tpu_torch as wt

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    model = wt.load_model("large-v3", dtype=torch.bfloat16, quantize="int8",
                          device="cuda")
    audio = (np.random.default_rng(0).standard_normal((args.batch, 480_000)) * 0.1
             ).astype(np.float32)
    mel = model.log_mel(audio)
    model.decode(mel, wt.DecodingOptions(language="en", kv_dtype="int8", sample_len=8))
    opts = wt.DecodingOptions(language="en", kv_dtype="int8", sample_len=args.tokens)
    for _ in range(args.runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        results = model.decode(mel, opts)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        steps = max(len(r.tokens) for r in results)
        print(json.dumps({"decode_s": seconds, "tokens_per_row": [len(r.tokens) for r in results],
                          "s_per_step": seconds / steps, "card": card,
                          "package": wt.__file__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
