"""Wall and device time of the PyTorch port's encoder on one NVIDIA GPU.

    python3 tools/torch_encode_time.py [--batch 4] [--runs 5]

Builds large-v3 with random weights from seed 0 (bf16 activations, int8
weights), makes the log-mel of a batch of 30 s noise windows, warms
`WhisperModel.encode` up, then measures: the wall of `--runs` encodes
(host clock after a synchronize; each one and the best), the device-busy
time per encode with the flash-attention kernel's share of it (the sum of
the kernels' times under torch.profiler, over three encodes), and the
kernel's launches per encode. Prints one JSON line with the card's name
and power limit and the file of the package that ran. The package is
whichever `import openai_whisper_coreml_tpu_torch` finds, so setting
PYTHONPATH to another checkout times that checkout's port; alternate two
checkouts in separate processes to compare them on one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

FLASH_KERNEL = "fa_fwd_bf16"  # the bf16 flash kernel's name, in every version


def measure(model, mel: torch.Tensor, runs: int, profiled: int = 3) -> dict:
    """Times `model.encode(mel)`: walls, then device time under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from openai_whisper_coreml_tpu_torch.ops import flash_attention as fa

    model.encode(mel)
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t = time.perf_counter()
        model.encode(mel)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    before = fa.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            model.encode(mel)
        torch.cuda.synchronize()
    launches = (fa.launches - before) / profiled
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(us for _, us in kernels) / profiled / 1e3
    flash = sum(us for name, us in kernels if FLASH_KERNEL in name) / profiled / 1e3
    return {"wall_ms": walls, "best_wall_ms": min(walls), "device_busy_ms": busy,
            "flash_device_ms": flash, "flash_share": flash / busy,
            "flash_launches": launches}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--runs", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_encode_time: no CUDA device", file=sys.stderr)
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
    print(json.dumps({"batch": args.batch, **measure(model, mel, args.runs),
                      "card": card, "package": wt.__file__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
