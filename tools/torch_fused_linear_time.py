"""The fused linear kernel (`ops.fused_linear`) on one NVIDIA GPU, beside
its plain version and cuBLAS.

    python3 tools/torch_fused_linear_time.py [--rows 96000] [--sweep]

At large-v3's encoder shapes, (K, N) = (1280, 1280) (q, k, v, out and the
cross-attention's K and V), (1280, 5120) (fc1) and (5120, 1280) (fc2), with
int8 codes cast to bf16, fp32 scales and a bias, and TF32 off: the
kernel's agreement with the plain version (the largest difference in bf16
spacings of the plain result, and the share of equal outputs), then
milliseconds by CUDA events over 20 back-to-back calls of the kernel, of
the plain version (`torch.mm(out_dtype=float32)`, `* scale`, `+ b`, the
cast: what the port ran before) and of the bf16 cuBLAS GEMM alone (a
different function, the mainloop's yardstick), the kernel's device time
from torch.profiler, its bound (the larger of its FLOPs over 989 TFLOP/s
and its bytes over 3.35 TB/s) and its TFLOP/s. `--sweep` adds the
kernel and the plain version at small row counts, by events and by the
device time of every kernel a call launches (torch.profiler), which sets
`layers.FUSED_MIN_ROWS`. One JSON line per shape, with the PyTorch
version and the card's name and power limit. Prints the kernel's ptxas
report first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

SHAPES = {"qkv_out": (1280, 1280), "fc1": (1280, 5120), "fc2": (5120, 1280)}
SWEEP_ROWS = (64, 128, 256, 512, 768, 1024, 1500, 3000)
PEAK_BF16 = 989e12
HBM = 3.35e12


def ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, name: str | None, iters: int = 5) -> float:
    """Mean device time a call of the kernels whose name holds `name` (of
    every kernel the call launches, with `name` None), through
    `torch_sqa_time.device_us`."""
    from torch_sqa_time import device_us

    return sum(device_us(lambda i: fn(), iters, name)) / iters / 1e3


def operands(m: int, k: int, n: int, gen: torch.Generator):
    x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
    w = torch.randint(-127, 128, (k, n), device="cuda", generator=gen,
                      dtype=torch.int8).bfloat16()
    scale = 0.01 * (1 + torch.rand(n, device="cuda", generator=gen))
    b = torch.randn(n, device="cuda", generator=gen)
    return x, w, scale, b


def agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    g, r = got.float(), want.float()
    spacing = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - 7)
    return {"max_spacings": float(((g - r).abs() / spacing).max()),
            "equal_share": float((g == r).float().mean())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=96_000)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fused_linear_time: no CUDA device", file=sys.stderr)
        return 1
    from openai_whisper_coreml_tpu_torch.ops import _build
    from openai_whisper_coreml_tpu_torch.ops import fused_linear as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    fl.load_kernel()
    print(_build.BUILD_INFO["fused_linear"]["log"].strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    m = args.rows
    for name, (k, n) in SHAPES.items():
        x, w, scale, b = operands(m, k, n, gen)
        rec = {"shape": name, "m": m, "k": k, "n": n}
        rec.update(agreement(fl.fused_linear(x, w, scale, b),
                             fl.fused_linear_reference(x, w, scale, b)))
        flops = 2.0 * m * k * n
        nbytes = 2.0 * (m * k + k * n + m * n) + 8.0 * n
        rec.update({
            "ms": ms(lambda: fl.fused_linear(x, w, scale, b)),
            "device_ms": device_ms(lambda: fl.fused_linear(x, w, scale, b),
                                   "fused_linear_kernel"),
            "plain_ms": ms(lambda: fl.fused_linear_reference(x, w, scale, b)),
            "cublas_bf16_ms": ms(lambda: x @ w),
            "bound_ms": 1e3 * max(flops / PEAK_BF16, nbytes / HBM),
        })
        rec["tflops"] = flops / rec["device_ms"] / 1e9
        rec["cublas_tflops"] = flops / rec["cublas_bf16_ms"] / 1e9
        rec.update({"torch": torch.__version__, "card": card})
        print(json.dumps(rec), flush=True)
        del x, w
        torch.cuda.empty_cache()
    if args.sweep:
        for name, (k, n) in SHAPES.items():
            for rows in SWEEP_ROWS:
                x, w, scale, b = operands(rows, k, n, gen)
                rec = {"sweep": name, "m": rows, "k": k, "n": n,
                       "ms": ms(lambda: fl.fused_linear(x, w, scale, b), 50),
                       "plain_ms": ms(lambda: fl.fused_linear_reference(x, w, scale, b), 50),
                       "device_ms": device_ms(lambda: fl.fused_linear(x, w, scale, b),
                                              None, 50),
                       "plain_device_ms": device_ms(
                           lambda: fl.fused_linear_reference(x, w, scale, b), None, 50),
                       "card": card}
                rec.update(agreement(fl.fused_linear(x, w, scale, b),
                                     fl.fused_linear_reference(x, w, scale, b)))
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
