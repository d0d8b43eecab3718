"""The fp32-output product of the port's linears (`models.layers.fp32_product`)
on one NVIDIA GPU, beside the products it replaced.

    python3 tools/torch_fp32_product_time.py

At large-v3's shapes (B=4 decode rows and a B=4 encode's 6000 rows, against
1280x1280, 1280x5120 and the 1280x51866 tied embedding), with bf16
operands and TF32 off: device ms (CUDA events, the mean of 50 calls) of
`torch.mm(x, w, out_dtype=torch.float32)` (`aten::mm.dtype`, what
`fp32_product` runs on the card), of the bf16 GEMM alone, of the bf16 GEMM
then `.float()` (the one-card linear before), and of the operands upcast
to fp32 (the row-parallel linear before); each one's largest difference
from the fp32 product of the upcast operands. Then whether the overload
has a derivative (the port wraps it in an autograd Function for
training), takes a transposed operand and fp16. One JSON line per shape,
with the PyTorch version and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

SHAPES = {"decode_qkv": (4, 1280, 1280), "decode_fc1": (4, 1280, 5120),
          "logits": (4, 1280, 51866), "encode_qkv": (6000, 1280, 1280),
          "encode_fc1": (6000, 1280, 5120)}


def ms(fn, iters: int = 50) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fp32_product_time: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (m, k, n) in SHAPES.items():
        a = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
        b = torch.randn(k, n, device="cuda", generator=gen).bfloat16()
        ref = a.float() @ b.float()
        rec = {"shape": name, "m": m, "k": k, "n": n,
               "max_abs_out_dtype": float((torch.mm(a, b, out_dtype=torch.float32)
                                           - ref).abs().max()),
               "max_abs_bf16_product": float(((a @ b).float() - ref).abs().max()),
               "ms_out_dtype": ms(lambda: torch.mm(a, b, out_dtype=torch.float32)),
               "ms_bf16": ms(lambda: a @ b),
               "ms_bf16_then_float": ms(lambda: (a @ b).float()),
               "ms_fp32_upcast": ms(lambda: a.float() @ b.float()),
               "torch": torch.__version__, "card": card}
        print(json.dumps(rec), flush=True)
    a = torch.randn(8, 64, device="cuda").bfloat16().requires_grad_()
    b = torch.randn(64, 32, device="cuda").bfloat16().requires_grad_()
    try:
        torch.mm(a, b, out_dtype=torch.float32).sum().backward()
        grad = "yes"
    except RuntimeError as e:
        grad = f"no: {e}"
    emb = torch.randn(51866, 1280, device="cuda").bfloat16()
    x = torch.randn(4, 1280, device="cuda").bfloat16()
    transposed = float((torch.mm(x, emb.T, out_dtype=torch.float32)
                        - x.float() @ emb.float().T).abs().max())
    fp16 = torch.mm(x.half(), emb.T.half(), out_dtype=torch.float32).dtype
    print(json.dumps({"derivative": grad, "transposed_max_abs": transposed,
                      "fp16_out": str(fp16), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
