"""K2's probe: a chain of int8 cross-attention decode steps on one NVIDIA GPU.

    python3 tools/torch_sqa_v3_probe.py [--batch 24] [--layers 32] [--iters 8]

The counterpart of the JAX package's `benchmarks/sqa_v3_probe.py`, K2's
one path there: each decode step runs `--layers` cross-attention layers in
series, each layer's output added to its query, normalised and fed back as
the next layer's query, over int8 K/V of shape (layers, B, H, D, S) with
S = 1500 real columns stored as 1536 (the lane padding the TPU layout
keeps). The 3.0 GB of int8 K/V (at the defaults) and their fp32 column
scales are made on the card from a `torch.Generator` (seed 0), one layer
at a time. A step is timed four ways: the plain inline dequantisation
(int8 -> bf16 K/V, bf16 products, fp32 softmax), K6 (`ops/sqa_int8.py`)
over the same int8 K/V with a bf16 query, and K2 (`ops/sqa_v3.py`) with
int8 and with bf16 A.V. Each chain run's kernel launches must be exactly
layers x iterations. Prints first, per K2 mode, its error against its plain
version (`ops/sqa_v3.sqa_cross_int8_reference`) on layer 0 with the chain's
first query in bf16 and in fp32 and on the chain's last layer
(`kernel_and_plain`), and its error against the inline-dequant oracle on
layer 0 (`check_layer0`); then one JSON line per variant: the best per-step wall ms over `--repeats` runs (host clock after
a synchronize), the byte bound of a step, and the card's name and power
limit; then one more per variant with a step's device time under
torch.profiler (`device_per_step`: every kernel of one chain run, and the
attention kernel's own share).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Tuple

import torch

HBM_BYTES_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def make_kv(layers: int, batch: int, heads: int, dhead: int, seq: int, seq_pad: int,
            device: str = "cuda", seed: int = 0):
    """int8 K, V (L, B, H, D, seq_pad) and fp32 scales (L, B, H, 1, seq_pad),
    standard normals in bf16 quantised per column; the padding is zero."""
    from openai_whisper_coreml_tpu_torch.models.decoder import quantize_kv_column

    g = torch.Generator(device=device).manual_seed(seed)
    shape = (layers, batch, heads, dhead, seq_pad)
    k8, v8 = (torch.zeros(shape, dtype=torch.int8, device=device) for _ in range(2))
    ks, vs = (torch.zeros(shape[:3] + (1, seq_pad), device=device) for _ in range(2))
    for l in range(layers):
        for x8, xs in ((k8, ks), (v8, vs)):
            x = torch.randn((batch, heads, dhead, seq), generator=g, device=device,
                            dtype=torch.bfloat16)
            x8[l, ..., :seq], xs[l, ..., :seq] = quantize_kv_column(x)
    return k8, ks, v8, vs


def step_bytes(layers: int, batch: int, heads: int, dhead: int, seq: int) -> int:
    """Bytes one step must read: every layer's real int8 K/V columns and
    their fp32 scales, once."""
    return layers * (2 * batch * heads * dhead * seq + 2 * batch * heads * seq * 4)


def layer_fns(seq: int) -> Dict[str, Tuple]:
    """name -> (fn(x, k8, ks, v8, vs) of one layer, (B, H, D) bf16 -> bf16;
    the kernel module whose launches it counts, None for the plain one)."""
    from openai_whisper_coreml_tpu_torch.ops import sqa_int8 as si
    from openai_whisper_coreml_tpu_torch.ops import sqa_v3 as sv

    def inline(x, k8, ks, v8, vs):
        d, s = k8.shape[-2:]
        kd = (k8.float() * ks).bfloat16()
        vd = (v8.float() * vs).bfloat16()
        lg = torch.matmul(x[:, :, None, :], kd)[:, :, 0].float() * d ** -0.5
        lg = lg.masked_fill(torch.arange(s, device=x.device) >= seq, -1e30)
        w = torch.softmax(lg, dim=-1).bfloat16()
        return torch.matmul(vd, w[..., None])[..., 0]

    return {
        "inline_int8": (inline, None),
        "sqa_int8_k6": (lambda x, k8, ks, v8, vs: si.sqa_int8(x, k8, ks, v8, vs,
                                                              seq - 1, 0), si),
        "v3_av8": (lambda x, k8, ks, v8, vs: sv.sqa_cross_int8(
            x, k8, ks, v8, vs, s_len=seq, av_int8=True), sv),
        "v3_avbf16": (lambda x, k8, ks, v8, vs: sv.sqa_cross_int8(
            x, k8, ks, v8, vs, s_len=seq, av_int8=False), sv),
    }


def feed(fn, x: torch.Tensor, kv, layer: int) -> torch.Tensor:
    """One layer of the chain: normalise(fn(x) + x), the next query."""
    y = (fn(x, *(t[layer] for t in kv)) + x).float()
    return (y / y.square().mean().sqrt().clamp(min=1e-3)).bfloat16()


def chain(fn, x0: torch.Tensor, kv, iters: int) -> torch.Tensor:
    """`iters` decode steps, each every layer in series."""
    x = x0
    for _ in range(iters):
        for l in range(kv[0].shape[0]):
            x = feed(fn, x, kv, l)
    return x


def first_query(batch: int, heads: int, dhead: int) -> torch.Tensor:
    """The chain's first query, (B, H, D) bf16 standard normals (seed 1)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    return torch.randn((batch, heads, dhead), generator=g, device="cuda",
                       dtype=torch.bfloat16)


def kernel_and_plain(kv, seq: int):
    """Yield (label, K2's output, its plain version's output) in both A.V
    modes: on layer 0 with the chain's first query in bf16 and in fp32, and
    on the last layer with the bf16 query that K2's own chain (one step, in
    that mode) feeds it."""
    from openai_whisper_coreml_tpu_torch.ops import sqa_v3 as sv

    layers, batch, heads, dhead, _ = kv[0].shape
    x0 = first_query(batch, heads, dhead)
    for av in (True, False):
        def k2(x, k8, ks, v8, vs):
            return sv.sqa_cross_int8(x, k8, ks, v8, vs, s_len=seq, av_int8=av)

        x = x0
        for l in range(layers - 1):
            x = feed(k2, x, kv, l)
        for layer, q in ((0, x0), (0, x0.float()), (layers - 1, x)):
            inputs = [q] + [t[layer] for t in kv]
            label = {"av_int8": av, "layer": layer, "q": str(q.dtype).split(".")[-1]}
            yield (label, k2(*inputs),
                   sv.sqa_cross_int8_reference(*inputs, s_len=seq, av_int8=av))


def check_layer0(kv, seq: int) -> List[dict]:
    """K2 in both A.V modes against the inline-dequant oracle on layer 0
    with the chain's first query (fp32): max and rms error."""
    from openai_whisper_coreml_tpu_torch.ops import sqa_v3 as sv

    first = [t[0] for t in kv]
    _, batch, heads, dhead, _ = kv[0].shape
    q = first_query(batch, heads, dhead).float()
    ref = sv.sqa_cross_reference(q, *first, s_len=seq)
    out = []
    for av in (True, False):
        err = sv.sqa_cross_int8(q, *first, s_len=seq, av_int8=av) - ref
        out.append({"check": f"av_int8={av}", "layer": 0,
                    "max_abs_err": err.abs().max().item(),
                    "rms_err": err.square().mean().sqrt().item()})
    return out


def probe(kv, seq: int = 1500, iters: int = 8, repeats: int = 3) -> List[dict]:
    """One record per variant over the K/V of `make_kv`: per-step ms (best
    of `repeats` chain runs after a warm-up run), launches per run (checked:
    layers x iters for a kernel variant), and a step's byte bound."""
    layers, batch, heads, dhead, _ = kv[0].shape
    x0 = first_query(batch, heads, dhead)
    bound_ms = step_bytes(layers, batch, heads, dhead, seq) / HBM_BYTES_S * 1e3
    name = card()
    records = []
    for impl, (fn, mod) in layer_fns(seq).items():
        times, counts = [], []
        for run in range(repeats + 1):
            before = mod.launches if mod is not None else 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chain(fn, x0, kv, iters)
            torch.cuda.synchronize()
            if run:  # run 0 warms up
                times.append((time.perf_counter() - t0) * 1e3 / iters)
            counts.append((mod.launches - before) if mod is not None else 0)
        if mod is not None and set(counts) != {layers * iters}:
            raise AssertionError(f"{impl}: launches per chain run {counts}, expected "
                                 f"{layers * iters}")
        records.append({"impl": impl, "per_step_ms": min(times), "runs_ms": times,
                        "layers": layers, "batch": batch, "iters": iters,
                        "launches_per_run": counts[-1], "bound_ms": bound_ms,
                        "card": name})
    return records


# the attention kernel of each variant, by a part of its name
KERNEL_NAME = {"inline_int8": None, "sqa_int8_k6": "Int8KV", "v3_av8": "sqa_v3_kernel",
               "v3_avbf16": "sqa_v3_kernel"}


def device_per_step(kv, seq: int = 1500, iters: int = 8) -> List[dict]:
    """Per variant, the device ms of one step: every kernel of a profiled
    chain run (after a warm-up run), and the attention kernel's alone (the
    inline variant has none), per step."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_sqa_time import device_us

    layers, batch, heads, dhead, _ = kv[0].shape
    x0 = first_query(batch, heads, dhead)
    records = []
    for impl, (fn, _) in layer_fns(seq).items():
        every = device_us(lambda i: chain(fn, x0, kv, iters), 1, None)
        own = (device_us(lambda i: chain(fn, x0, kv, iters), 1, KERNEL_NAME[impl])
               if KERNEL_NAME[impl] else [])
        records.append({"impl": impl, "per_step_device_ms": sum(every) / 1e3 / iters,
                        "per_step_kernel_device_ms": sum(own) / 1e3 / iters,
                        "kernel_launches_profiled": len(own), "card": card()})
    return records


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=24)
    parser.add_argument("--heads", type=int, default=20)
    parser.add_argument("--dhead", type=int, default=64)
    parser.add_argument("--seq", type=int, default=1500)
    parser.add_argument("--seq-pad", type=int, default=1536)
    parser.add_argument("--layers", type=int, default=32)
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_sqa_v3_probe: no CUDA device", file=sys.stderr)
        return 1
    kv = make_kv(args.layers, args.batch, args.heads, args.dhead, args.seq, args.seq_pad)
    for label, out, plain in kernel_and_plain(kv, args.seq):
        err = (out.float() - plain.float()).abs()
        print(json.dumps({"check": "kernel vs plain", **label,
                          "max_abs_err": err.max().item(),
                          "mean_abs_err": err.mean().item()}), flush=True)
    for record in check_layer0(kv, args.seq) + probe(kv, args.seq, args.iters,
                                                       args.repeats):
        print(json.dumps(record), flush=True)
    for record in device_per_step(kv, args.seq, args.iters):
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
