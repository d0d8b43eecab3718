"""Times the bf16 flash-attention kernel as it ships and in patched copies,
on one NVIDIA GPU.

    python3 tools/torch_flash_tiles.py [--iters 50] [--ablate]

Each variant is a copy of `csrc/flash_attention.cu` with a few lines
replaced (written under build/, one nvcc per variant, all at once):

  tile variants (held against the plain version before they are timed):
    "rows_128"    two consumer warpgroups, a 128-row query tile
    "stages_3"    a three-stage K/V ring
    "block_n_64"  64-key stages (S on the m64n64k16 wgmma)
  with --ablate, copies that leave one part of the work out, to show where
  the time goes (their outputs are wrong by design and are not checked):
    "no_softmax"  P is S: no max, exp or sum
    "no_products" no wgmma: S is filled from the key index
    "no_kv_loads" the ring's stages are loaded once, then handed over
                  without a load

It times each at the shapes `chip_smoke.py` times: K1 (4,1500,20,64),
K1-causal (4,448,20,64), K5 (2,2048,20,64) non-causal and causal. Per
variant and shape it prints one JSON line: the kernel's device time
(torch.profiler), its CUDA-event time, its achieved TFLOP/s, and
scaled_dot_product_attention's device time summed over the kernels it
launches. The card's name and power limit close the output.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = (("K1", 4, 1500, False), ("K1-causal", 4, 448, True),
          ("K5", 2, 2048, False), ("K5-causal", 2, 2048, True))
HEADS, HEAD_DIM = 20, 64


def _ss_wgmma(n: int, first: bool) -> str:
    """The C++ of an S = q'K^T k-step on the m64n{n}k16 wgmma, both operands
    in shared memory; `first` overwrites the accumulator."""
    regs = n // 2
    out = ", ".join(f'"{"=" if first else "+"}f"(d[{i}])' for i in range(regs))
    return (
        f"__device__ __forceinline__ void wgmma_ss_n{n}{'_first' if first else ''}"
        f"(float (&d)[{regs}], uint64_t desc_a, uint64_t desc_b) {{\n"
        f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"\n'
        f'    "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
        f'    "{{{", ".join(f"%{i}" for i in range(regs))}}}, "\n'
        f'    "%{regs}, %{regs + 1}, p, 1, 1, 0, 0;\\n}}\\n"\n'
        f'    : {out}\n'
        f'    : "l"(desc_a), "l"(desc_b), "r"({0 if first else 1})\n'
        f'    : "memory");\n}}\n\n')


# (text in csrc/flash_attention.cu, what replaces it) per variant
TILES = {
    "rows_128": [("constexpr int kConsumers = 3;", "constexpr int kConsumers = 2;"),
                 ("constexpr int kProducerRegs = 32;", "constexpr int kProducerRegs = 24;"),
                 ("constexpr int kConsumerRegs = 160;", "constexpr int kConsumerRegs = 240;")],
    "stages_3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "block_n_64": [
        ("constexpr int kBlockN = 128;", "constexpr int kBlockN = 64;"),
        ("// D (64 x 128, fp32) = A (64 x 16) B (16 x 128)",
         _ss_wgmma(64, True) + _ss_wgmma(64, False)
         + "// D (64 x 128, fp32) = A (64 x 16) B (16 x 128)"),
        ("wgmma_ss_n128_first(s_acc,", "wgmma_ss_n64_first(s_acc,"),
        ("wgmma_ss_n128(s_acc,", "wgmma_ss_n64(s_acc,")],
}
ABLATIONS = {
    "no_softmax": [("softmax_tile(s_acc, m_run, l_run, alpha);",
                    "alpha[0] = alpha[1] = 1.f;")],
    "no_products": [
        ("wgmma_ss_n128_first(s_acc, q_desc, k_desc);",
         "for (int i = 0; i < kBlockN / 2; ++i) s_acc[i] = (key0 + i) * sm_scale;"),
        ("wgmma_ss_n128(s_acc, q_desc + 2 * kk, k_desc + 2 * kk);", ""),
        ("wgmma_rs_n64_tb(o_acc, p[kk], v_desc + 128 * kk);", "")],
    "no_kv_loads": [("        mbar_expect_tx(full, 2 * kKVBytes);",
                     "        if (j >= kStages) {\n          mbar_arrive(full);\n"
                     "          continue;\n        }\n"
                     "        mbar_expect_tx(full, 2 * kKVBytes);")],
}
PATCHES = {"default": [], **TILES, **ABLATIONS}


def build(variant: str):
    from openai_whisper_coreml_tpu_torch.ops import _build
    from openai_whisper_coreml_tpu_torch.ops import flash_attention as fa

    source = _build.CSRC / "flash_attention.cu"
    name = "flash_attention"
    if PATCHES[variant]:
        text = source.read_text()
        for old, new in PATCHES[variant]:
            if old not in text:
                raise RuntimeError(f"{variant}: {old!r} is not in {source}")
            text = text.replace(old, new)
        name = f"flash_attention_{variant}"
        source = _build.BUILD_DIR.parent / "variants" / f"{name}.cu"
        source.parent.mkdir(parents=True, exist_ok=True)
        source.write_text(text)
    lib = fa.bind(_build.load_library(name, str(source)))
    ptxas = [line.strip() for line in _build.BUILD_INFO[name]["log"].splitlines()
             if "registers" in line or "spill" in line or "C75" in line]
    return lib, ptxas


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--ablate", action="store_true",
                        help="also time the source with parts of the work left out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_tiles: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from openai_whisper_coreml_tpu_torch.ops import flash_attention as fa

    variants = ["default", *TILES, *(ABLATIONS if args.ablate else ())]
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(build, variants)))
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for which, b, t, causal in SHAPES:
        q, k, v = (torch.randn(b, t, HEADS, HEAD_DIM, generator=g, device="cuda")
                   .bfloat16() for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = cs.device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), None, args.iters)
        inputs[which] = (q, k, v, causal, sdpa)
    for variant, (lib, ptxas) in built.items():
        print(json.dumps({"variant": variant, "ptxas": ptxas}), flush=True)
        fa.load_kernel = lambda lib=lib: lib
        for which, (q, k, v, causal, sdpa) in inputs.items():
            out = fa.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if variant not in ABLATIONS:
                cs.check_errors(f"{variant} {which}", out,
                                fa.flash_attention_reference(q, k, v, causal=causal), True)
            run = lambda: fa.flash_attention(q, k, v, causal=causal)  # noqa: E731
            dev = cs.device_ms(run, "fa_fwd_bf16", args.iters)
            b, t, h, d = q.shape
            flops = 4 * b * h * (cs.causal_pairs(t) if causal else t * t) * d
            print(json.dumps({
                "variant": variant, "shape": which, "device_ms": dev,
                "ms": cs.cuda_ms(run, args.iters), "tflops": flops / dev / 1e9,
                "sdpa_device_ms": sdpa}), flush=True)
    print(cs.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
