"""Device time of the log-mel kernel K4 on one NVIDIA GPU.

    python3 tools/torch_mel_time.py [--parent DIR] [--tiles 8,16,32] [--ablate]

Prints one JSON line: the card's name and power limit, the file of the
package that ran, and for (4, 480 000) x 128 (four 30 s windows) and the
one-hour bucket (1, 61 920 000) x 128, noise audio from seed 1: the
kernel's device ms per call (its own time under torch.profiler, through
`tools/torch_sqa_time.py`'s helpers), the bound (the bytes the function
must move, padded audio in and log-mel out, over 3.35 TB/s) and the peak
device memory a call allocates beyond its input.

The package is whichever `import openai_whisper_coreml_tpu_torch` finds.
With --parent DIR (another checkout, e.g. a parent commit unpacked with
`git archive`), the script runs itself with PYTHONPATH=DIR and with this
checkout in turns, parent / this / this / parent, each in its own process
on the same card (`tools/torch_sqa_time.py`'s `in_turns`), and prints
their lines as "runs" of one. With --tiles,
"tiles": the same times for patched copies of `csrc/mel.cu` with other
frame tiles (kTileT frames and 8 kTileT threads a CTA; built under
build/variants/, one nvcc each, all at once), the shipped kernel before
and after them. With --ablate, "ablate": the same for patched copies that
leave one part of the work out, to show where the time goes (their outputs
are wrong by design): "no_load" (no audio read from device memory),
"no_stage_a" (no 8-point DFTs), "no_mel" (no mel product) and "empty"
(every CTA returns at once: the launch).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.append(str(ROOT))  # this checkout's package, unless PYTHONPATH names another
import torch_sqa_time  # noqa: E402  (the profiler helpers and in_turns)
SHAPES = ((4, 480_000), (1, 61_920_000))
N_MELS = 128
CALLS = 10


# (text in csrc/mel.cu, what replaces it) per patched copy
ABLATIONS = {
    "no_load": [("v = __ldg(reinterpret_cast<const float4*>(x) + i);",
                 "v = make_float4(0.f, 0.f, 0.f, 0.f);")],
    "no_stage_a": [("for (int task = tid; task < kTileT * 25; task += kThreads) {",
                    "for (int task = kTileT * 25; task < kTileT * 25; task += kThreads) {")],
    "no_mel": [("for (int bin = lo; bin < hi; ++bin) {", "for (int bin = hi; bin < hi; ++bin) {")],
    "empty": [("  const int tid = threadIdx.x;\n",
               "  const int tid = threadIdx.x;\n  if (n_frames > 0) return;\n")],
}


def build_variant(name: str, patches: list):
    """A patched copy of csrc/mel.cu, built and bound."""
    from openai_whisper_coreml_tpu_torch.ops import _build
    from openai_whisper_coreml_tpu_torch.ops import mel_kernel as mk

    source = _build.CSRC / "mel.cu"
    text = source.read_text()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} is not in {source}")
        text = text.replace(old, new)
    path = _build.BUILD_DIR.parent / "variants" / f"mel_{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return mk.bind(_build.load_library(f"mel_{name}", str(path)))


def variants(patches: dict) -> list:
    """measure() of each patched copy, the shipped kernel before and after."""
    from openai_whisper_coreml_tpu_torch.ops import mel_kernel as mk

    with concurrent.futures.ThreadPoolExecutor(len(patches)) as pool:
        libs = dict(zip(patches, pool.map(build_variant, patches, patches.values())))
    rows = [{"variant": "shipped", **measure()}]
    shipped = mk.load_kernel
    try:
        for name, lib in libs.items():
            mk.load_kernel = lambda lib=lib: lib
            rows.append({"variant": name, **measure()})
    finally:
        mk.load_kernel = shipped
    rows.append({"variant": "shipped", **measure()})
    return rows


def measure() -> dict:
    import openai_whisper_coreml_tpu_torch as wt
    from openai_whisper_coreml_tpu_torch.ops import mel_kernel as mk

    g = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for b, n in SHAPES:
        x = torch.randn(b, n, generator=g, device="cuda") * 0.1
        padded = torch.nn.functional.pad(x[:, None], (200, 200), mode="reflect")[:, 0]
        del x
        ms = torch_sqa_time.kernel_ms(lambda i: mk.log_mel_kernel(padded, N_MELS), CALLS,
                                      "log_mel_kernel")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = mk.log_mel_kernel(padded, N_MELS)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        nbytes = (padded.numel() + out.numel()) * 4
        rows.append({"shape": [b, n], "n_mels": N_MELS, "device_ms": ms,
                     "bound_ms": nbytes / torch_sqa_time.HBM_BYTES_S * 1e3, "bytes": nbytes,
                     "peak_bytes_beyond_input": peak})
        del padded, out
        torch.cuda.empty_cache()
    return {"card": torch_sqa_time.card(), "package": wt.__file__, "mel": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR", help="a checkout to time in turns with this one")
    ap.add_argument("--tiles", help="frame tiles to time patched copies at, e.g. 8,16,32")
    ap.add_argument("--ablate", action="store_true",
                    help="time patched copies that leave one part out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mel_time: no CUDA device", file=sys.stderr)
        return 1
    if args.tiles or args.ablate:
        tiles = [int(t) for t in args.tiles.split(",")] if args.tiles else []
        patches = {f"tile_{t}": [("constexpr int kTileT = 32;",
                                  f"constexpr int kTileT = {t};")] for t in tiles}
        if args.ablate:
            patches.update(ABLATIONS)
        rows = variants(patches)
        print(json.dumps({"card": torch_sqa_time.card(), "variants": rows}), flush=True)
        return 0
    if not args.parent:
        print(json.dumps(measure()), flush=True)
        return 0
    print(json.dumps({"card": torch_sqa_time.card(),
                      "runs": torch_sqa_time.in_turns(__file__, args.parent)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
