"""Device time of the single-query kernels K6, K3 and K2 on one NVIDIA GPU,
warm and cold, with their split sweep and the large-v3 decode step around
them.

    python3 tools/torch_sqa_time.py [--sweep] [--step] [--ablate] [--parent DIR]

Prints one JSON line with the card's name and power limit and the file of
the package that ran:
  - "kernels": K6 (`sqa_int8`) over the large-v3 B=4 cross K/V (4, 20,
    64, 1500), K3 (`sqa_self`) over a (4, 20, 64, 256) bf16 cache and K2
    (`sqa_cross_int8`, int8 and bf16 A.V) over the probe's K/V layout (4,
    20, 64, 1536) with 1500 real columns, and at the probe's batch (24,
    20, 64, 1536) with int8 A.V, all columns in bounds. "warm_ms"
    repeats one layer's tensors, which then stay in the 50 MB L2 (not at
    B=24: 94 MB);
    "cold_ms" goes through the decode step's entries (`sqa_int8_layers`,
    `sqa_self_layers`; K2 has none: its wrapper, layer by layer) over 32
    stacked layers, cycling the layer as a step does, so each call reads
    its K/V from HBM. Both are the kernel's own time under torch.profiler;
    beside them the bound (the bytes over 3.35 TB/s) and the achieved TB/s;
  - with --sweep, "sweep": the same two times for every forced cluster
    size (1, 2, 4, 8, 16) at K6's (4|8, 20, 64, 1500), at K6's and K3's
    (4, 20, 64, 256), (8, 20, 64, 448) and (1, 20, 64, 448) and at K2's
    (4|8|24, 20, 64, 1536), beside the split rule's count (needs a package
    whose wrappers take `splits`; a size whose slices do not fit a CTA's
    shared memory records the launch's error);
  - with --step, "step": five large-v3 B=4 decode steps (random weights,
    int8 weights and cross-KV, 256-column bf16 cache, positions 100-104,
    K3 + K6 through the step entries, as `chip_smoke.py` phase 7 runs
    them): device events, device-busy ms and wall ms per step (the best of
    three synchronised runs), and the host microseconds per call of each
    step entry;
  - with --ablate, "ablate": the two kernels' times in patched copies of
    `csrc/sqa.cu` (built under build/variants/, one nvcc each, all at once)
    that leave one part of the work out, to show where the time goes (their
    outputs are wrong by design): "no_products" (no logits or P.V
    arithmetic), "no_loads" (nothing staged from K or V), "no_exchange"
    (each CTA combines only its own share: no distributed shared memory)
    "empty" (every CTA returns at once: the launch of the clusters) and
    "pv4_only" (P.V reads 4 bytes at a time on 16-byte aligned caches too,
    timed at those caches' shapes), with the shipped kernel before and
    after them; and each exchange alone left local ("no_exchange_one",
    the (max, sum) pairs; "no_wmax_exchange", K2's row maximum of the
    weights; "no_exchange_two", the P.V 64-vectors);
  - with --parent DIR (another checkout, e.g. a parent commit unpacked
    with `git archive`), "runs": this script with the other flags run
    four times, parent / this / this / parent, each in its own process
    with PYTHONPATH naming DIR or this checkout (`in_turns`, which
    `tools/torch_mel_time.py --parent` uses too).

The package is the one PYTHONPATH names, else this checkout's.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.append(str(ROOT))  # this checkout's package, unless PYTHONPATH names another
HBM_BYTES_S = 3.35e12
LAYERS = 32
SWEEP_SPLITS = (1, 2, 4, 8, 16)
SWEEP_SHAPES = (("sqa_int8", 4, 1500), ("sqa_int8", 8, 1500),
                ("sqa_int8", 4, 256), ("sqa_self", 4, 256),
                ("sqa_int8", 8, 448), ("sqa_self", 8, 448),
                ("sqa_int8", 1, 448), ("sqa_self", 1, 448),
                ("sqa_v3", 4, 1536), ("sqa_v3", 8, 1536), ("sqa_v3", 24, 1536))
# in the kernels' names
KERNEL_NAME = {"sqa_int8": "Int8KV", "sqa_self": "Bf16KV", "sqa_v3": "sqa_v3_kernel"}
V3_PADDING = 36  # K2's K/V store 1536 columns, 1500 real (the probe's lane padding)
STEP_ROWS, STEPS, STEP_POS = 4, 5, 100  # the decode-step profile (step_inputs)

# (text in csrc/sqa.cu, what replaces it; every occurrence) per patched copy
ABLATIONS = {
    "no_products": [("for (int u = lane; u < words; u += 32) {",
                     "for (int u = words; u < words; u += 32) {"),
                    ("const int nv = n / kCols;", "const int nv = 0;")],
    "no_loads": [("if (!none) stage_rows(k, b, h, c0, n, k_s, bar_k, p);", ""),
                 ("stage_rows(v, b, h, c0, n, v_s, bar_v, p);", "")],
    "no_exchange": [("cluster.sync();", "__syncthreads();"),
                    ("cluster_arrive_relaxed();", ""), ("cluster_wait();", ""),
                    ("cluster.map_shared_rank(&pair_s[0][0], lane)", "&pair_s[0][0]"),
                    ("cluster.map_shared_rank(wmax_s, lane)", "wmax_s"),
                    ("cluster.map_shared_rank(pv_s, 0)", "pv_s")],
    "no_exchange_one": [("cluster.sync();  // exchange one", "__syncthreads();"),
                        ("cluster.map_shared_rank(&pair_s[0][0], lane)", "&pair_s[0][0]")],
    "no_wmax_exchange": [("cluster.sync();  // the row's largest weight", "__syncthreads();"),
                         ("cluster.map_shared_rank(wmax_s, lane)", "wmax_s")],
    "no_exchange_two": [("cluster.sync();  // exchange two", "__syncthreads();"),
                        ("cluster.map_shared_rank(pv_s, 0)", "pv_s")],
    "empty": [("  const int b = blockIdx.z;\n", "  const int b = blockIdx.z;\n"
               "  if (p.cols > 0) return;\n")],
    "pv4_only": [("p.pv16 = aligned(", "p.pv16 = 0 && aligned(")],
}
ABLATE_SHAPES = (("sqa_int8", 4, 1500), ("sqa_self", 4, 256), ("sqa_v3", 4, 1536))
# caches whose rows start on 16-byte boundaries: P.V reads 16 bytes at a time
PV16_SHAPES = (("sqa_self", 4, 256), ("sqa_int8", 4, 256), ("sqa_int8", 8, 448),
               ("sqa_self", 8, 448))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def device_us(fn, calls: int, name: str | None) -> list:
    """Device microseconds of each kernel whose name holds `name` (of every
    kernel, with `name` None) over `calls` calls of fn(i) under
    torch.profiler, after a warm-up pass. The profiler's activity buffer
    may drop a short kernel's records, now and then all of them: a run that
    saw none is profiled again, twice at most."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(calls):
        fn(i)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(i)
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and (name is None or name in e.name)]
        if us:
            return us
    raise RuntimeError(f"the profiler saw no {name or 'device'} records")


def kernel_ms(fn, calls: int, name: str) -> float:
    """Mean device time of the kernels whose name holds `name` over `calls`
    calls of fn(i)."""
    us = device_us(fn, calls, name)
    return sum(us) / len(us) / 1e3


def host_us_per_call(fn, calls: int) -> float:
    """Host microseconds per call of `calls` back-to-back calls of fn(i) (no
    sync between them: the card's queue holds the launches), best of
    three."""
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(calls):
            fn(i)
        best = min(best, (time.perf_counter() - t) * 1e6 / calls)
        torch.cuda.synchronize()
    return best


def step_inputs(model) -> tuple:
    """The decode-step profile's inputs (STEP_ROWS rows, from a generator
    seeded 5): an int8 cross-KV of random encoder features, an empty
    256-column bf16 cache, a token per row and a (B, 1, H, 64) bf16 query
    for timing the step entries alone. Steps run at positions STEP_POS,
    STEP_POS + 1, ..."""
    from openai_whisper_coreml_tpu_torch.models import decoder as dec_mod

    cfg = model.cfg
    b = STEP_ROWS
    g = torch.Generator(device="cuda").manual_seed(5)
    feats = torch.randn(b, cfg.n_audio_ctx, cfg.n_audio_state, generator=g,
                        device="cuda").bfloat16()
    cross = dec_mod.precompute_cross_kv_int8(model.decoder, feats)
    cache = dec_mod.init_kv_cache(cfg, b, torch.bfloat16, "cuda", ctx=256)
    tok = torch.randint(0, cfg.timestamp_begin, (b, 1), generator=g, device="cuda")
    q = torch.randn(b, 1, cfg.n_text_head, cfg.text_head_dim, generator=g,
                    device="cuda").bfloat16()
    return tok, cross, cache, q


def stacked(kernel: str, b: int, c: int, g: torch.Generator) -> tuple:
    """LAYERS layers of the kernel's K/V: (L, B, 20, 64, C) bf16 K and V,
    or int8 K and V with fp32 (L, B, 20, 1, C) column scales (K6, K2)."""
    from openai_whisper_coreml_tpu_torch.models.decoder import quantize_kv_column

    k, v = (torch.randn(LAYERS, b, 20, 64, c, generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    if kernel == "sqa_self":
        return k, v
    return (*quantize_kv_column(k.float()), *quantize_kv_column(v.float()))


def kv_bytes(kernel: str, b: int, c: int) -> int:
    """Bytes a call must move: K and V (and the scales) once, q in, out."""
    per_col = 2 * 64 * 2 if kernel == "sqa_self" else 2 * 64 + 2 * 4
    return b * 20 * (c * per_col + 2 * 64 * 2)


def time_kernel(kernel: str, b: int, c: int, splits: int | None = None,
                av_int8: bool = True) -> dict:
    """Warm and cold device ms of one kernel at (b, 20, 64, c), bf16 q, all
    columns in bounds (K2: the first c - V3_PADDING, with int8 or bf16
    A.V); `splits` forces a cluster size (None: the rule, and no `splits`
    argument, which an older package does not take)."""
    from openai_whisper_coreml_tpu_torch.ops import sqa_int8 as si
    from openai_whisper_coreml_tpu_torch.ops import sqa_self as ss
    from openai_whisper_coreml_tpu_torch.ops import sqa_v3 as sv

    g = torch.Generator(device="cuda").manual_seed(b * c)
    kv = stacked(kernel, b, c, g)
    q = torch.randn(b, 1, 20, 64, generator=g, device="cuda", dtype=torch.bfloat16)
    extra = {} if splits is None else {"splits": splits}
    name = KERNEL_NAME[kernel]
    row = {"kernel": kernel, "shape": [b, 20, 64, c]}
    if kernel == "sqa_v3":
        cols = c - V3_PADDING
        row.update(s_len=cols, av_int8=av_int8)

        def call(i, layer):
            return sv.sqa_cross_int8(q[:, 0], *(t[layer] for t in kv), s_len=cols,
                                     av_int8=av_int8, **extra)

        warm = kernel_ms(lambda i: call(i, 0), 50, name)
        cold = kernel_ms(lambda i: call(i, i % LAYERS), 2 * LAYERS, name)
    else:
        cols = c
        wrapper, layers = ((ss.sqa_self, ss.sqa_self_layers) if kernel == "sqa_self"
                           else (si.sqa_int8, si.sqa_int8_layers))
        warm = kernel_ms(lambda i: wrapper(q[:, 0], *(t[0] for t in kv), c - 1, 0, **extra),
                         50, name)
        attend = layers(*kv, c - 1, 0, **extra)
        cold = kernel_ms(lambda i: attend(q, i % LAYERS), 2 * LAYERS, name)
    nbytes = kv_bytes(kernel, b, cols)
    bound = nbytes / HBM_BYTES_S * 1e3
    return {**row, "warm_ms": warm, "cold_ms": cold, "bound_ms": bound, "bytes": nbytes,
            "warm_tb_s": nbytes / warm / 1e9, "cold_tb_s": nbytes / cold / 1e9}


def bind_all(lib):
    """`lib` (a build of some sqa.cu) with the C types of K3's, K6's and
    K2's entry points set."""
    from openai_whisper_coreml_tpu_torch.ops import sqa_int8 as si
    from openai_whisper_coreml_tpu_torch.ops import sqa_self as ss
    from openai_whisper_coreml_tpu_torch.ops import sqa_v3 as sv

    return sv.bind(si.bind(ss.bind(lib)))


@contextlib.contextmanager
def launching(lib):
    """The wrappers of K3, K6 and K2 launch `lib`'s kernels inside."""
    from openai_whisper_coreml_tpu_torch.ops import sqa_int8 as si
    from openai_whisper_coreml_tpu_torch.ops import sqa_self as ss
    from openai_whisper_coreml_tpu_torch.ops import sqa_v3 as sv

    shipped = si.load_kernel, ss.load_kernel, sv.load_kernel
    si.load_kernel = ss.load_kernel = sv.load_kernel = lambda: lib
    try:
        yield
    finally:
        si.load_kernel, ss.load_kernel, sv.load_kernel = shipped


def build_variant(variant: str):
    """A patched copy of csrc/sqa.cu, built and bound as K3's, K6's and
    K2's library."""
    from openai_whisper_coreml_tpu_torch.ops import _build

    source = _build.CSRC / "sqa.cu"
    text = source.read_text()
    for old, new in ABLATIONS[variant]:
        if old not in text:
            raise RuntimeError(f"{variant}: {old!r} is not in {source}")
        text = text.replace(old, new)
    name = f"sqa_{variant}"
    path = _build.BUILD_DIR.parent / "variants" / f"{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return bind_all(_build.load_library(name, str(path)))


def ablate() -> list:
    """Each patched copy's warm and cold times, with the shipped kernel's
    before and after them at every shape a copy is timed at."""
    with concurrent.futures.ThreadPoolExecutor(len(ABLATIONS)) as pool:
        libs = dict(zip(ABLATIONS, pool.map(build_variant, ABLATIONS)))
    rows = []

    def timed(variant, shapes):
        for kernel, b, c in shapes:
            row = {"variant": variant, **time_kernel(kernel, b, c)}
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)

    every_shape = ABLATE_SHAPES + tuple(s for s in PV16_SHAPES if s not in ABLATE_SHAPES)
    timed("shipped", every_shape)
    for variant, lib in libs.items():
        with launching(lib):
            timed(variant, PV16_SHAPES if variant == "pv4_only" else ABLATE_SHAPES)
    timed("shipped", every_shape)
    return rows


def in_turns(script: str, parent_dir: str, args=()) -> list:
    """`script` with `args` run four times, parent / this / this / parent,
    each in its own process with PYTHONPATH naming `parent_dir` (another
    checkout, e.g. a parent commit unpacked with `git archive`) or this
    checkout: [{"build": ..., **the JSON of the run's last line}]."""
    runs = []
    for build, root in (("parent", parent_dir), ("this", ROOT), ("this", ROOT),
                        ("parent", parent_dir)):
        env = {**os.environ, "PYTHONPATH": str(Path(root).resolve())}
        proc = subprocess.run([sys.executable, script, *args], env=env, capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{build} run failed:\n{proc.stderr}")
        runs.append({"build": build, **json.loads(proc.stdout.strip().splitlines()[-1])})
        print(json.dumps(runs[-1]), file=sys.stderr, flush=True)
    return runs


def sweep() -> list:
    from openai_whisper_coreml_tpu_torch.ops import sqa_int8 as si

    rows = []
    for kernel, b, c in SWEEP_SHAPES:
        for splits in SWEEP_SPLITS:
            try:
                row = time_kernel(kernel, b, c, splits)
            except RuntimeError as e:  # the slices do not fit a CTA's shared memory
                row = {"kernel": kernel, "shape": [b, 20, 64, c], "error": str(e)}
            row["splits"], row["rule"] = splits, si.split_count(c, b * 20)
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
    return rows


def step() -> dict:
    """STEPS large-v3 B=4 decode steps, K3 + K6 through the step entries."""
    from torch.profiler import ProfilerActivity, profile

    import openai_whisper_coreml_tpu_torch as wt
    from openai_whisper_coreml_tpu_torch.models import decoder as dec_mod
    from openai_whisper_coreml_tpu_torch.ops import sqa_int8 as si
    from openai_whisper_coreml_tpu_torch.ops import sqa_self as ss

    model = wt.load_model("large-v3", dtype=torch.bfloat16, quantize="int8", device="cuda")
    tok, cross, cache, q = step_inputs(model)

    def run():
        for i in range(STEPS):
            dec_mod.decode_step(model.decoder, tok, cross, cache, STEP_POS + i,
                                self_kernel=True)

    walls = []
    run()
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3 / STEPS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    n = model.cfg.n_text_layer
    s_cols = cross[0].shape[-1]
    int8_entry = si.sqa_int8_layers(*cross, s_cols - 1, 0)
    self_entry = ss.sqa_self_layers(cache.k, cache.v, STEP_POS, 0)
    return {"device_events_per_step": len(device) / STEPS,
            "device_busy_ms_per_step":
                sum(e.time_range.elapsed_us() for e in device) / 1e3 / STEPS,
            "wall_ms_per_step": min(walls), "wall_ms_runs": walls,
            "host_us_per_call": {
                "sqa_int8 cross, step entry": host_us_per_call(lambda l: int8_entry(q, l), n),
                "sqa_self, step entry": host_us_per_call(lambda l: self_entry(q, l), n)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true", help="time every forced cluster size")
    ap.add_argument("--step", action="store_true", help="profile the large-v3 decode step")
    ap.add_argument("--ablate", action="store_true",
                    help="time patched copies of the kernel's source")
    ap.add_argument("--parent", metavar="DIR",
                    help="time another checkout in turns with this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sqa_time: no CUDA device", file=sys.stderr)
        return 1
    if args.parent:
        flags = [f"--{f}" for f in ("sweep", "step", "ablate") if getattr(args, f)]
        print(json.dumps({"card": card(), "runs": in_turns(__file__, args.parent, flags)}),
              flush=True)
        return 0
    import openai_whisper_coreml_tpu_torch as wt
    from openai_whisper_coreml_tpu_torch.ops import sqa_int8 as si

    result = {"card": card(), "package": wt.__file__,
              "kernels": [time_kernel("sqa_int8", 4, 1500), time_kernel("sqa_self", 4, 256),
                          time_kernel("sqa_v3", 4, 1536),
                          time_kernel("sqa_v3", 4, 1536, av_int8=False),
                          time_kernel("sqa_v3", 24, 1536)]}
    if args.sweep:
        if "splits" not in inspect.signature(si.sqa_int8).parameters:
            raise SystemExit("this package's kernels take no split count")
        result["sweep"] = sweep()
    if args.ablate:
        result["ablate"] = ablate()
    if args.step:
        result["step"] = step()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
