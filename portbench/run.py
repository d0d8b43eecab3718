"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json; its file
`portbench/workloads/<cell>.json` names the configuration
(`portbench/configs/<config>.json`), the traffic kind
(`portbench/traffic/<kind>.py`), the traffic's parameters, the decoding
options and the limits of the comparison. The configuration's `family`
(`portbench/families/<family>.py`) makes the weights on the card from the
seed and builds the program from them; the run makes the inputs and warms
the cell's shapes (set-up), drives the entry for `--seconds` (the window),
reads the memory peak, frees the program, and has the family judge what it
served with its plain reference (`portbench/reference/`). With `--trace 0` the result
holds the cell's end-to-end metrics, with `--trace 1` its per-layer ones
(`portbench/metrics/<metric>.py`) read from a traced slice. The last line
of standard output is the result; the numbers compared, each with its
limit, are the last lines of standard error and the result's last key."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import families  # noqa: E402
from portbench.lib import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "openai_whisper_coreml_tpu")


def forbidden_modules() -> list:
    """Top-level names in sys.modules that this process must not hold."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def build_program(config: dict, seed: int, device):
    """The configuration's sizes, and the program that its family builds
    from the weights of `seed` on `device` (the weights themselves freed)."""
    family = families.of(config)
    d = family.dims(config)
    params = family.make_params(d, seed, device, served_dtype(device))
    model = family.program(config, d, params)
    del params
    return d, model


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def judge_outcome(ctx, out, dtype, control: bool = False) -> dict:
    """The numbers compared, each {"value", "limit"}, as the family of the
    cell's configuration reads them after the program is freed; with
    `control`, also `control_gap` (no limit)."""
    return families.of(ctx.config).judge(ctx, out, dtype, control)


def serve_cell(name: str, seed: int, seconds: float, trace: bool, device, *,
               cell: dict = None, config: dict = None, t_start: float = None):
    """Set-up and window of one run, then the program freed: (ctx, outcome,
    setup_s, memory peak). `cell` and `config` stand in for the cell's
    files (tests)."""
    import torch

    from portbench.lib.cell import Ctx

    t_start = T_START if t_start is None else t_start
    cell = cell or spec.cell_file(name)
    config = config or spec.config_file(cell["config"])
    cuda = device.type == "cuda"
    d, model = build_program(config, seed, device)
    ctx = Ctx(cell=cell, config=config, dims=d, cfg=model.cfg, seed=seed, seconds=seconds,
              trace=trace, device=device, model=model)
    kind = importlib.import_module(f"portbench.traffic.{cell['traffic']}")
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        state = kind.setup(ctx)
        setup_s = time.perf_counter() - t_start
        out = kind.window(ctx, state)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    out.close()
    del state, model
    ctx.model = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return ctx, out, setup_s, peak


def served_dtype(device):
    import torch

    return torch.bfloat16 if device.type == "cuda" else torch.float32


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, bench: dict, *,
             cell: dict = None, config: dict = None, t_start: float = None) -> dict:
    """One run of cell `name` on `device`; the result line as a dict."""
    import torch

    from portbench.lib import readers, trace as tr

    ctx, out, setup_s, peak = serve_cell(name, seed, seconds, trace, device, cell=cell,
                                         config=config, t_start=t_start)
    cuda = device.type == "cuda"
    checks = judge_outcome(ctx, out, served_dtype(device))
    correct = out.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    if trace:
        for m in spec.metrics_for(bench, "per_layer", name):
            value = readers.load_reader(m["name"])(out.record) if out.record else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out.e2e, setup_s=setup_s)
        for m in spec.metrics_for(bench, "end_to_end", name):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace and out.record is not None and out.record.slice is not None:
        s = out.record.slice
        dev.update(busy_s=s.busy_s, window_s=s.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(s), "idle_gaps": tr.idle_gaps(s)}
        ctx.log(f"traced slice: {s.window_s:.6f} s on the device clock, {s.host_s:.6f} s on "
                f"the host's, busy {s.busy_s:.6f} s, {len(s.kernels)} kernels, "
                f"{s.launches} launches")
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's tokenizer on its byte-level vocabulary (the checkout
    # holds none), its logs at their default level
    os.environ.pop("WHISPER_TPU_VOCAB", None)
    os.environ["WHISPER_TPU_LOG_LEVEL"] = "INFO"

    bench = spec.benchmark()
    entry = spec.workload_entry(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device, bench)
    result["device"]["power_limit"] = power_limit()
    print(f"[{args.workload}] card: {result['device']['power_limit']}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"[{args.workload}] this process loaded {found}: no result", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
