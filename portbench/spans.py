"""Device time and idle gaps of a language-ID cell by the program's spans:
a plain traced slice and a spanned one (`lib/spans.py`) over as many
calls, one after the other, on one model.

    python3 portbench/spans.py --workload v3-langid --seed 1 --repeat 2

The cell's set-up runs as in `run.py` (weights from the seed, the pool of
audio, one warm call). Each repeat takes a plain slice over the cell's
`traced_calls` calls (`trace.traced_slice`, CUDA activity only, as a
traced run takes it), then a spanned slice over the next as many (CPU and
CUDA activity, the program's spans on), and prints one line: the seven
span readings (`spans.SPAN_METRICS`, `langid.unspanned_share`), device
seconds by innermost span, the idle gaps by span, the device time by
outermost span against the spanned slice's busy time, and both slices'
host seconds (their difference is what the CPU activity and the spans
cost). A program without `spans_on` exits with 3."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run  # noqa: E402
from portbench.lib import spans as sp  # noqa: E402
from portbench.lib import spec, trace  # noqa: E402
from portbench.lib.cell import Ctx  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="v3-langid")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    from openai_whisper_coreml_tpu_torch.utils import profiling

    from portbench.traffic import langid_batches as kind

    if not torch.cuda.is_available():
        print("spans needs a CUDA device", file=sys.stderr)
        return 3
    spans_on = getattr(profiling, "spans_on", None)
    if spans_on is None:
        print("this program has no spans (utils.profiling.spans_on)", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = spec.cell_file(args.workload)
    if cell["traffic"] != "langid_batches":
        print(f"{args.workload} is no language-ID cell", file=sys.stderr)
        return 2
    config = spec.config_file(cell["config"])
    d, model = run.build_program(config, args.seed, device)
    ctx = Ctx(cell=cell, config=config, dims=d, cfg=model.cfg, seed=args.seed, seconds=0.0,
              trace=True, device=device, model=model)
    n = ctx.params["traced_calls"]
    windows = n * ctx.params["windows_per_call"]
    with torch.no_grad():
        pool = kind.setup(ctx)["pool"]

        def calls(first):
            for j in range(n):
                kind._call(ctx, pool[(first + j) % len(pool)])

        for r in range(args.repeat):
            plain, spanned = [], []
            with trace.traced_slice(device, plain):
                calls(0)
            with sp.spanned_slice(device, spanned, spans_on):
                calls(n)
            p, ss = plain[0], spanned[0]
            tops = sp.top_level_seconds(ss)
            row = {
                "repeat": r, "windows": windows,
                "metrics": sp.readings(ss, windows),
                "device_spans": sp.device_spans(ss),
                "idle_gaps_by_span": sp.idle_gaps_by_span(ss),
                "top_level_s": tops, "top_level_sum_s": sum(tops.values()),
                "spanned": {"busy_s": ss.slice.busy_s, "window_s": ss.slice.window_s,
                            "host_s": ss.slice.host_s, "spans": len(ss.spans)},
                "plain": {"busy_s": p.busy_s, "window_s": p.window_s, "host_s": p.host_s,
                          "device_ms_per_window": 1e3 * p.busy_s / windows},
                "span_ops": sp.span_ops(ss),
            }
            print(json.dumps(row), flush=True)
    print(f"card: {run.power_limit()}", flush=True)
    found = run.forbidden_modules()
    if found:
        print(f"this process loaded {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
