"""The knee of an open-loop HTTP cell: its schedule at a series of fixed
rates against one model in one process, read as latency against rate.

    python3 portbench/sweep.py --workload turbo-online-short --seconds 20 \\
        --seed 1 --rates 8,12,16,20,24

For each rate the cell's server, warm-up and load generator run as in
`run.py` (the cell's file with `rate` replaced), and one line gives the
requests due and answered, the median and 95th percentile latency, the
answered requests per second from the first due to the last answer, and
the median latency of the schedule's last quarter over its first (a
backlog that grows through the run reads well above 1). The knee is the
highest rate whose answers keep up with the arrivals without a growing
backlog; the cell runs at four fifths of it."""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run  # noqa: E402
from portbench.lib import spec  # noqa: E402
from portbench.lib.cell import Ctx  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="turbo-online-short")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    import torch

    from portbench.traffic import http_open_loop as kind

    if not torch.cuda.is_available():
        print("sweep needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = spec.cell_file(args.workload)
    config = spec.config_file(cell["config"])
    d, model = run.build_program(config, args.seed, device)
    for rate in (float(r) for r in args.rates.split(",")):
        c = copy.deepcopy(cell)
        c["params"]["rate"] = rate
        ctx = Ctx(cell=c, config=config, dims=d, cfg=model.cfg, seed=args.seed,
                  seconds=args.seconds, trace=False, device=device, model=model)
        with torch.no_grad():
            state = kind.setup(ctx)
            out = kind.window(ctx, state)
        out.close()
        lat = out.extra["latencies"]
        q = max(1, len(lat) // 4)
        row = {"rate": rate, "due": out.attempted, "failed": out.failed,
               "p50_s": statistics.median(lat), "p95_s": out.e2e["latency_p95_s"],
               "answered_per_s": (out.attempted - out.failed) / out.extra["span_s"],
               "last_over_first_quarter": statistics.median(lat[-q:]) / statistics.median(lat[:q]),
               "late_max_ms": 1e3 * max(out.extra["lateness"])}
        print(json.dumps(row), flush=True)
    print(f"card: {run.power_limit()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
