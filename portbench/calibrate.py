"""The readings that a cell's limits are set from: the program's numbers
over many seeds, and the control's (the reference at 4 bits in the
program's place) on some of them, in one process.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds 11,12,... --control-seeds 11,12,13

Each seed runs the cell as `run.py` does (its own weights, inputs, set-up
and a window of `--seconds`, without a trace), then has the configuration's
family judge what it served; on a control seed the control's gap is read
on the same prompts and tokens (`served_gap`'s for `v3-decode-b128` and
the transcription cells, `lang_gap`'s for `v3-langid`). One JSON line a
seed, then the largest of each number over the seeds and the smallest
control gap."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx, out, _, _ = run.serve_cell(args.workload, seed, args.seconds, False, device)
        checks = run.judge_outcome(ctx, out, run.served_dtype(device), control=seed in controls)
        row = {"seed": seed, "attempted": out.attempted, "failed": out.failed,
               **{k: c["value"] for k, c in checks.items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del ctx, out
        torch.cuda.empty_cache()
    keys = [k for k in rows[0] if k not in ("seed", "attempted", "failed", "control_gap")]
    summary = {f"max_{k}": max(r[k] for r in rows) for k in keys}
    ctl = [r["control_gap"] for r in rows if "control_gap" in r]
    if ctl:
        summary["min_control_gap"] = min(ctl)
    print(json.dumps({"workload": args.workload, "seeds": len(rows), **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
