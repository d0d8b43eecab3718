"""Speculative-decoding kinetics of the PyTorch port on one NVIDIA GPU: the
iteration cost that `speculative._KINETICS` holds as the governor's prior.

    python3 tools/torch_spec_time.py [--batches 1,8,16,24,32] [--ks 4,8]
        [--sample-len 64] [--repeats 3] [--out spec_time.json]

Builds large-v3 (int8 weights, bf16 activations, seed 0) and a
large-v3-turbo draft of the same kind (seed 1), encodes a batch of 30 s
noise windows once per batch size (the draft shares the target's features,
as the turbo pairing does), and decodes them through `decoding.decode`
with int8 cross-KV, language "en", greedy, `--sample-len` tokens: plainly,
and speculatively at each K. Each wall is the one decode publishes for the
governor (`speculative.LAST_TIMING`: the decode core, ending once the
tokens are on the host), divided by its units: tokens of the slowest row
(plain) or its iterations (speculative). The timed runs alternate plain
and each K, after a warm-up of each; the median of `--repeats` is kept.

With random weights the draft sits at the acceptance floor, which leaves
the iteration cost as it is (K+1 draft steps and one verify step whatever
is accepted) and gives the floor's tokens per iteration. Per batch it also
takes one speculative decode at the first K and one plain decode under
torch.profiler: device-busy ms per iteration and per plain step, and their
share of the unprofiled walls.

Prints one JSON line per batch, then one line with the fit that becomes
`_KINETICS`: per batch (iter_ms_base, iter_ms_per_k, plain_ms_per_token),
the line through the first two K's ms/iteration, and the break-even
tokens per iteration at each K; the card's name and power limit ride on
every line. The package is whichever `import openai_whisper_coreml_tpu_torch`
finds (PYTHONPATH picks a checkout).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def load_pair():
    """large-v3 int8 and its large-v3-turbo draft (seed 1), on the card."""
    import openai_whisper_coreml_tpu_torch as wt

    model = wt.load_model("large-v3", dtype=torch.bfloat16, quantize="int8",
                          device="cuda")
    draft = wt.load_model("large-v3-turbo", dtype=torch.bfloat16, quantize="int8",
                          seed=1, device="cuda")
    wt.check_pair(model.cfg, draft.cfg)
    return model, draft


def features(model, batch: int, seed: int = 0) -> torch.Tensor:
    audio = (np.random.default_rng(seed).standard_normal((batch, 480_000)) * 0.1
             ).astype(np.float32)
    return model.encode(model.log_mel(audio))


def timed_decode(model, feats, sample_len: int, k: int | None, draft=None):
    """One decode; returns (LAST_TIMING, LAST_STATS or None, results)."""
    from openai_whisper_coreml_tpu_torch import decoding, speculative

    opts = decoding.DecodingOptions(language="en", kv_dtype="int8",
                                    sample_len=sample_len, spec_k=k or 4)
    speculative.LAST_STATS = None
    results = decoding.decode(model, feats, opts, from_features=True,
                              draft=draft if k else None)
    timing = dict(speculative.LAST_TIMING)
    return timing, (dict(speculative.LAST_STATS) if k else None), results


def ms_per_unit(timing: dict) -> float:
    return timing["wall_s"] * 1e3 / timing["units"]


def device_busy_ms(fn) -> tuple:
    """(device-busy ms, device events) of fn() under torch.profiler: the
    kernels and copies on the card, summed (one stream: they do not
    overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in events) / 1e3, len(events), out


def measure_batch(model, draft, batch: int, ks, sample_len: int,
                  repeats: int) -> dict:
    """ms/token of the plain loop, ms/iteration and the floor's tokens per
    iteration at each K, and the device-busy share of both, at one batch."""
    feats = features(model, batch)
    configs = [None] + list(ks)
    for k in configs:  # warm-up: the kernels build, the allocator settles
        timed_decode(model, feats, 8, k, draft)
    walls = {k: [] for k in configs}
    stats = {}
    for _ in range(repeats):
        for k in configs:
            timing, st, _ = timed_decode(model, feats, sample_len, k, draft)
            walls[k].append(ms_per_unit(timing))
            if k:
                stats[k] = st
    plain_ms = statistics.median(walls[None])
    out = {"batch": batch, "sample_len": sample_len,
           "plain_ms_per_token": plain_ms, "plain_ms_runs": walls[None],
           "spec": {}}
    for k in ks:
        iter_ms = statistics.median(walls[k])
        out["spec"][str(k)] = {
            "ms_per_iter": iter_ms, "ms_runs": walls[k],
            "break_even_tokens_per_iter": iter_ms / plain_ms,
            "floor_tokens_per_iter": stats[k]["tokens_per_iter"],
            "floor_acceptance_rate": stats[k]["acceptance_rate"]}
    k0 = ks[0]
    busy, n_events, (timing, st, _) = device_busy_ms(
        lambda: timed_decode(model, feats, sample_len, k0, draft))
    out["spec"][str(k0)]["device_busy_ms_per_iter"] = busy / timing["units"]
    out["spec"][str(k0)]["device_events_per_iter"] = n_events / timing["units"]
    out["spec"][str(k0)]["device_busy_share"] = (
        busy / timing["units"] / out["spec"][str(k0)]["ms_per_iter"])
    busy, n_events, (timing, _, _) = device_busy_ms(
        lambda: timed_decode(model, feats, sample_len, None))
    out["plain_device_busy_ms_per_token"] = busy / timing["units"]
    out["plain_device_events_per_token"] = n_events / timing["units"]
    out["plain_device_busy_share"] = busy / timing["units"] / plain_ms
    return out


def fit(rows: list, ks) -> dict:
    """Per batch (iter_ms_base, iter_ms_per_k, plain_ms_per_token): the line
    through the first two K's ms/iteration."""
    k1, k2 = ks[0], ks[1]
    table = {}
    for r in rows:
        i1, i2 = r["spec"][str(k1)]["ms_per_iter"], r["spec"][str(k2)]["ms_per_iter"]
        slope = (i2 - i1) / (k2 - k1)
        table[r["batch"]] = (i1 - slope * k1, slope, r["plain_ms_per_token"])
    return table


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batches", default="1,8,16,24,32")
    parser.add_argument("--ks", default="4,8")
    parser.add_argument("--sample-len", type=int, default=64)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--out", default=None,
                        help="also write every line, as a JSON list, here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_spec_time: no CUDA device", file=sys.stderr)
        return 1
    batches = [int(b) for b in args.batches.split(",")]
    ks = [int(k) for k in args.ks.split(",")]
    if len(ks) < 2:
        parser.error("--ks needs two K values for the fit")
    name = card()
    model, draft = load_pair()
    lines = []
    for b in batches:
        row = measure_batch(model, draft, b, ks, args.sample_len, args.repeats)
        row["card"] = name
        lines.append(row)
        print(json.dumps(row), flush=True)
    table = fit(lines, ks)
    summary = {"kinetics": {str(b): list(v) for b, v in table.items()},
               "break_even": {str(b): {str(k): (v[0] + v[1] * k) / v[2] for k in ks}
                              for b, v in table.items()},
               "card": name}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
