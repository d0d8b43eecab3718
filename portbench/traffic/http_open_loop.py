"""Independent users posting clips to the HTTP server, in an open loop.

A `WhisperHTTPServer` runs in this process on a free port with the cell's
`batch_size`, `batch_window_ms` and decoding options as its defaults. A
child process (`lib/http_client.py`) posts `rate` x `--seconds` clips to
`POST /transcribe` on a fixed schedule: Poisson arrivals whose gaps, and
clip lengths (log-normal, `duration_s`), are the same for every seed in
an order drawn from it. Each request is timed from when it was due to
when its whole answer was read; one that failed or never came counts at
the time the client waited for it, above every answer. `latency_p95_s`
is the nearest-rank 95th percentile over every request due in the
window. A traced run profiles `trace_seconds` from the middle of the
schedule."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

from portbench.lib import signals
from portbench.lib.cell import Ctx, Outcome, rng, stratified_gaps, stratified_lognormal
from portbench.lib.readers import Record
from portbench.lib.spec import HERE
from portbench.lib.trace import traced_slice


def schedule(ctx: Ctx):
    """(due offsets in s, clip lengths in samples) of the window's requests."""
    p = ctx.params
    n = max(1, round(p["rate"] * ctx.seconds))
    gaps = stratified_gaps(n, ctx.seconds, rng(ctx.seed, 3))
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    dur = p["duration_s"]
    secs = stratified_lognormal(n, dur["median"], dur["sigma"], dur["min"], dur["max"],
                                rng(ctx.seed, 4))
    return due.tolist(), [int(round(s * signals.SAMPLE_RATE)) for s in secs]


def setup(ctx: Ctx):
    from openai_whisper_coreml_tpu_torch.serve import ServeOptions, transcribe_batch
    from openai_whisper_coreml_tpu_torch.serve_http import WhisperHTTPServer

    p = ctx.params
    server = WhisperHTTPServer(ctx.model, port=0, batch_size=p["batch_size"],
                               batch_window_ms=p["batch_window_ms"],
                               default_options=ctx.cell["options"])
    server.start()
    state = {"server": server, "proc": None}
    try:
        due, samples = schedule(ctx)
        state.update(due=due, samples=samples)
        warm = ServeOptions(**server.batch_options({"sample_len": p["warmup_sample_len"]}))
        for b in p["warmup_batches"]:
            clips = [signals.speechy_np(samples[i % len(samples)], ctx.seed, i)
                     for i in range(b)]
            transcribe_batch(ctx.model, clips, warm)
        _one_request(server.port, signals.speechy_np(samples[0], ctx.seed, 0))
        proc = subprocess.Popen([sys.executable, str(HERE / "lib" / "http_client.py")],
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        state["proc"] = proc
        proc.stdin.write(json.dumps({"port": server.port, "seed": ctx.seed, "due": due,
                                     "samples": samples, "timeout": p["wait_s"]}) + "\n")
        proc.stdin.flush()
        if proc.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
    except BaseException:
        _close(state)
        raise
    return state


def _one_request(port: int, audio) -> None:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/transcribe", body=audio.tobytes(), headers={"X-Raw-Audio": "1"})
        resp = conn.getresponse()
        resp.read()
        if resp.status != 200:
            raise RuntimeError(f"warm-up request answered {resp.status}")
    finally:
        conn.close()


def _close(state) -> None:
    proc = state.get("proc")
    if proc is not None:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        for f in (proc.stdin, proc.stdout):
            if f is not None:
                f.close()
    state["server"].stop()


def p95_nearest_rank(latencies) -> float:
    ordered = sorted(latencies)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def window(ctx: Ctx, state) -> Outcome:
    server, proc = state["server"], state["proc"]
    p = ctx.params
    try:
        c0 = {k: server.metrics.counter(k) for k in ("requests_total", "batches_total")}
        proc.stdin.write("go\n")
        proc.stdin.flush()
        line = proc.stdout.readline().split()
        if len(line) != 2 or line[0] != "t0":
            raise RuntimeError("the load generator did not start its schedule")
        t0 = float(line[1])
        traced = []
        if ctx.trace and ctx.device.type == "cuda":
            start = t0 + ctx.seconds / 2 - p["trace_seconds"] / 2
            time.sleep(max(0.0, start - time.monotonic()))
            with traced_slice(ctx.device, traced):
                time.sleep(p["trace_seconds"])
        out = json.loads(proc.stdout.readline())
        proc.wait(timeout=60)
        c1 = {k: server.metrics.counter(k) for k in c0}
    except BaseException:
        _close(state)
        raise
    reqs = out["requests"]
    lat, late = [], []
    for r in reqs:
        ok = r["status"] == 200 and r["done"] is not None
        lat.append(r["done"] - r["due"] if ok else out["end"] - r["due"])
        if r["sent"] is not None:
            late.append(r["sent"] - r["due"])
    late.sort()
    ctx.log(f"load generator lateness: max {late[-1] * 1e3:.2f} ms, p99 "
            f"{late[max(0, math.ceil(0.99 * len(late)) - 1)] * 1e3:.2f} ms over {len(late)} sends")
    failed = sum(1 for r in reqs if r["status"] != 200)
    if failed:
        errors = sorted({str(r.get("error") or r["status"]) for r in reqs if r["status"] != 200})
        ctx.log(f"{failed} requests failed: {errors[:5]}")
    samples = state["samples"]
    answers = [{"n": samples[i], "audio": (lambda i=i: signals.speechy_np(
        samples[i], ctx.seed, i)), "result": r["result"]} for i, r in enumerate(reqs)]
    span = out["end"] - t0
    ctx.log(f"{len(reqs)} requests due over {ctx.seconds:g} s, all answered "
            f"{span:.3f} s after the first was due; median latency "
            f"{sorted(lat)[len(lat) // 2]:.3f} s")
    record = None
    if traced:
        record = Record(ctx.dims, traced[0],
                        window_counters={k: c1[k] - c0[k] for k in c0},
                        decode={"prompt_len": 4, "sample_len": ctx.cell["options"]["sample_len"]})
    return Outcome(attempted=len(reqs), failed=failed,
                   e2e={"latency_p95_s": p95_nearest_rank(lat)}, answers=answers,
                   kind="transcripts", record=record, close=lambda: _close(state),
                   extra={"latencies": lat, "span_s": span, "lateness": late})
