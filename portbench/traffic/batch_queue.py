"""Offline batch transcription in a closed loop: a queue of recordings
drained through `serve.transcribe_batch` in calls of exactly
`windows_per_call` 30 s windows, one call after another.

Recording lengths are a deck of `deck` log-normal quantiles (`duration_s`)
in an order drawn from the seed. The queue is cut into calls: a recording
that does not fit a call is cut at a 30 s window boundary and its rest
opens the next call. `pool_calls` such calls are made in set-up, on the
card, and the window drives them in turn, again from the first when it
has used them all. The window opens when the first call starts and closes
at the end of the first call that ends after `--seconds`; `rtfx` is the
audio seconds of every piece transcribed in it over its length. A traced
run profiles the window's second call whole."""

from __future__ import annotations

import time

from portbench.lib import signals
from portbench.lib.cell import Ctx, Outcome, rng, stratified_lognormal
from portbench.lib.readers import Record
from portbench.lib.trace import traced_slice

SAMPLES_PER_WINDOW = 480_000


def plan_calls(durations_s, windows_per_call: int, n_calls: int):
    """[(recording, first sample, samples)] per call, in queue order."""
    calls, cur, room = [], [], windows_per_call
    for rec, dur in enumerate(durations_s):
        n = int(round(dur * signals.SAMPLE_RATE))
        start = 0
        while start < n:
            take_windows = min(room, -(-(n - start) // SAMPLES_PER_WINDOW))
            take = min(n - start, take_windows * SAMPLES_PER_WINDOW)
            cur.append((rec, start, take))
            start += take
            room -= take_windows
            if room == 0:
                calls.append(cur)
                if len(calls) == n_calls:
                    return calls
                cur, room = [], windows_per_call
    raise ValueError(f"the deck of {len(durations_s)} recordings fills fewer than "
                     f"{n_calls} calls of {windows_per_call} windows")


def setup(ctx: Ctx):
    import torch

    from openai_whisper_coreml_tpu_torch.serve import ServeOptions

    p = ctx.params
    dur = p["duration_s"]
    durations = stratified_lognormal(p["deck"], dur["median"], dur["sigma"], dur["min"],
                                     dur["max"], rng(ctx.seed, 1))
    plan = plan_calls(durations, p["windows_per_call"], p["pool_calls"])
    needed = sorted({rec for call in plan for rec, _, _ in call})
    audio = {}
    for rec in needed:
        n = int(round(durations[rec] * signals.SAMPLE_RATE))
        audio[rec] = signals.speechy_torch(n, ctx.seed, rec, ctx.device).cpu().numpy()
    pool = [[audio[rec][a:a + n] for rec, a, n in call] for call in plan]
    options = ServeOptions(**ctx.cell["options"])
    warm = ServeOptions(**{**ctx.cell["options"], "sample_len": p["warmup_sample_len"]})
    from openai_whisper_coreml_tpu_torch.serve import transcribe_batch

    transcribe_batch(ctx.model, pool[0], warm)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return {"pool": pool, "options": options}


def window(ctx: Ctx, state) -> Outcome:
    import torch

    from openai_whisper_coreml_tpu_torch.ops import sqa_self
    from openai_whisper_coreml_tpu_torch.serve import transcribe_batch

    pool, options = state["pool"], state["options"]
    cuda = ctx.device.type == "cuda"
    traced, k3 = [], 0
    answers, audio_s, calls = [], 0.0, 0
    t_open = time.perf_counter()
    while True:
        pieces = pool[calls % len(pool)]
        t0 = time.perf_counter()
        if ctx.trace and calls == 1 and cuda:
            k3_0 = sqa_self.launches
            with traced_slice(ctx.device, traced):
                results = transcribe_batch(ctx.model, pieces, options)
            k3 = sqa_self.launches - k3_0
        else:
            results = transcribe_batch(ctx.model, pieces, options)
        if cuda:
            torch.cuda.synchronize(ctx.device)
        t1 = time.perf_counter()
        calls += 1
        secs = sum(len(a) for a in pieces) / signals.SAMPLE_RATE
        audio_s += secs
        answers += [{"audio": a, "result": r} for a, r in zip(pieces, results)]
        ctx.log(f"call {calls}: {len(pieces)} pieces, {secs:.1f} audio s, "
                f"{t1 - t0:.3f} s")
        # a traced run closes after its traced slice
        if t1 - t_open >= ctx.seconds and (traced or not (ctx.trace and cuda)):
            break
    window_s = t1 - t_open
    record = None
    if traced:
        per_call = ctx.params["windows_per_call"]
        steps = k3 / ctx.dims["n_text_layer"]
        ctx.log(f"traced call: {steps:g} single-token steps for {per_call} windows in "
                f"decode batches of {options.batch_size} at sample_len {options.sample_len}")
        record = Record(ctx.dims, traced[0], counters={"k3_launches": k3},
                        decode={"prompt_len": 4, "sample_len": options.sample_len},
                        windows=per_call)
    return Outcome(attempted=len(answers), failed=sum(a["result"] is None for a in answers),
                   e2e={"rtfx": audio_s / window_s}, answers=answers, kind="transcripts",
                   record=record)
