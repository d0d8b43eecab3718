"""Batched decoding in a closed loop: calls of `windows_per_call` 30 s
windows, one after another; each call moves its audio to the card,
computes the log-mel there (K4) and decodes every window to its answer
with `decoding.decode` under the cell's `options`: the encoder, the
cross-KV and the greedy loop over one batch of all the call's windows. No
reassembly, server, gate or repair round.

`pool_calls` batches of audio are made in set-up, on the card, and held
on the host; the window drives them in turn. Set-up warms one call at
`warmup_sample_len` tokens. The window opens when the first call starts
and closes at the end of the first call that ends after `--seconds`;
`decode_rtfx` is the audio seconds of every window decoded over its
length. A traced run profiles the window's second call whole and counts
its K3 launches (one a decoder layer a single-token step)."""

from __future__ import annotations

import dataclasses
import time

from portbench.lib import signals
from portbench.lib.cell import Ctx, Outcome
from portbench.lib.readers import Record
from portbench.lib.trace import traced_slice

SAMPLES_PER_WINDOW = 480_000


def setup(ctx: Ctx):
    import torch

    from openai_whisper_coreml_tpu_torch.decoding import DecodingOptions

    p = ctx.params
    n = p["windows_per_call"]
    pool = []
    for c in range(p["pool_calls"]):
        batch = [signals.speechy_torch(SAMPLES_PER_WINDOW, ctx.seed, c * n + i, ctx.device)
                 for i in range(n)]
        pool.append(torch.stack(batch).cpu().numpy())
    options = DecodingOptions(**ctx.cell["options"])
    _call(ctx, pool[0], dataclasses.replace(options, sample_len=p["warmup_sample_len"]))
    return {"pool": pool, "options": options}


def _call(ctx: Ctx, audio, options):
    import torch

    from openai_whisper_coreml_tpu_torch.audio import log_mel_spectrogram
    from openai_whisper_coreml_tpu_torch.decoding import decode

    mel = log_mel_spectrogram(torch.from_numpy(audio).to(ctx.device), n_mels=ctx.cfg.n_mels)
    results = decode(ctx.model, mel, options)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return results


def window(ctx: Ctx, state) -> Outcome:
    from openai_whisper_coreml_tpu_torch.ops import sqa_self

    pool, options = state["pool"], state["options"]
    per = ctx.params["windows_per_call"]
    cuda = ctx.device.type == "cuda"
    traced, k3 = [], 0
    answers, missing, calls = [], 0, 0
    t_open = time.perf_counter()
    while True:
        audio = pool[calls % len(pool)]
        t0 = time.perf_counter()
        if ctx.trace and cuda and calls == 1:
            k3_0 = sqa_self.launches
            with traced_slice(ctx.device, traced):
                results = _call(ctx, audio, options)
            k3 = sqa_self.launches - k3_0
        else:
            results = _call(ctx, audio, options)
        t1 = time.perf_counter()
        calls += 1
        missing += per - len(results)
        answers += [{"audio": audio[i], "tokens": r.tokens} for i, r in enumerate(results)]
        answers += [{"audio": audio[i], "tokens": None} for i in range(len(results), per)]
        distinct = len({tuple(r.tokens) for r in results})
        ctx.log(f"call {calls}: {len(results)} of {per} windows ({distinct} distinct answers), "
                f"{t1 - t0:.3f} s")
        # a traced run closes after its traced slice
        if t1 - t_open >= ctx.seconds and (traced or not (ctx.trace and cuda)):
            break
    window_s = t1 - t_open
    record = None
    if traced:
        steps = k3 / ctx.dims["n_text_layer"]
        ctx.log(f"traced call: {steps:g} single-token steps for {per} windows at "
                f"sample_len {options.sample_len}")
        record = Record(ctx.dims, traced[0], counters={"k3_launches": k3},
                        decode={"prompt_len": 4, "sample_len": options.sample_len},
                        windows=per)
    return Outcome(attempted=calls * per, failed=missing,
                   e2e={"decode_rtfx": (calls * per - missing) * 30.0 / window_s},
                   answers=answers, kind="windows", record=record)
