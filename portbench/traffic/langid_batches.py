"""Language identification in a closed loop: calls of `windows_per_call`
30 s windows, one after another; each call moves its audio to the card,
computes the log-mel there (K4) and runs `decoding.detect_language` on it.

`pool_calls` batches of audio are made in set-up, on the card, and held
on the host; the window drives them in turn. The window opens when the
first call starts and closes at the end of the first call that ends after
`--seconds`; `langid_rtfx` is the audio seconds identified over its
length. A traced run profiles `traced_calls` calls from the window's
second on."""

from __future__ import annotations

import time

from portbench.lib import signals
from portbench.lib.cell import Ctx, Outcome, rng
from portbench.lib.readers import Record
from portbench.lib.trace import traced_slice

SAMPLES_PER_WINDOW = 480_000


def setup(ctx: Ctx):
    import torch

    p = ctx.params
    n = p["windows_per_call"]
    pool = []
    for c in range(p["pool_calls"]):
        batch = [signals.speechy_torch(SAMPLES_PER_WINDOW, ctx.seed, c * n + i, ctx.device)
                 for i in range(n)]
        pool.append(torch.stack(batch).cpu().numpy())
    state = {"pool": pool}
    _call(ctx, pool[0])
    return state


def _call(ctx: Ctx, audio):
    import torch

    from openai_whisper_coreml_tpu_torch.audio import log_mel_spectrogram
    from openai_whisper_coreml_tpu_torch.decoding import detect_language

    mel = log_mel_spectrogram(torch.from_numpy(audio).to(ctx.device), n_mels=ctx.cfg.n_mels)
    return detect_language(ctx.model, mel)


def window(ctx: Ctx, state) -> Outcome:
    pool = state["pool"]
    per = ctx.params["windows_per_call"]
    n_traced = ctx.params["traced_calls"]
    cuda = ctx.device.type == "cuda"
    traced, done = [], []
    calls = 0
    t_open = time.perf_counter()
    while True:
        audio = pool[calls % len(pool)]
        t0 = time.perf_counter()
        if ctx.trace and cuda and calls == 1:
            with traced_slice(ctx.device, traced):
                for j in range(n_traced):
                    done.append((calls + j, _call(ctx, pool[(calls + j) % len(pool)])))
            calls += n_traced
        else:
            done.append((calls, _call(ctx, audio)))
            calls += 1
        t1 = time.perf_counter()
        ctx.log(f"calls {len(done)}: {t1 - t0:.3f} s")
        # a traced run closes after its traced slice
        if t1 - t_open >= ctx.seconds and (traced or not (ctx.trace and cuda)):
            break
    window_s = t1 - t_open
    gen = rng(ctx.seed, 2)
    answers = []
    for _ in range(ctx.cell["check"]["windows"]):
        c = int(gen.integers(len(done)))
        row = int(gen.integers(per))
        k, (codes, probs) = done[c]
        answers.append({"audio": pool[k % len(pool)][row], "probs": probs[row]})
    missing = sum(per - len(probs) for _, (_, probs) in done)
    record = None
    if traced:
        record = Record(ctx.dims, traced[0], decode={"prompt_len": 0, "sample_len": 1},
                        windows=n_traced * per)
    return Outcome(attempted=len(done) * per, failed=missing,
                   e2e={"langid_rtfx": len(done) * per * 30.0 / window_s},
                   answers=answers, kind="languages", record=record)
