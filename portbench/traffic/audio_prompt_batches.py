"""Spoken-audio questions to an audio language model in a closed loop:
calls of `clips_per_call` clips of 30 s, one after another; each call
moves its audio to the card, computes the log-mel there (K4) and asks
`lm_decoding.answer` for one answer token per clip, the most probable
over the whole vocabulary at the clip's last position.

A clip's tokens: a `prefix_tokens` chat/system prefix (one for every
clip, drawn from the seed), the clip's audio embeddings, then a question
(which holds the assistant suffix) whose length comes from a deck of
`pool_calls * clips_per_call` stratified log-normal lengths (`question`):
every seed has the same lengths in another order. Token ids are drawn
from the seed over the vocabulary. `pool_calls` calls of audio and
prompts are made in set-up, each run once there (every shape the window
uses), and driven in turn.

The window opens when the first call starts and closes at the end of the
first call that ends after `--seconds`; `langid_rtfx` is the audio
seconds answered over its length. A traced run takes, from the window's
second call on, a plain slice over `traced_calls` calls and then a
spanned slice (the program's spans on) over as many; the program's MoE
counters are read around each slice and over the window. The judge gets
`check.clips` clips drawn from the seed among those the window ran, each
from the first call that ran it: its audio, prompt, log-probabilities
and routes."""

from __future__ import annotations

import time

import numpy as np

from portbench.lib import signals
from portbench.lib.cell import Ctx, Outcome, rng, stratified_lognormal
from portbench.lib.spanned_record import SpannedRecord
from portbench.lib.spans import spanned_slice
from portbench.lib.trace import traced_slice

SAMPLES_PER_WINDOW = 480_000


def _moe():
    """The program's MoE counters' module, or None where it has none."""
    try:
        from openai_whisper_coreml_tpu_torch.models import moe
    except ImportError:
        return None
    return moe if hasattr(moe, "read_counters") else None


def prompts(ctx: Ctx, n: int) -> list:
    """`n` prompts (prefix, question), the questions' lengths from the deck."""
    p, vocab = ctx.params, ctx.dims["n_vocab"]
    q = p["question"]
    gen = rng(ctx.seed, 1)
    prefix = gen.integers(0, vocab, p["prefix_tokens"]).tolist()
    lengths = np.rint(stratified_lognormal(n, q["median"], q["sigma"], q["min"], q["max"],
                                           rng(ctx.seed, 3))).astype(int)
    return [(prefix, gen.integers(0, vocab, int(m)).tolist()) for m in lengths]


def setup(ctx: Ctx):
    import torch

    p = ctx.params
    n = p["clips_per_call"]
    asked = prompts(ctx, n * p["pool_calls"])
    pool = []
    for c in range(p["pool_calls"]):
        audio = torch.stack([signals.speechy_torch(SAMPLES_PER_WINDOW, ctx.seed, c * n + i,
                                                   ctx.device) for i in range(n)])
        pool.append((audio.cpu().numpy(), asked[c * n:(c + 1) * n]))
    for audio, asked_c in pool:
        _call(ctx, audio, asked_c)
    if ctx.device.type == "cuda":
        ctx.log(f"set-up's device memory peak since the weights: "
                f"{torch.cuda.max_memory_allocated(ctx.device)} bytes")
    return {"pool": pool}


def _call(ctx: Ctx, audio, asked):
    """One call: (answer tokens, answered flags) on the host, and the
    log-probabilities and routes on the card."""
    import torch

    from openai_whisper_coreml_tpu_torch.audio import log_mel_spectrogram
    from openai_whisper_coreml_tpu_torch.lm_decoding import answer

    mel = log_mel_spectrogram(torch.from_numpy(audio).to(ctx.device), n_mels=ctx.dims["n_mels"])
    lp, routes = answer(ctx.model, mel, asked, routes=True)
    best, tok = lp.max(dim=-1)
    host = torch.stack([tok, best.isfinite().long()]).cpu()
    return host[0].tolist(), host[1].tolist(), lp, routes


def _work(asked, audio_tokens: int) -> dict:
    lengths = [len(a) + audio_tokens + len(b) for a, b in asked]
    return {"clips": len(lengths), "tokens": sum(lengths),
            "attn_pairs": sum(t * (t + 1) // 2 for t in lengths)}


def _add(into: dict, more: dict) -> None:
    """Add counts in place; a maximum ("max_" in its name) takes the larger."""
    for k, v in more.items():
        into[k] = max(into.get(k, 0), v) if "max_" in k else into.get(k, 0) + v


def window(ctx: Ctx, state) -> Outcome:
    import torch

    pool = state["pool"]
    per = ctx.params["clips_per_call"]
    n_traced = ctx.params["traced_calls"]
    cuda = ctx.device.type == "cuda"
    first: dict = {}  # pool entry -> its first call's (log-probabilities, routes)
    moe = _moe()
    plain, spanned = [], []
    # per part ("window", "plain", "spans"): the MoE counters and the work
    counts = {"window": {}, "plain": {}, "spans": {}}
    work = {"plain": {}, "spans": {}}
    missing = calls = 0

    def run(k, part=None):
        nonlocal missing
        audio, asked = pool[k % len(pool)]
        if moe is not None:
            moe.reset_counters()
        _, ok, lp, routes = _call(ctx, audio, asked)
        if moe is not None:
            got = {f"moe.{name}": v for name, v in moe.read_counters().items()}
            _add(counts["window"], got)
            if part is not None:
                _add(counts[part], got)
        if part is not None:
            _add(work[part], _work(asked, ctx.dims["audio_tokens"]))
        missing += per - sum(ok)
        first.setdefault(k % len(pool), (lp, routes))

    t_open = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if ctx.trace and cuda and calls == 1:
            with traced_slice(ctx.device, plain):
                for j in range(n_traced):
                    run(calls + j, "plain")
            calls += n_traced
            from openai_whisper_coreml_tpu_torch.utils import profiling

            spans_on = getattr(profiling, "spans_on", None)
            if spans_on is not None:
                with spanned_slice(ctx.device, spanned, spans_on):
                    for j in range(n_traced):
                        run(calls + j, "spans")
                calls += n_traced
        else:
            run(calls)
            calls += 1
        t1 = time.perf_counter()
        ctx.log(f"calls {calls}: {t1 - t0:.3f} s")
        # a traced run closes after its traced slices
        if t1 - t_open >= ctx.seconds and (plain or not (ctx.trace and cuda)):
            break
    window_s = t1 - t_open
    total = counts["window"]
    if total.get("moe.tokens"):
        picks = total["moe.rows_routed"] + total["moe.null_picks"]
        ctx.log(f"the window's MoE: {total['moe.rows_routed'] / total['moe.tokens']:.4f} "
                f"routed experts a token, null share {total['moe.null_picks'] / picks:.4f} "
                f"of picks, {total}")
    ran = [(e, r) for e in sorted(first) for r in range(per)]
    answers = []
    for j in rng(ctx.seed, 2).permutation(len(ran))[:ctx.cell["check"]["clips"]]:
        e, r = ran[int(j)]
        lp, routes = first[e]
        audio, asked = pool[e]
        answers.append({"audio": audio[r], "prompt": asked[r], "logprobs": lp[r].cpu(),
                        "routes": routes[r].cpu()})
    del first
    record = None
    if plain:
        record = SpannedRecord(ctx.dims, plain[0], counters=counts["plain"],
                               window_counters=total, decode=work["plain"],
                               windows=n_traced * per,
                               spans=spanned[0] if spanned else None,
                               span_counters=counts["spans"], span_decode=work["spans"],
                               span_windows=n_traced * per if spanned else 0)
    if cuda:
        torch.cuda.synchronize(ctx.device)
    return Outcome(attempted=calls * per, failed=missing,
                   e2e={"langid_rtfx": calls * per * 30.0 / window_s},
                   answers=answers, kind="answers", record=record)
