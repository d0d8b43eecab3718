"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Phases (each raises, so the script exits non-zero, on failure):
  1. find the card (exit non-zero without CUDA) and print its name and
     power limit;
  2. build the Hopper kernels from csrc/ (K3, K6 and K2 share one source),
     one nvcc per source, all at once, and print ptxas' register and
     shared-memory lines;
  3. hold each kernel against its plain PyTorch version on the card and
     time both (CUDA events, alternating), with the one PyTorch call that
     computes the same function where there is one:
       K1 flash attention at the encoder's geometry (bf16, fp32, ragged);
       K1's causal mode at the decoder's (4,448,20,64) and ragged T = 37
       and 130, and K5 (the same kernel past 1536 keys) at (2,2048,20,64)
       non-causal and causal, bf16 and fp32, timed beside
       scaled_dot_product_attention (its CUDA-event time, and its device
       time summed over the kernels it launches), with the kernel's
       achieved TFLOP/s;
       K4 log-mel on noise at (4, 480 000) x 128, (3, 112 000) x 80 and a
       one-hour bucket (1, 61 920 000) x 128, with both's peak device
       memory, also against an fp64 oracle (torch.fft.rfft in fp64); on 30
       s of a pure tone, silence and speech-like audio against that oracle
       after the epilogue, and silence exactly -10 before it;
       K3 decode self-attention at (4,20,64,256) with per-row bounds, at
       the 1, 2 and 8 rows of the streaming and beam paths over 448
       columns, and a ragged (3,20,64,448) with pos at (and past) the last
       column;
       K6 int8 single-query attention at cross geometry (4,20,64,1500),
       self geometry (4,20,64,256) with per-row bounds, the 8 rows of
       continuous beam (cross, and a 448-column self cache), and with fp32
       q;
       K3 and K6 also at the edges of their column split across a cluster
       (pos inside the first slice, valid_from inside a late slice, pos past
       the last column, valid_from > pos), bf16 and fp32 q, each case
       launched twice (the same bits) and with its out-of-bounds columns
       poisoned (the same bits); their device times warm (one layer's
       K/V, in L2) and cold (through the decode step's entries over 32
       layers) and the split sweep (tools/torch_sqa_time.py), and K3 beside
       scaled_dot_product_attention's device time;
       K2 int8 x int8 cross-attention at (4,20,64,1536) with s_len=1500,
       bf16 and fp32 q, both A.V modes, the rule's and each forced split
       count, launched twice (the same bits) and with the padding poisoned
       (output bit-identical), its int8 codes the plain version's, against
       JAX's inline-dequant oracle too, and at its 12288-column limit; its
       device times warm and cold with the split sweep, beside K6 on the
       same K/V;
  4. fp32 parity on one tiny model (full 1500-position audio context, head
     dim 64), CPU against card: decode with bf16 and with int8 caches (K6
     on the card, inline dequantisation on the CPU), transcribe of 50 s,
     and transcribe_batch of 20, 35 and 50 s clips under both schedulers,
     greedy and beam 2; tokens and segments must be equal, and static equal
     to continuous; a StreamingTranscriber fed 8 s in 1 s chunks: events
     equal;
     word timestamps: transcribe of 50 s without and with
     hallucination_silence_threshold (2.0 s), and transcribe_batch of the
     three clips under both schedulers, greedy and beam 2, each with word
     timestamps: words (text, tokens, start, end) equal, probabilities
     within 1e-5, K1's causal mode launched by every alignment forward;
     conversion without JAX (`convert.main`): an openai-layout .pt (fp32)
     and an HF directory (bf16 model.safetensors, generation_config.json
     with alignment heads) made from the tiny model, loaded back on the
     card by load_model: every leaf equal, the heads read back;
     speculative decoding in fp32 on the card (TF32 off): the turbo config
     as target (full widths, 4 text layers) drafted by itself and by a
     second seed, speculative greedy tokens equal to the plain loop's (a
     differing row fails unless the target's two candidates lie within
     1e-4 there, a near-tie of summation order), and the tiny model with
     int8 cross-KV, card against CPU;
     the flash wrapper's gradients against autograd through the plain
     attention; fp32 training CPU against card (four micro-steps with
     accumulation, a cosine schedule and trainable="^decoder", then two
     LoRA steps on an int8 base): losses and every leaf;
  5. K2's path, its probe chain (tools/torch_sqa_v3_probe.py): B=24, 32
     layers, per-step ms of the plain inline dequantisation, K6 and K2 in
     both A.V modes over 3.0 GB of int8 K/V made on the card; K2 held
     against its plain version at the chain's shapes (layer 0 and the last
     chained layer, both A.V modes) and against the inline-dequant oracle;
  6. the main paths on large-v3 with random bf16/int8 weights: the encoder
     alone on four 30 s windows (wall per encode, device-busy time and
     K1's share of it; 32 K1 launches per encode), serve (a
     batch of 4 windows at 224 tokens, then 1 at 64, then language ID),
     speculative decoding (spec_decode: the same 4 windows at 224 tokens
     with a large-v3-turbo draft of int8 weights from seed 1, K = 4:
     tokens per iteration, the acceptance floor and the walls against
     serve's plain decode, the draft's K3 and K6 launches held exactly to
     4 layers x (K+1) steps x iterations; the target as its own draft,
     acceptance at least 0.9, every rejected proposal a near-tie within
     16 bf16 spacings; a sampled rung at t = 0.4 twice with one
     seed, equal tokens in the grammar; then transcribe of 20 s with the
     draft and transcribe_batch of three requests under the static
     scheduler with model.draft set, the governor's verdict printed),
     transcribe of ~70 s, serve_batch (six requests, static scheduler with
     the bf16 cache, continuous with the int8 cache, then beam 2 under the
     continuous scheduler with the int8 cache), word timestamps (transcribe
     of ~70 s with hallucination_silence_threshold 2.0, and transcribe_batch
     of the six requests under the continuous scheduler with the int8
     cache: every segment carries words inside the audio, in order), the
     HTTP server in-process twice (static, then continuous with beam 2:
     readiness, four concurrent requests micro-batched with a /stream
     beside them, word timestamps on /transcribe and as verbose_json words,
     the OpenAI routes, /detect, /metrics) and between them the static
     server once more with the turbo draft on the model (two requests in
     one speculative batch, the /stream beside them, /metrics holding the
     speculative counters), a two-stream
     MultiStreamTranscriber, the CLI on a 35 s WAV (two 224-token windows,
     with --word-timestamps --max-line-width 42 --highlight-words
     --draft-model large-v3-turbo --spec-k 4) and the
     CLI's --stream on a 5 s WAV (streams decode with a bf16
     cross-KV and cache, as in JAX: K4, K1 and K3 only). The batch-1 decode is shortened
     from 224 to 64 tokens. Then the DP x TP mesh (`parallel_slice`):
     ranks spawned with torchrun's environment share the card over gloo
     (`initialize_distributed` picks it: two ranks on one card); fp32,
     TF32 off, the large-v3-turbo config at its published widths (seed 0,
     int8 cross-KV) on meshes (1, 2), (2, 1) and (2, 2) against the
     unsharded model in this process: logits within 1e-3, greedy tokens
     of four windows at 32 tokens equal (a differing row must be a
     near-tie within 1e-4), K1 32 launches per encode on every rank; on
     (1, 2) large-v3 bf16 with int8 weights and cross-KV and a bf16
     cache, without timestamps: decode of four windows at 32 tokens and
     transcribe_batch of six requests under the continuous scheduler
     (8-token windows), each rank's K4, K1, K3 and K6 counted by
     `main_path`, tokens in the vocabulary, each row that parts from the
     unsharded model a bf16 tie (`bf16_ties`), each rank's parameter bytes at
     most 57% of the unsharded model's; training of `tiny` at its widths
     (fp32) on (1, 2) and (2, 1), two updates with accumulation and an
     acting clip and one LoRA step on an int8 base, losses and every
     gathered leaf within rtol 1e-5 of the one-process step; the CLI on a
     35 s WAV at large-v3-turbo int8 (large-v3's widths, a 4-layer decoder:
     the depth cut for time) under `python -m torch.distributed.run
     --standalone --nproc-per-node 2 ... --tensor-parallel 2`, its files
     written once. Word timestamps at the same fp32 turbo widths on (1, 2)
     and (2, 1): transcribe of a 35 s clip and transcribe_batch of three
     requests (16-token windows), every rank's segments and word times
     equal to the unsharded model's and probabilities within 1e-5, K1's
     causal mode once per decoder layer of each alignment forward on each
     rank; the two stream classes at the turbo widths in bf16 (bf16
     cross-KV and cache) on (1, 2): a StreamingTranscriber over 5 s and a
     two-stream MultiStreamTranscriber (8-token ticks), every rank's
     events equal, K4, K1 and K3 counted on each rank; the HTTP server at
     large-v3-turbo int8 with int8 cross-KV under `python -m
     torch.distributed.run --standalone --nproc-per-node 2 -m
     openai_whisper_coreml_tpu_torch.serve_http ... --tensor-parallel 2
     --warmup --sample-len 8 --batch-size 2`: once /readyz is 200,
     /transcribe with and
     without words, the OpenAI route (verbose_json words, json, srt),
     /detect, one /stream, two concurrent /transcribe requests and
     /metrics, each answer well-formed; then an interrupt to rank 0 stops
     the server, rank 1 returns, and the launcher returns 0.
     The walls are no multi-card figure: gloo stages every collective
     through the host, and the ranks take turns on one card;
  7. the decode step's profile: 5 large-v3 B=4 steps at a 224-token horizon
     with the decode kernels through their per-step entries (K3 + K6), with
     the per-call wrappers instead, with self_kernel=False (K6 only) and
     with the plain versions in the kernels' place: kernels and device-busy
     ms per step, and wall ms per step; the host's share of each kernel
     wrapper (per-call host time of each entry, and a cProfile of the
     step);
  8. fine-tuning large-v3 (random bf16 weights) through `finetune.main` on
     a synthetic corpus: a full fine-tune with --flash, accumulation, a
     cosine schedule and held-out evaluation; LoRA rank 8 with a saved
     train state and a --resume; then the merged checkpoint decodes one
     window. Per-step wall seconds, peak device memory and one step's
     device-busy share (torch.profiler);
  9. evaluation: `eval.harness.evaluate` on large-v3 (int8 weights and
     cross-KV, random) over six speech-like utterances in a flat corpus,
     32-token windows: JAX's report keys, a finite WER, the hypotheses and
     tokens of a plain transcribe_batch of the same audio; the audio
     loader (native or serial) printed;
 10. the trained tiny pair (tools/torch_spec_acceptance_trained.py's
     functions: tiny at full width, fp32, TF32 off; the target, then a
     half-depth draft on a copy of its encoder, decoder only; the tool's
     step caps and target loss): `evaluate` over eight held-out tone
     variants with the target and with the draft at K = 4 (governor off),
     WER <= 0.30 for both, speculative tokens equal to plain, acceptance
     >= 0.5; tokens per iteration beside the pair's break-even (ms per
     iteration at K = 4 over plain ms per token, B = 8, measured there);
 11. the CLI with --profile-dir on an 8 s tone with the trained target
     (bf16, int8 weights and cross-KV): one trace file, whose CUDA kernel
     events name K4, K1 and K3/K6 as often as the path launched them;
     how many of device_trace's opening marker kernels the profiler lost
     at the trace's start, beside the number of traces the process took.
Each main path starts with every kernel's launch count at 0 and checks it
against what the path ran: one K4 launch per log-mel call, one K1 launch
per encoder layer per encode, one K3 launch per decoder layer of each
single-token step over a bf16 cache, one K6 launch per decoder layer of
each single-token step with int8 cross-KV and as many again with an int8
self-cache (a speculative path steps the draft's 4 layers; its verify
steps are not single-token and launch none); in training
one K1 launch per encoder layer and one K1-causal launch per decoder layer
per forward, and as many again for each rematerialised recompute; with
word timestamps one K1-causal launch per decoder layer per alignment
forward (and K1 for each window encoded again). No main path runs K5: Whisper's attention never spans more than 1536 keys. K2 runs
only in its probe chain, layers x steps per chain run. The server's paths
are counted after their requests are done: the counters add up across the
server's threads.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Needs no network and no JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import torch
import torch.nn.functional as F

BF16_MAX_ABS, BF16_MEAN_ABS, FP32_MAX_ABS = 1e-2, 1e-3, 2e-5
MEL_MAX_ABS = 1e-4
# K4's unclamped log-mel on noise against the fp64 oracle: fixed limits set
# from the kernel's readings on the one-hour bucket, with room on both sides
MEL_FP64_MAX_ABS, MEL_FP64_MEAN_ABS = 3e-4, 2e-7
SR = 16_000
# published H100 SXM peaks (dense): HBM bytes/s and operations/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def log(*args):
    print(*args, flush=True)


# the call counters below are bumped from the HTTP server's threads too
_CALLS_LOCK = threading.Lock()


def bump(calls: dict, *keys, by: int = 1) -> None:
    with _CALLS_LOCK:
        for key in keys:
            calls[key] = calls.get(key, 0) + by


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate(plain, kernel, iters=20) -> tuple[float, float, dict]:
    """Time plain, kernel, kernel, plain; the best of each pair."""
    times = {}
    for name, fn in (("plain", plain), ("kernel", kernel), ("kernel2", kernel),
                     ("plain2", plain)):
        times[name] = cuda_ms(fn, iters)
    return (min(times["kernel"], times["kernel2"]),
            min(times["plain"], times["plain2"]), times)


def tool(name: str):
    """A module of tools/ (imported from this checkout's tools/)."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if tools not in sys.path:
        sys.path.append(tools)
    import importlib

    return importlib.import_module(name)


def sqa_time():
    """tools/torch_sqa_time.py: the one owner of the profiler loop, the
    decode-step profile's inputs and the host timing per call."""
    return tool("torch_sqa_time")


def device_ms(fn, kernel: str | None, iters=20) -> float:
    """Device time per call of the CUDA kernels whose name contains
    `kernel`, from torch.profiler: the kernel's own time, without the
    wrapper's host work that a CUDA-event time of a short call includes.
    With `kernel` None, the time of every kernel the call launches, summed
    (a library call may launch several)."""
    us = sqa_time().device_us(lambda i: fn(), iters, kernel)
    if kernel is None:
        return sum(us) / iters / 1e3
    # more records than launches would mean a wrong name
    if len(us) > iters:
        raise AssertionError(f"profiler saw {len(us)} {kernel} launches, "
                             f"expected {iters}")
    if len(us) < iters:
        log(f"profiler saw {len(us)} of {iters} {kernel} launches; the mean is "
            f"over those")
    return sum(us) / len(us) / 1e3


def timed_cuda_ms(fn) -> tuple[float, float]:
    """A library call's CUDA-event ms and its device ms, summed over every
    kernel it launches."""
    return cuda_ms(fn), device_ms(fn, None)


def bound(nbytes: float, ops: float, op_type: str) -> dict:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[op_type] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def speechy(seconds: float, seed: int) -> np.ndarray:
    """A modulated 200 Hz tone in noise (the JAX transcribe tests' input)."""
    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.default_rng(seed)
    return (0.2 * np.sin(2 * np.pi * 200 * t) * (1 + 0.5 * np.sin(2 * np.pi * 2 * t))
            + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


def build_kernels(modules) -> None:
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        for f in [pool.submit(m.load_kernel) for m in modules.values()]:
            f.result()
    from openai_whisper_coreml_tpu_torch.ops import _build

    log(f"kernel builds: {time.perf_counter() - t0:.2f} s wall, in parallel")
    for name in modules:
        info = _build.BUILD_INFO[name]
        log(f"  {name}: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                log("    ptxas:", line.strip())


def check_errors(name, out, ref, bf16: bool) -> float:
    err = (out.float() - ref.float()).abs()
    max_abs, mean_abs = err.max().item(), err.mean().item()
    log(f"{name}: max_abs {max_abs:.3e} mean_abs {mean_abs:.3e}")
    ok = (max_abs <= BF16_MAX_ABS and mean_abs <= BF16_MEAN_ABS if bf16
          else max_abs <= FP32_MAX_ABS)
    if not (ok and torch.isfinite(out).all()):
        raise AssertionError(f"{name}: the kernel disagrees with its plain version")
    return max_abs


def check_flash(fa) -> dict:
    """K1 vs its plain version on the same inputs; returns the JSON record."""
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    timing = None
    for shape in ((4, 1500, 1500, 20), (1, 77, 77, 20)):
        b, tq, tk, h = shape
        base = [torch.randn(b, t, h, 64, generator=g, device="cuda")
                for t in (tq, tk, tk)]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype) for x in base)
            out = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            bf16 = dtype == torch.bfloat16
            err = check_errors(f"flash kernel vs plain {shape} {dtype}", out,
                               fa.flash_attention_reference(q, k, v), bf16)
            if bf16:
                worst = max(worst, err)
                if shape[1] == 1500:
                    timing = (q, k, v)
    q, k, v = timing
    kernel_ms, plain_ms, times = alternate(
        lambda: fa.flash_attention_reference(q, k, v),
        lambda: fa.flash_attention(q, k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms, library_dev_ms = timed_cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt))
    dev_ms = device_ms(lambda: fa.flash_attention(q, k, v), "fa_fwd_bf16")
    b, t, h, d = q.shape
    flops = 4 * b * h * t * t * d
    log(f"flash (4,1500,20,64) bf16 on {card()}: kernel {kernel_ms:.4f} ms "
        f"(device {dev_ms:.4f} ms, {flops / dev_ms / 1e9:.1f} TFLOP/s), plain "
        f"{plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms "
        f"(device {library_dev_ms:.4f} ms) (runs: {times})")
    return {"name": "flash_attention", "tpu_kernel": "K1", "route": "cuda",
            "source": "openai_whisper_coreml_tpu_torch/csrc/flash_attention.cu",
            "replaces": "openai_whisper_coreml_tpu/ops/flash_attention.py:57",
            "max_abs_err": worst, "ms": kernel_ms, "device_ms": dev_ms,
            "tflops": flops / dev_ms / 1e9, "plain_ms": plain_ms,
            **bound(4 * b * t * h * d * 2, flops, "bf16"),
            "library_ms": library_ms, "library_device_ms": library_dev_ms}


def causal_pairs(t: int) -> int:
    """(query, key) pairs a causal T x T attention keeps."""
    return t * (t + 1) // 2


def check_flash_causal(fa) -> list:
    """K1's causal mode and K5 (Tk > 1536, one CUDA kernel) against their
    plain version on the same inputs, K1's causal mode also at the word
    pass's token buckets with padded rows, bf16 and fp32; timed at the
    decoder's (4,448,20,64) causal and at (2,2048,20,64) non-causal and
    causal, beside scaled_dot_product_attention(is_causal=...) as the
    library column. Returns the two JSON records."""
    g = torch.Generator(device="cuda").manual_seed(6)
    cases = [((4, 448, 20), True, "K1-causal"), ((2, 37, 20), True, "K1-causal"),
             ((1, 130, 20), True, "K1-causal"), ((2, 2048, 20), False, "K5"),
             ((2, 2048, 20), True, "K5")]
    # the word-timestamp pass's shapes: (1..4, T_bucket, 20, 64), the rows
    # past each batch row's token count eot padding (one row repeated, as
    # the eot token's embedding is)
    cases += [((b, t, 20), True, "K1-causal", valid) for b, t, valid in (
        (1, 32, [19]), (4, 32, [17, 29, 31, 32]), (4, 64, [1, 33, 61, 64]),
        (2, 256, [129, 230]))]
    worst = {"K1-causal": 0.0, "K5": 0.0}
    timed = {}
    for (b, t, h), causal, which, *valid in cases:
        base = [torch.randn(b, t, h, 64, generator=g, device="cuda") for _ in range(3)]
        for x in base:
            for row, n in enumerate(valid[0] if valid else ()):
                x[row, n:] = torch.randn(h, 64, generator=g, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype) for x in base)
            out = fa.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            bf16 = dtype == torch.bfloat16
            tag = f"{which} {(b, t, h, 64)} causal={causal} {dtype}"
            err = check_errors(f"flash kernel vs plain {tag}", out,
                               fa.flash_attention_reference(q, k, v, causal=causal),
                               bf16)
            if bf16:
                worst[which] = max(worst[which], err)
                if t in (448, 2048):
                    timed[(which, causal)] = (q, k, v)
    records = []
    for (which, causal), (q, k, v) in timed.items():
        kernel_ms, plain_ms, times = alternate(
            lambda: fa.flash_attention_reference(q, k, v, causal=causal),
            lambda: fa.flash_attention(q, k, v, causal=causal))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms, library_dev_ms = timed_cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        dev_ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                           "fa_fwd_bf16")
        b, t, h, d = q.shape
        flops = 4 * b * h * (causal_pairs(t) if causal else t * t) * d
        lim = bound(4 * b * t * h * d * 2, flops, "bf16")
        log(f"{which} flash {tuple(q.shape)} causal={causal} bf16 on {card()}: "
            f"kernel {kernel_ms:.4f} ms (device {dev_ms:.4f} ms, "
            f"{flops / dev_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention {library_ms:.4f} ms (device "
            f"{library_dev_ms:.4f} ms), bound {lim['bound_ms']:.5f} ms "
            f"({lim['bound_by']}) (runs: {times})")
        record = {"ms": kernel_ms, "device_ms": dev_ms, "tflops": flops / dev_ms / 1e9,
                  "plain_ms": plain_ms, **lim, "library_ms": library_ms,
                  "library_device_ms": library_dev_ms, "shape": list(q.shape),
                  "causal": causal}
        if which == "K1-causal":
            records.append({"name": "flash_attention_causal", "tpu_kernel": "K1-causal",
                            "replaces": "openai_whisper_coreml_tpu/ops/flash_attention.py:81",
                            "max_abs_err": worst[which], **record})
        elif causal:
            records[-1]["causal_run"] = record
        else:
            records.append({"name": "flash_attention_online", "tpu_kernel": "K5",
                            "replaces": "openai_whisper_coreml_tpu/ops/flash_attention.py:127",
                            "max_abs_err": worst[which], **record})
    for r in records:
        r.update(route="cuda",
                 source="openai_whisper_coreml_tpu_torch/csrc/flash_attention.cu")
    return records


def check_flash_grad(fa) -> None:
    """The autograd Function on the card, fp32: q/k/v gradients (kernel
    forward, recompute backward) against autograd through attention_core,
    causal and not."""
    from openai_whisper_coreml_tpu_torch.models.layers import attention_core

    g = torch.Generator(device="cuda").manual_seed(7)
    for causal in (False, True):
        qkv = [torch.randn(2, 96, 4, 64, generator=g, device="cuda").requires_grad_()
               for _ in range(3)]
        gout = torch.randn(2, 96, 4, 64, generator=g, device="cuda")
        before = fa.launches + fa.launches_causal
        out = fa.flash_attention(*qkv, causal=causal)
        got = torch.autograd.grad(out, qkv, gout)
        mask = (torch.ones(96, 96, dtype=torch.bool, device="cuda").tril()
                if causal else None)
        want = torch.autograd.grad(attention_core(*qkv, mask=mask), qkv, gout)
        errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
        scale = max(b.abs().max().item() for b in want)
        log(f"flash gradient vs attention_core (2,96,4,64) fp32 causal={causal}: "
            f"max_abs dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
            f"(scale {scale:.3e})")
        if (fa.launches + fa.launches_causal - before != 1
                or max(errs) > 1e-5 * max(1.0, scale)):
            raise AssertionError(f"flash gradient disagrees (causal={causal})")


def peak_bytes(fn) -> int:
    """Device memory a call allocates beyond what was live before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def mel_ops_per_frame(n_mels: int, dense_dft: bool) -> float:
    """fp32 operations of one log-mel frame: the Hann window, a real
    transform of N_FFT samples, the power of each bin, the mel product over
    the filterbank's non-zero entries only, and the log. Without dense_dft
    the transform is a real FFT at the usual 2.5 N log2 N, the least the
    function needs (the kernel computes an FFT); with dense_dft it is the
    TPU kernel's work, the (N_FFT x bins) cos and sin products."""
    from openai_whisper_coreml_tpu_torch.audio import mel_filters
    from openai_whisper_coreml_tpu_torch.config import N_FFT

    n_bins = N_FFT // 2 + 1
    mel = 2 * int(np.count_nonzero(mel_filters(n_mels)))
    if dense_dft:
        transform = 4 * N_FFT * n_bins
    else:
        transform = N_FFT + 2.5 * N_FFT * np.log2(N_FFT)
    return transform + 3 * n_bins + mel + n_mels


def mel_oracle(padded: torch.Tensor, n_mels: int) -> torch.Tensor:
    """The unclamped log10 mel of reflect-padded audio in fp64, from
    torch.fft.rfft (a library FFT, no kernel of the port), 50 000 frames at
    a time: (B, 160 T + 400) -> (B, T, n_mels) float64."""
    from openai_whisper_coreml_tpu_torch.audio import mel_filters

    n_frames = (padded.shape[-1] - 400) // 160
    window = (1 - torch.cos(2 * np.pi * torch.arange(400, device=padded.device,
                                                     dtype=torch.float64) / 400)) / 2
    fb = torch.from_numpy(mel_filters(n_mels).T).to(padded.device, torch.float64)
    chunks = []
    for t0 in range(0, n_frames, 50_000):
        frames = padded.double().unfold(-1, 400, 160)[:, t0:min(n_frames, t0 + 50_000)]
        power = torch.fft.rfft(frames * window).abs() ** 2
        chunks.append(torch.log10(torch.clamp(power @ fb, min=1e-10)))
    return torch.cat(chunks, dim=1)


def check_mel(mk) -> dict:
    """K4 on noise: against its plain version on the same padded audio
    (unclamped output, MEL_MAX_ABS) at (4, 480 000) x 128 and (3, 112 000)
    x 80; on every noise input, the one-hour bucket (1, 61 920 000) x 128
    too, against the fp64 oracle: unclamped within MEL_FP64_MAX_ABS and
    MEL_FP64_MEAN_ABS, and within 1e-3 after the epilogue (over the
    bucket's 49.5 M values the plain version's dense fp32 DFT is itself
    farther than MEL_MAX_ABS from fp64 where a one- or two-bin filter
    catches almost no energy, so no transform closer to fp64 can be within
    MEL_MAX_ABS of it there). On a pure tone, silence and speech-like audio,
    whose bins without real energy hold fp32 rounding noise in any
    transform, the frontend's gate alone: 1e-3 against the fp64 oracle
    after the epilogue, and silence exactly -10 in every bin before it. The
    JSON record carries the times at (4, 480 000) x 128 and the one-hour
    bucket's. No single PyTorch call computes the log-mel (STFT, power,
    filterbank and log are several)."""
    from openai_whisper_coreml_tpu_torch.audio import log_mel_spectrogram

    g = torch.Generator(device="cuda").manual_seed(1)
    worst = worst_oracle = 0.0
    record = None
    for b, n, n_mels in ((4, 480_000, 128), (3, 16_000 * 7, 80),
                         (1, 61_920_000, 128)):
        hour = b * n > 10 ** 7
        x = torch.randn(b, n, generator=g, device="cuda") * 0.1
        padded = F.pad(x[:, None], (200, 200), mode="reflect")[:, 0]
        out = mk.log_mel_kernel(padded, n_mels)
        torch.cuda.synchronize()
        plain = mk.log_mel_kernel_reference(padded, n_mels)
        truth = mel_oracle(padded, n_mels)
        err = (out - plain).abs()
        max_abs, mean_abs = err.max().item(), err.mean().item()
        to_truth = (out.double() - truth).abs()
        fp64_max, fp64_mean = to_truth.max().item(), to_truth.mean().item()
        plain_to_truth = (plain.double() - truth).abs().max().item()
        post = (mk.epilogue(out).double() - mk.epilogue(truth)).abs().max().item()
        log(f"mel kernel ({b}, {n}) x {n_mels}: vs plain max_abs {max_abs:.3e} mean_abs "
            f"{mean_abs:.3e}{' (not gated)' if hour else ''}; vs fp64 max_abs "
            f"{fp64_max:.3e} (<= {MEL_FP64_MAX_ABS}) mean_abs {fp64_mean:.3e} (<= "
            f"{MEL_FP64_MEAN_ABS}) (plain vs fp64 max_abs {plain_to_truth:.3e}), after "
            f"the epilogue {post:.3e}")
        if not (torch.isfinite(out).all() and (hour or max_abs <= MEL_MAX_ABS)
                and fp64_max <= MEL_FP64_MAX_ABS and fp64_mean <= MEL_FP64_MEAN_ABS
                and post <= 1e-3):
            raise AssertionError(f"mel kernel disagrees at ({b}, {n}) x {n_mels}")
        worst = max(worst, max_abs)
        worst_oracle = max(worst_oracle, post)
        del plain, truth, err, to_truth
        if n_mels == 80:
            continue
        kernel_ms, plain_ms, times = alternate(
            lambda: mk.log_mel_kernel_reference(padded, n_mels),
            lambda: mk.log_mel_kernel(padded, n_mels), iters=10)
        dev_ms = device_ms(lambda: mk.log_mel_kernel(padded, n_mels), "log_mel_kernel",
                           iters=10)
        frames = out.shape[0] * out.shape[1]
        nbytes = padded.numel() * 4 + out.numel() * 4
        lim = bound(nbytes, frames * mel_ops_per_frame(n_mels, dense_dft=False), "fp32")
        dense = bound(nbytes, frames * mel_ops_per_frame(n_mels, dense_dft=True), "fp32")
        log(f"mel ({b}, {n}) x {n_mels} on {card()}: kernel {kernel_ms:.4f} ms "
            f"(device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms (runs: {times}); bound "
            f"{lim['bound_ms']:.4f} ms ({lim['bound_by']}; the function's minimum, a real "
            f"FFT per frame, as the kernel computes); the TPU kernel's dense DFT would be "
            f"bound at {dense['bound_ms']:.4f} ms ({dense['bound_by']})")
        if record is None:
            record = {"name": "log_mel", "tpu_kernel": "K4", "route": "cuda",
                      "source": "openai_whisper_coreml_tpu_torch/csrc/mel.cu",
                      "replaces": "openai_whisper_coreml_tpu/ops/mel_kernel.py:51",
                      "ms": kernel_ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                      **lim, "tpu_dense_dft_bound_ms": dense["bound_ms"],
                      "library_ms": None}
        else:
            kernel_peak = peak_bytes(lambda: mk.log_mel_kernel(padded, n_mels))
            plain_peak = peak_bytes(lambda: mk.log_mel_kernel_reference(padded, n_mels))
            log(f"mel one-hour bucket peak device memory beyond its input: "
                f"kernel {kernel_peak} B, plain {plain_peak} B")
            record.update(hour_bucket_ms=kernel_ms, hour_bucket_device_ms=dev_ms,
                          hour_bucket_bound_ms=lim["bound_ms"],
                          hour_bucket_peak_bytes=kernel_peak)
        del x, padded, out
        torch.cuda.empty_cache()
    # audio without energy in most bins: the post-epilogue fp64 gate
    seconds = 30
    t = torch.arange(seconds * SR, device="cuda", dtype=torch.float64) / SR
    signals = {"tone": (0.5 * torch.sin(2 * np.pi * 440 * t)).float(),
               "silence": torch.zeros(seconds * SR, device="cuda"),
               "speechy": torch.from_numpy(speechy(seconds, 2)).cuda()}
    for n_mels in (80, 128):
        for name, x in signals.items():
            before = mk.launches
            mel = log_mel_spectrogram(x[None], n_mels)
            torch.cuda.synchronize()
            padded = F.pad(x[None, None], (200, 200), mode="reflect")[:, 0]
            err = (mel.double() - mk.epilogue(mel_oracle(padded, n_mels))).abs().max().item()
            log(f"mel kernel vs the fp64 oracle after the epilogue, {name} {seconds} s x "
                f"{n_mels}: max_abs {err:.3e} (<= 1e-3)")
            if mk.launches != before + 1 or not err <= 1e-3:
                raise AssertionError(f"mel kernel fails the fp64 gate on {name}")
            worst_oracle = max(worst_oracle, err)
            if name == "silence" and not (mk.log_mel_kernel(padded, n_mels) == -10.0).all():
                raise AssertionError("mel kernel: silence is not -10 before the epilogue")
    log("mel kernel: silence gives exactly -10 in every bin before the epilogue")
    record.update(max_abs_err=worst, oracle_max_abs_err=worst_oracle)
    return record


def _bounds(b, c, g, per_row: bool):
    """(pos, valid_from) int32 (B,) bounds inside [0, c), or scalars."""
    if not per_row:
        return c - 1, 0
    pos = torch.randint(c // 2, c, (b,), generator=g, device="cuda", dtype=torch.int32)
    vf = torch.randint(0, 8, (b,), generator=g, device="cuda", dtype=torch.int32)
    return pos, vf


# (pos, valid_from) of a row at the edges of K3's and K6's column split
SPLIT_EDGES = {"pos in the first slice": lambda c: (min(2, c - 1), 0),
               "valid_from in a late slice": lambda c: (c - 1, c - 1 - c // 10),
               "pos past the last column": lambda c: (c + 3, 1),
               "valid_from > pos": lambda c: (c // 2, c // 2 + 1)}


def _edge_bounds(b, c):
    """[(name, pos, valid_from)]: every row at one edge of SPLIT_EDGES,
    then the rows cycling through them."""
    cases = [(name, *(torch.full((b,), x, dtype=torch.int32, device="cuda")
                      for x in edge(c))) for name, edge in SPLIT_EDGES.items()]
    mixed = [list(SPLIT_EDGES.values())[i % len(SPLIT_EDGES)](c) for i in range(b)]
    cases.append(("edges mixed", *(torch.tensor(x, dtype=torch.int32, device="cuda")
                                   for x in zip(*mixed))))
    return cases


def _check_split_kernel(name, wrapper, plain, q, kv, pos, vf, bf16: bool) -> float:
    """One case of K3 or K6: against the plain version; a second launch
    gives the same bits; columns outside each row's bounds poisoned (NaN
    in bf16 K/V, int8 K/V at 127 with NaN scales) leave the output
    bit-identical. Rows with no column in bounds (which weigh every column)
    are left out of the poisoning."""
    out = wrapper(q, *kv, pos, vf)
    again = wrapper(q, *kv, pos, vf)
    torch.cuda.synchronize()
    err = check_errors(name, out, plain(q, *kv, pos, vf), bf16)
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two launches gave different bits")
    b, c = q.shape[0], kv[0].shape[-1]
    pos_t = torch.as_tensor(pos, device="cuda").expand(b).clamp(max=c - 1)[:, None]
    vf_t = torch.as_tensor(vf, device="cuda").expand(b).clamp(min=0)[:, None]
    cols = torch.arange(c, device="cuda")
    outside = ((cols > pos_t) | (cols < vf_t)) & (vf_t <= pos_t)  # (B, C)
    poisoned = [x.clone() for x in kv]
    for x in poisoned:
        x.masked_fill_(outside[:, None, None, :], float("nan") if x.is_floating_point() else 127)
    if not torch.equal(out, wrapper(q, *poisoned, pos, vf)):
        raise AssertionError(f"{name}: poisoned columns outside the bounds changed the output")
    return err


def _expect_refusal(call, what: str) -> None:
    """`call` must raise the wrappers' launch error for cudaErrorInvalidValue
    (the C entry refuses the shape and launches nothing); anything else,
    or no error, fails."""
    try:
        call()
    except RuntimeError as e:
        if "CUDA error 1" not in str(e):
            raise
        return
    raise AssertionError(f"{what}: launched where it must be refused")


def _split_timing(kernel: str, b: int, c: int) -> dict:
    """Warm and cold device times (tools/torch_sqa_time.py) with the rule's
    cluster size, and the same for each forced size (the split sweep)."""
    from openai_whisper_coreml_tpu_torch.ops import sqa_int8 as si

    torch_sqa_time = sqa_time()

    timing = torch_sqa_time.time_kernel(kernel, b, c)
    sweep = {}
    for splits in torch_sqa_time.SWEEP_SPLITS:
        if (kernel, splits) == ("sqa_v3", 1):
            # one CTA cannot hold a 1536-column row's K and V: refused before launch
            _expect_refusal(lambda: torch_sqa_time.time_kernel(kernel, b, c, splits),
                            f"{kernel} {(b, 20, 64, c)} forced to one CTA")
            sweep[splits] = None
            continue
        t = torch_sqa_time.time_kernel(kernel, b, c, splits)
        sweep[splits] = {"warm_ms": t["warm_ms"], "cold_ms": t["cold_ms"]}
    log(f"{kernel} {(b, 20, 64, c)} split sweep on {card()} (device ms, warm / cold; the "
        f"rule takes {si.split_count(c, b * 20)}): " + ", ".join(
            f"{s}: {t['warm_ms']:.4f} / {t['cold_ms']:.4f}" if t else f"{s}: does not fit"
            for s, t in sweep.items()))
    return {"warm_device_ms": timing["warm_ms"], "cold_device_ms": timing["cold_ms"],
            "rule_splits": si.split_count(c, b * 20), "split_sweep": sweep}


def check_sqa_self(ss) -> dict:
    """K3 vs its plain version: (4,20,64,256) bf16 with per-row bounds, the
    rows of the other paths over a full 448-column cache (1 in the CLI's
    stream, 2 in the two-stream loop, 8 under continuous beam 2 at batch
    4), a ragged (3,20,64,448) with pos at the last column and one row past
    it (clamped), and fp32 q; at the edges of the column split (SPLIT_EDGES)
    at 256 columns and at 1 and 8 rows of 448, bf16 and fp32 q; every case
    launched twice (same bits) and with the columns outside its bounds
    poisoned (same bits). Timed at (4,20,64,256) over all columns: CUDA
    events against the plain version and scaled_dot_product_attention with a
    boolean mask on transposed views (its event and device time), and the
    kernel's device time warm and cold with the split sweep."""
    g = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    cases = [((4, 20, 64, 256), "per-row", torch.bfloat16),
             *(((b, 20, 64, 448), "per-row", torch.bfloat16) for b in (1, 2, 8)),
             ((3, 20, 64, 448), "last-column", torch.bfloat16),
             ((4, 20, 64, 256), "per-row", torch.float32),
             *(((b, 20, 64, c), "edges", qdtype) for b, c in ((4, 256), (1, 448), (8, 448))
               for qdtype in (torch.bfloat16, torch.float32))]
    for (b, h, d, c), kind, qdtype in cases:
        q = torch.randn(b, h, d, generator=g, device="cuda").to(qdtype)
        kv = tuple(torch.randn(b, h, d, c, generator=g, device="cuda").bfloat16()
                   for _ in range(2))
        if kind == "per-row":
            bounds = [(kind, *_bounds(b, c, g, True))]
        elif kind == "last-column":
            bounds = [(kind, torch.tensor([c - 1, 120, c], dtype=torch.int32, device="cuda"),
                       torch.tensor([0, 5, 2], dtype=torch.int32, device="cuda"))]
        else:
            bounds = _edge_bounds(b, c)
        for name, pos, vf in bounds:
            worst = max(worst, _check_split_kernel(
                f"sqa_self kernel vs plain {(b, h, d, c)} {name} q {qdtype}", ss.sqa_self,
                ss.sqa_self_reference, q, kv, pos, vf, True))
    log("sqa_self: two launches gave the same bits and poisoned columns outside the "
        "bounds left every output bit-identical")
    b, h, d, c = 4, 20, 64, 256
    q = torch.randn(b, h, d, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(b, h, d, c, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    kernel_ms, plain_ms, times = alternate(
        lambda: ss.sqa_self_reference(q, k, v, c - 1, 0),
        lambda: ss.sqa_self(q, k, v, c - 1, 0), iters=50)
    mask = torch.ones(b, 1, 1, c, dtype=torch.bool, device="cuda")
    library_ms, library_dev_ms = timed_cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(-1, -2), v.transpose(-1, -2), attn_mask=mask))
    dev_ms = device_ms(lambda: ss.sqa_self(q, k, v, c - 1, 0), "Bf16KV")
    split = _split_timing("sqa_self", b, c)
    lim = bound(2 * b * h * d * c * 2 + 2 * b * h * d * 2, 4 * b * h * d * c, "bf16")
    log(f"sqa_self (4,20,64,256) bf16 on {card()}: kernel {kernel_ms:.4f} ms "
        f"(device {dev_ms:.4f} ms; warm {split['warm_device_ms']:.4f}, cold through the "
        f"step entry {split['cold_device_ms']:.4f}), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {library_ms:.4f} ms (device {library_dev_ms:.4f} "
        f"ms), bound {lim['bound_ms']:.5f} ms (runs: {times})")
    return {"name": "sqa_self", "tpu_kernel": "K3", "route": "cuda",
            "source": "openai_whisper_coreml_tpu_torch/csrc/sqa.cu",
            "replaces": "openai_whisper_coreml_tpu/ops/sqa_self.py:39",
            "max_abs_err": worst, "ms": kernel_ms, "device_ms": dev_ms, **split,
            "plain_ms": plain_ms, **lim,
            "library_ms": library_ms, "library_device_ms": library_dev_ms}


def check_sqa_int8(si) -> dict:
    """K6 vs its plain version at cross geometry (4,20,64,1500), self
    geometry (4,20,64,256) with per-row bounds, the 8 rows of continuous
    beam 2 at batch 4 (cross, and a 448-column self cache with per-row
    bounds), and with fp32 q; at the edges of the column split
    (SPLIT_EDGES) at 1500 columns and at 1 and 8 rows of 448, bf16 and fp32
    q; every case launched twice (same bits) and with the columns outside
    its bounds poisoned (same bits). Timed at cross geometry: CUDA events
    against the plain version, and the device time warm and cold (through
    the step entry over 32 layers) with the split sweep. No single PyTorch
    call attends over int8 K/V with column scales."""
    from openai_whisper_coreml_tpu_torch.models.decoder import quantize_kv_column

    g = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    timing = None
    cases = [((4, 20, 64, 1500), "scalar", torch.bfloat16),
             ((4, 20, 64, 256), "per-row", torch.bfloat16),
             ((8, 20, 64, 1500), "scalar", torch.bfloat16),
             ((8, 20, 64, 448), "per-row", torch.bfloat16),
             ((4, 20, 64, 1500), "scalar", torch.float32),
             *(((b, 20, 64, s), "edges", qdtype) for b, s in ((4, 1500), (1, 448), (8, 448))
               for qdtype in (torch.bfloat16, torch.float32))]
    for (b, h, d, s), kind, qdtype in cases:
        q = torch.randn(b, h, d, generator=g, device="cuda").to(qdtype)
        k8, ks = quantize_kv_column(torch.randn(b, h, d, s, generator=g, device="cuda"))
        v8, vs = quantize_kv_column(torch.randn(b, h, d, s, generator=g, device="cuda"))
        bounds = (_edge_bounds(b, s) if kind == "edges"
                  else [(kind, *_bounds(b, s, g, kind == "per-row"))])
        bf16 = qdtype == torch.bfloat16
        for name, pos, vf in bounds:
            err = _check_split_kernel(f"sqa_int8 kernel vs plain {(b, h, d, s)} {name} q "
                                      f"{qdtype}", si.sqa_int8, si.sqa_int8_reference, q,
                                      (k8, ks, v8, vs), pos, vf, bf16)
            if bf16:
                worst = max(worst, err)
        if bf16 and (b, s, kind) == (4, 1500, "scalar"):
            timing = (q, k8, ks, v8, vs)
    log("sqa_int8: two launches gave the same bits and poisoned columns outside the "
        "bounds left every output bit-identical")
    q, k8, ks, v8, vs = timing
    b, h, d, s = k8.shape
    kernel_ms, plain_ms, times = alternate(
        lambda: si.sqa_int8_reference(q, k8, ks, v8, vs, s - 1, 0),
        lambda: si.sqa_int8(q, k8, ks, v8, vs, s - 1, 0), iters=50)
    dev_ms = device_ms(lambda: si.sqa_int8(q, k8, ks, v8, vs, s - 1, 0),
                       "Int8KV")
    split = _split_timing("sqa_int8", b, s)
    lim = bound(2 * b * h * d * s + 2 * b * h * s * 4 + 2 * b * h * d * 2,
                4 * b * h * d * s, "int8")
    log(f"sqa_int8 (4,20,64,1500) bf16 q on {card()}: kernel {kernel_ms:.4f} ms "
        f"(device {dev_ms:.4f} ms; warm {split['warm_device_ms']:.4f}, cold through the "
        f"step entry {split['cold_device_ms']:.4f}), plain {plain_ms:.4f} ms, bound "
        f"{lim['bound_ms']:.5f} ms; no single PyTorch call computes it "
        f"(runs: {times})")
    return {"name": "sqa_int8", "tpu_kernel": "K6", "route": "cuda",
            "source": "openai_whisper_coreml_tpu_torch/csrc/sqa.cu",
            "replaces": "openai_whisper_coreml_tpu/ops/sqa_int8.py:59",
            "max_abs_err": worst, "ms": kernel_ms, "device_ms": dev_ms, **split,
            "plain_ms": plain_ms, **lim,
            "library_ms": None}


def check_sqa_v3(sv, si) -> dict:
    """K2 vs its plain version at (4,20,64,1536) with s_len=1500, bf16 and
    fp32 q, both A.V modes, with the rule's split count and each forced
    count (2, 4, 8 and 16; one CTA cannot hold a 1536-column row's K and V,
    so a forced 1 must raise): the lane padding poisoned with 127 and 1e6
    scales must leave the output bit-identical, and a second launch give
    the same bits; with int8 A.V and fp32 q the codes, wmax and integer
    sums must be the plain version's (out / plain one constant a row, to
    within three fp32 roundings); against JAX's inline-dequant oracle at
    JAX's tolerances (max 0.012 / rms 0.004 with int8 A.V, 0.004 / 0.0013
    with bf16; fp32 q, whose output is not rounded to bf16); and at its
    column limit, (1,4,64,12288). Timed (int8 and bf16 A.V, bf16 q) beside
    K6 over the same int8 K/V, warm and cold
    (tools/torch_sqa_time.py) with the split sweep: no single PyTorch call
    computes K2."""
    from openai_whisper_coreml_tpu_torch.models.decoder import quantize_kv_column

    g = torch.Generator(device="cuda").manual_seed(6)
    b, h, d, s, s_len = 4, 20, 64, 1536, 1500
    k8, ks = quantize_kv_column(torch.randn(b, h, d, s, generator=g, device="cuda"))
    v8, vs = quantize_kv_column(torch.randn(b, h, d, s, generator=g, device="cuda"))
    poisoned = [x.clone() for x in (k8, ks, v8, vs)]
    for x, val in zip(poisoned, (127, 1e6, 127, 1e6)):
        x[..., s_len:] = val
    q32 = torch.randn(b, h, d, generator=g, device="cuda")
    oracle = sv.sqa_cross_reference(q32, k8, ks, v8, vs, s_len=s_len)
    worst = 0.0
    for qdtype in (torch.bfloat16, torch.float32):
        q = q32.to(qdtype)
        for av in (True, False):
            plain = sv.sqa_cross_int8_reference(q, k8, ks, v8, vs, s_len=s_len, av_int8=av)
            for splits in (0, 1, 2, 4, 8, 16):
                tag = (f"sqa_v3 kernel vs plain {(b, h, d, s)} s_len {s_len} q {qdtype} "
                       f"av_int8={av} splits={splits or 'rule'}")
                if splits == 1:
                    before = sv.launches
                    _expect_refusal(lambda: sv.sqa_cross_int8(
                        q, k8, ks, v8, vs, s_len=s_len, av_int8=av, splits=1), tag)
                    if sv.launches != before:
                        raise AssertionError(f"{tag}: a refused launch was counted")
                    continue
                out = sv.sqa_cross_int8(q, k8, ks, v8, vs, s_len=s_len, av_int8=av,
                                        splits=splits)
                again = sv.sqa_cross_int8(q, k8, ks, v8, vs, s_len=s_len, av_int8=av,
                                          splits=splits)
                out_poisoned = sv.sqa_cross_int8(q, *poisoned, s_len=s_len, av_int8=av,
                                                 splits=splits)
                torch.cuda.synchronize()
                worst = max(worst, check_errors(tag, out, plain, qdtype == torch.bfloat16))
                if not (torch.equal(out, again) and torch.equal(out, out_poisoned)):
                    raise AssertionError(f"{tag}: a second launch or the poisoned lane "
                                         f"padding changed the output")
                if av and qdtype == torch.float32:
                    nonzero = plain != 0
                    ratio = torch.where(nonzero, out / torch.where(nonzero, plain, 1.0),
                                        float("nan"))
                    row = ratio.nanmedian(dim=-1, keepdim=True).values
                    spread = ((ratio - row).abs() / row).nan_to_num(0.0).max().item()
                    if not (spread <= 4e-7 and torch.equal(out != 0, nonzero)):
                        raise AssertionError(f"{tag}: the int8 codes are not the plain "
                                             f"version's (ratio spread {spread:.3e})")
            if qdtype == torch.float32:
                err = sv.sqa_cross_int8(q, k8, ks, v8, vs, s_len=s_len, av_int8=av) - oracle
                max_err, rms = err.abs().max().item(), err.square().mean().sqrt().item()
                tol = 0.012 if av else 0.004
                log(f"sqa_v3 vs the inline-dequant oracle av_int8={av}: max "
                    f"{max_err:.3e} (< {tol}), rms {rms:.3e} (< {tol / 3:.4f})")
                if not (max_err < tol and rms < tol / 3):
                    raise AssertionError("sqa_v3 disagrees with the inline-dequant oracle")
    log("sqa_v3: every split count gave the same bits twice, the poisoned padding left "
        "every output bit-identical, and the int8 codes are the plain version's; a forced "
        "single CTA at 1536 columns raised")
    q_lim, *kv_lim = (torch.randn(1, 4, d, generator=g, device="cuda"),
                      *quantize_kv_column(torch.randn(1, 4, d, sv.MAX_COLS, generator=g,
                                                      device="cuda")),
                      *quantize_kv_column(torch.randn(1, 4, d, sv.MAX_COLS, generator=g,
                                                      device="cuda")))
    for av in (True, False):
        check_errors(f"sqa_v3 kernel vs plain (1, 4, 64, {sv.MAX_COLS}) av_int8={av}",
                     sv.sqa_cross_int8(q_lim, *kv_lim, av_int8=av),
                     sv.sqa_cross_int8_reference(q_lim, *kv_lim, av_int8=av), False)
    del q_lim, kv_lim
    q = q32.bfloat16()

    def k2(av=True):
        return sv.sqa_cross_int8(q, k8, ks, v8, vs, s_len=s_len, av_int8=av)

    def k6():
        return si.sqa_int8(q, k8, ks, v8, vs, s_len - 1, 0)

    kernel_ms, plain_ms, times = alternate(
        lambda: sv.sqa_cross_int8_reference(q, k8, ks, v8, vs, s_len=s_len), k2,
        iters=50)
    dev_ms = device_ms(k2, "sqa_v3_kernel")
    bf16_ms = cuda_ms(lambda: k2(False), iters=50)
    bf16_dev_ms = device_ms(lambda: k2(False), "sqa_v3_kernel")
    k6_ms = cuda_ms(k6, iters=50)
    k6_dev_ms = device_ms(k6, "Int8KV")
    split = _split_timing("sqa_v3", b, s)
    bf16_split = sqa_time().time_kernel("sqa_v3", b, s, av_int8=False)
    lim = bound(2 * b * h * d * s_len + 2 * b * h * s_len * 4 + 2 * b * h * d * 2,
                4 * b * h * d * s_len, "int8")
    log(f"sqa_v3 (4,20,64,1500 of 1536) bf16 q on {card()}: int8 A.V kernel "
        f"{kernel_ms:.4f} ms (device {dev_ms:.4f} ms; warm {split['warm_device_ms']:.4f}, "
        f"cold {split['cold_device_ms']:.4f}), bf16 A.V {bf16_ms:.4f} ms (device "
        f"{bf16_dev_ms:.4f} ms; warm {bf16_split['warm_ms']:.4f}, cold "
        f"{bf16_split['cold_ms']:.4f}), plain {plain_ms:.4f} ms; K6 on the same K/V "
        f"{k6_ms:.4f} ms (device {k6_dev_ms:.4f} ms); bound {lim['bound_ms']:.5f} ms "
        f"({100 * lim['bound_ms'] / split['cold_device_ms']:.0f}% of the cold time); no "
        f"single PyTorch call computes it (runs: {times})")
    return {"name": "sqa_v3", "tpu_kernel": "K2", "route": "cuda",
            "source": "openai_whisper_coreml_tpu_torch/csrc/sqa.cu",
            "replaces": "openai_whisper_coreml_tpu/ops/sqa_v3.py:52",
            "max_abs_err": worst, "ms": kernel_ms, "device_ms": dev_ms, **split,
            "plain_ms": plain_ms, **lim, "library_ms": None,
            "av_bf16_ms": bf16_ms, "av_bf16_device_ms": bf16_dev_ms,
            "av_bf16_warm_device_ms": bf16_split["warm_ms"],
            "av_bf16_cold_device_ms": bf16_split["cold_ms"],
            "k6_same_kv_ms": k6_ms, "k6_same_kv_device_ms": k6_dev_ms}


@contextlib.contextmanager
def counting_steps(calls):
    """Count decode_step calls with T == 1 by the caches they get: bf16
    KVCache (K3 with the loops' self_kernel), QuantKVCache (K6), and
    QuantCrossKV (K6); and the decoder layers those steps ran, since a
    speculative path steps two models of different depths (each "_layers"
    count is what the kernel of that cache launches)."""
    from openai_whisper_coreml_tpu_torch.models import decoder as dec_mod

    step = dec_mod.decode_step

    def counting_step(decoder, tokens, cross_kv, cache, *args, **kwargs):
        if tokens.shape[1] == 1:
            layers = len(decoder.blocks)
            bump(calls, "steps")
            if isinstance(cache, dec_mod.KVCache) and cache.k.dtype == torch.bfloat16:
                bump(calls, "bf16_self_steps")
                bump(calls, "bf16_self_layers", by=layers)
            if isinstance(cache, dec_mod.QuantKVCache):
                bump(calls, "int8_self_steps")
                bump(calls, "int8_self_layers", by=layers)
            if isinstance(cross_kv, dec_mod.QuantCrossKV):
                bump(calls, "int8_cross_steps")
                bump(calls, "int8_cross_layers", by=layers)
        return step(decoder, tokens, cross_kv, cache, *args, **kwargs)

    for key in ("steps", "bf16_self_steps", "int8_self_steps", "int8_cross_steps",
                "bf16_self_layers", "int8_self_layers", "int8_cross_layers"):
        calls.setdefault(key, 0)
    dec_mod.decode_step = counting_step
    try:
        yield calls
    finally:
        dec_mod.decode_step = step


def segments_key(segments):
    return [(s["seek"], s["start"], s["end"], s["tokens"], s["text"])
            for s in segments]


def fp32_parity(wt, fa, mk, si):
    from openai_whisper_coreml_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config(n_state=128, n_head=2, n_layer=2)  # D=64, T=1500
    cpu = wt.build_model(cfg, dtype=torch.float32, seed=0, device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    audio = (np.random.default_rng(1).standard_normal((2, 480_000)) * 0.1
             ).astype(np.float32)
    mel = cpu.log_mel(audio)
    mel_err = (gpu.log_mel(audio).cpu() - mel).abs().max().item()
    for kw in (dict(), dict(kv_dtype="int8", cache_dtype="int8")):
        opts = wt.DecodingOptions(language="en", sample_len=64, **kw)
        before = fa.launches, si.launches
        with counting_steps({}) as calls:
            res_gpu = gpu.decode(mel.cuda(), opts)
        launched = fa.launches - before[0], si.launches - before[1]
        res_cpu = cpu.decode(mel, opts)
        toks_gpu = [r.tokens for r in res_gpu]
        toks_cpu = [r.tokens for r in res_cpu]
        want_k6 = cfg.n_text_layer * (calls["int8_self_steps"] + calls["int8_cross_steps"])
        log(f"fp32 decode parity {kw}: mel max_abs {mel_err:.3e}; tokens equal "
            f"{toks_gpu == toks_cpu} ({[len(t) for t in toks_gpu]} tokens); "
            f"flash launches {launched[0]}, sqa_int8 launches {launched[1]} "
            f"(expected {want_k6})")
        if (mel_err > 1e-4 or toks_gpu != toks_cpu
                or launched != (cfg.n_audio_layer, want_k6)):
            raise AssertionError(f"fp32 CPU/CUDA parity failed {kw}: {toks_cpu} "
                                 f"vs {toks_gpu}, launches {launched}")

    speech = speechy(50, 11)
    padded = np.zeros(3 * 480_000, np.float32)  # transcribe's mel bucket
    padded[:len(speech)] = speech
    mel_err = (gpu.log_mel(padded).cpu() - cpu.log_mel(padded)).abs().max().item()
    kw = dict(language="en", temperature=0.0, sample_len=12,
              no_speech_threshold=None, logprob_threshold=None,
              compression_ratio_threshold=None)
    before = mk.launches
    seg_gpu = gpu.transcribe(speech, **kw)["segments"]
    mel_launches = mk.launches - before
    seg_cpu = cpu.transcribe(speech, **kw)["segments"]
    equal = segments_key(seg_gpu) == segments_key(seg_cpu)
    log(f"fp32 transcribe parity (50 s): mel max_abs card vs cpu {mel_err:.3e}; "
        f"{len(seg_gpu)} segments, equal {equal}; mel launches {mel_launches}")
    # the segments are the gate; the mel is held to the frontend's fidelity
    # gate (1e-3 against fp64): on this input fp32 already puts the lowest,
    # low-energy mel band ~7e-5 from an fp64 oracle on the CPU alone
    if not equal or mel_launches != 1 or mel_err > 1e-3:
        raise AssertionError(f"fp32 transcribe parity failed:\n{seg_cpu}\nvs\n{seg_gpu}")

    clips = [speechy(20, 21), speechy(35, 22), speechy(50, 23)]
    results = {}
    for scheduler in ("static", "continuous"):
        opts = wt.ServeOptions(
            batch_size=2, language="en", temperature=(0.0,), sample_len=12,
            scheduler=scheduler, chunk_tokens=8, kv_dtype="int8",
            cache_dtype="int8", no_speech_threshold=None, logprob_threshold=None,
            compression_ratio_threshold=None)
        before = si.launches
        on_card = wt.transcribe_batch(gpu, clips, opts)
        launched = si.launches - before
        on_cpu = wt.transcribe_batch(cpu, clips, opts)
        equal = [segments_key(a["segments"]) == segments_key(b["segments"])
                 for a, b in zip(on_card, on_cpu)]
        log(f"fp32 transcribe_batch parity ({scheduler}, int8 caches): segments "
            f"per request {[len(r['segments']) for r in on_card]}, card == cpu "
            f"{equal}; sqa_int8 launches {launched}")
        if not all(equal) or launched == 0:
            raise AssertionError(f"fp32 transcribe_batch parity failed ({scheduler})")
        results[scheduler] = [segments_key(r["segments"]) for r in on_card]
    if results["static"] != results["continuous"]:
        raise AssertionError("fp32 transcribe_batch: static and continuous differ")
    log("fp32 transcribe_batch: static == continuous")

    # beam (K=2) under both schedulers, int8 cross-KV and cache (K6)
    beams = {}
    for scheduler in ("static", "continuous"):
        opts = wt.ServeOptions(
            batch_size=2, language="en", temperature=(0.0,), sample_len=12,
            beam_size=2, scheduler=scheduler, chunk_tokens=8, kv_dtype="int8",
            cache_dtype="int8", no_speech_threshold=None, logprob_threshold=None,
            compression_ratio_threshold=None)
        before = si.launches
        on_card = wt.transcribe_batch(gpu, clips, opts)
        launched = si.launches - before
        on_cpu = wt.transcribe_batch(cpu, clips, opts)
        equal = [segments_key(a["segments"]) == segments_key(b["segments"])
                 for a, b in zip(on_card, on_cpu)]
        log(f"fp32 beam transcribe_batch parity ({scheduler}, beam 2, int8 caches): "
            f"segments per request {[len(r['segments']) for r in on_card]}, card == "
            f"cpu {equal}; sqa_int8 launches {launched}")
        if not all(equal) or launched == 0:
            raise AssertionError(f"fp32 beam transcribe_batch parity failed ({scheduler})")
        beams[scheduler] = [segments_key(r["segments"]) for r in on_card]
    if beams["static"] != beams["continuous"]:
        raise AssertionError("fp32 beam transcribe_batch: static and continuous differ")
    log("fp32 beam transcribe_batch: static == continuous")

    # streaming: 1 s chunks of 8 s (K4 and K1 per tick; the fp32 cache's steps
    # take the plain path)
    speech = speechy(8, 12)
    events, mel_launches = {}, {}
    for where, m in (("card", gpu), ("cpu", cpu)):
        before = mk.launches
        st = wt.StreamingTranscriber(m, language="en", sample_len=12)
        evs = []
        for off in range(0, len(speech), SR):
            evs += st.feed(speech[off:off + SR])
        evs += st.finish()
        events[where] = [(e.text, e.tokens, e.is_final) for e in evs]
        mel_launches[where] = mk.launches - before
    log(f"fp32 streaming parity (8 s in 1 s chunks): {len(events['card'])} events, "
        f"card == cpu {events['card'] == events['cpu']}; mel launches "
        f"{mel_launches['card']} (9 decodes: 8 ticks and the flush)")
    if events["card"] != events["cpu"] or mel_launches != {"card": 9, "cpu": 0}:
        raise AssertionError(f"fp32 streaming parity failed: {events}")


def words_key(segments):
    return [[(w["word"], w["start"], w["end"]) for w in s.get("words", [])]
            for s in segments]


def word_probs_err(a, b) -> float:
    """Largest difference of word probabilities between two results with
    the same words."""
    return max((abs(x["probability"] - y["probability"])
                for sa, sb in zip(a, b)
                for x, y in zip(sa.get("words", []), sb.get("words", []))),
               default=0.0)


def word_parity(wt, fa):
    """fp32 word timestamps of the tiny model (head dim 64), CPU against
    card: transcribe of 50 s without and with hallucination_silence_threshold
    (2.0 s), and
    transcribe_batch of three clips under both schedulers, greedy and beam
    2 (int8 caches). Segments and words (text, tokens, start, end) equal,
    probabilities within 1e-5; on the card the alignment forwards run K1's
    causal mode, one launch per decoder layer."""
    from openai_whisper_coreml_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config(n_state=128, n_head=2, n_layer=2)
    cpu = wt.build_model(cfg, dtype=torch.float32, seed=0, device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    quiet = dict(no_speech_threshold=None, logprob_threshold=None,
                 compression_ratio_threshold=None)

    def compare(name, on_card, on_cpu, causal):
        equal = (segments_key(on_card) == segments_key(on_cpu)
                 and words_key(on_card) == words_key(on_cpu))
        err = word_probs_err(on_card, on_cpu)
        n_words = sum(len(w) for w in words_key(on_card))
        log(f"fp32 word parity ({name}): {len(on_card)} segments, {n_words} words, "
            f"card == cpu {equal}, probability max_abs {err:.3e}; K1-causal "
            f"launches {causal}")
        if not equal or err > 1e-5 or n_words == 0 or causal == 0 \
                or causal % cfg.n_text_layer:
            raise AssertionError(f"fp32 word parity failed ({name}):\n{on_cpu}\n"
                                 f"vs\n{on_card}")

    speech = speechy(50, 11)
    for threshold in (None, 2.0):
        kw = dict(language="en", temperature=0.0, sample_len=12, word_timestamps=True,
                  hallucination_silence_threshold=threshold, **quiet)
        before = fa.launches_causal
        on_card = gpu.transcribe(speech, **kw)["segments"]
        compare(f"transcribe 50 s, hallucination_silence_threshold {threshold}",
                on_card, cpu.transcribe(speech, **kw)["segments"],
                fa.launches_causal - before)

    t = time.perf_counter()
    clips = [speechy(20, 21), speechy(35, 22), speechy(50, 23)]
    for scheduler in ("static", "continuous"):
        for beam in (None, 2):
            opts = wt.ServeOptions(
                batch_size=2, language="en", temperature=(0.0,), sample_len=12,
                beam_size=beam, scheduler=scheduler, chunk_tokens=8,
                kv_dtype="int8", cache_dtype="int8", word_timestamps=True, **quiet)
            before = fa.launches_causal
            on_card = wt.transcribe_batch(gpu, clips, opts)
            causal = fa.launches_causal - before
            for i, (a, b) in enumerate(zip(on_card, wt.transcribe_batch(cpu, clips, opts))):
                compare(f"transcribe_batch {scheduler}, beam {beam}, request {i}",
                        a["segments"], b["segments"], causal)
    log(f"fp32 word parity of transcribe_batch: {time.perf_counter() - t:.3f} s "
        f"(card and cpu)")


# openai/whisper state-dict names -> HuggingFace's, applied in order
HF_NAMES = [(r"^(encoder|decoder)\.blocks\.", r"model.\1.layers."),
            (r"\.attn\.query\.", ".self_attn.q_proj."),
            (r"\.attn\.key\.", ".self_attn.k_proj."),
            (r"\.attn\.value\.", ".self_attn.v_proj."),
            (r"\.attn\.out\.", ".self_attn.out_proj."),
            (r"\.cross_attn\.query\.", ".encoder_attn.q_proj."),
            (r"\.cross_attn\.key\.", ".encoder_attn.k_proj."),
            (r"\.cross_attn\.value\.", ".encoder_attn.v_proj."),
            (r"\.cross_attn\.out\.", ".encoder_attn.out_proj."),
            (r"\.attn_ln\.", ".self_attn_layer_norm."),
            (r"\.cross_attn_ln\.", ".encoder_attn_layer_norm."),
            (r"\.mlp\.0\.", ".fc1."), (r"\.mlp\.2\.", ".fc2."),
            (r"\.mlp_ln\.", ".final_layer_norm."),
            (r"^encoder\.(conv\d)", r"model.encoder.\1"),
            (r"^encoder\.ln_post", "model.encoder.layer_norm"),
            (r"^decoder\.token_embedding", "model.decoder.embed_tokens"),
            (r"^decoder\.positional_embedding$", "model.decoder.embed_positions.weight"),
            (r"^decoder\.ln\.", "model.decoder.layer_norm.")]


def openai_state_dict(tree) -> dict:
    """A JAX-layout tree of tensors under openai/whisper's names."""
    sd = {}
    att = {"q": "query", "k": "key", "v": "value", "out": "out"}

    def linear(name, p, i):
        sd[f"{name}.weight"] = p["w"][i].T.contiguous()
        if "b" in p:
            sd[f"{name}.bias"] = p["b"][i]

    for side in ("encoder", "decoder"):
        blocks = tree[side]["blocks"]
        for i in range(blocks["attn"]["q"]["w"].shape[0]):
            pre = f"{side}.blocks.{i}"
            for sub in ("attn", "cross_attn") if side == "decoder" else ("attn",):
                for k, n in att.items():
                    linear(f"{pre}.{sub}.{n}", blocks[sub][k], i)
            for ln in ("attn_ln", "cross_attn_ln", "mlp_ln"):
                if ln in blocks:
                    sd[f"{pre}.{ln}.weight"] = blocks[ln]["scale"][i]
                    sd[f"{pre}.{ln}.bias"] = blocks[ln]["bias"][i]
            linear(f"{pre}.mlp.0", blocks["mlp"]["fc1"], i)
            linear(f"{pre}.mlp.2", blocks["mlp"]["fc2"], i)
    for conv in ("conv1", "conv2"):
        sd[f"encoder.{conv}.weight"] = tree["encoder"][conv]["w"].permute(2, 1, 0).contiguous()
        sd[f"encoder.{conv}.bias"] = tree["encoder"][conv]["b"]
    for name, p in (("encoder.ln_post", tree["encoder"]["ln_post"]),
                    ("decoder.ln", tree["decoder"]["ln"])):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["scale"], p["bias"]
    sd["decoder.token_embedding.weight"] = tree["decoder"]["token_embedding"]
    sd["decoder.positional_embedding"] = tree["decoder"]["positional_embedding"]
    return sd


def convert_slice():
    """`python -m openai_whisper_coreml_tpu_torch.convert` on this machine,
    which has no JAX: an openai-layout `.pt` (fp32) and an HF directory
    (bf16 `model.safetensors` and `generation_config.json` with alignment
    heads), both made from the tiny model, become `.safetensors` files that
    `load_model` reads back on the card: every leaf equals the source (the
    HF one rounded to bf16) and the HF heads reach model.alignment_heads."""
    import re

    from openai_whisper_coreml_tpu_torch import config as tconfig
    from openai_whisper_coreml_tpu_torch import convert
    from openai_whisper_coreml_tpu_torch.params import params_tree
    from openai_whisper_coreml_tpu_torch.utils.checkpoint import (flatten_params,
                                                                  write_safetensors)

    name = "chip-smoke-tiny"
    cfg = tconfig.tiny_test_config(n_state=128, n_head=2, n_layer=2)
    tconfig.CONFIGS[name] = cfg
    import openai_whisper_coreml_tpu_torch as wt

    tree = params_tree(wt.build_model(cfg, dtype=torch.float32, seed=5, device="cpu"))
    sd = openai_state_dict(tree)
    # three pairs: two would read as a (2, 2) mask, in both packages (a
    # fault shared with the reference: the mask shape is tested first)
    heads = [[1, 1], [1, 0], [0, 1]]
    want_heads = np.zeros((2, cfg.n_text_head), bool)
    for layer, head in heads:
        want_heads[layer, head] = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            pt = os.path.join(tmp, "model.pt")
            torch.save({"dims": {"n_audio_state": 128}, "model_state_dict": sd}, pt)
            hf = os.path.join(tmp, "hf")
            os.makedirs(hf)
            hf_sd = {}
            for k, v in sd.items():
                for pat, rep in HF_NAMES:
                    k = re.sub(pat, rep, k)
                hf_sd[k] = v.to(torch.bfloat16)
            hf_sd["proj_out.weight"] = hf_sd["model.decoder.embed_tokens.weight"]
            write_safetensors(os.path.join(hf, "model.safetensors"), hf_sd,
                              {"format": "pt"})
            with open(os.path.join(hf, "generation_config.json"), "w") as f:
                json.dump({"alignment_heads": heads}, f)
            for src, dtype, want_h in ((pt, torch.float32, None),
                                       (hf, torch.bfloat16, want_heads)):
                out = os.path.join(tmp, "out.safetensors")
                t = time.perf_counter()
                if convert.main(["--input", src, "--model", name, "--output", out]) != 0:
                    raise AssertionError(f"convert {src} failed")
                seconds = time.perf_counter() - t
                model = wt.load_model(name, checkpoint=out, dtype=torch.float32,
                                      device="cuda")
                got = flatten_params(params_tree(model))
                ref = flatten_params(tree)
                bad = [k for k in ref if not torch.equal(
                    got[k].cpu(), ref[k].to(dtype).float())]
                heads_ok = (model.alignment_heads is None if want_h is None else
                            np.array_equal(model.alignment_heads, want_h))
                log(f"convert {os.path.basename(src)} ({dtype}): {len(ref)} leaves, "
                    f"{len(bad)} differ, alignment heads read back {heads_ok}, "
                    f"{seconds:.3f} s")
                if bad or set(got) != set(ref) or not heads_ok:
                    raise AssertionError(f"convert {src}: leaves {bad[:5]}, heads "
                                         f"{model.alignment_heads}")
    finally:
        del tconfig.CONFIGS[name]


def host_copy(x):
    """A copy on the host of a tensor, or of the tensors in a dict."""
    if isinstance(x, dict):
        return {k: host_copy(v) for k, v in x.items()}
    return x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x


def snapshot(model) -> dict:
    """The model's parameters by name, copied to the host one by one (no
    device memory beyond the model's own)."""
    return host_copy(dict(model.named_parameters()))


def remat_factor(encoder) -> int:
    """Flash launches per encoder layer in a rematerialised train step: 2
    when the backward reaches the encoder (it has trainable weights), else
    1 (the mel needs no gradient)."""
    return 2 if any(p.requires_grad for p in encoder.parameters()) else 1


def train_parity(fa) -> None:
    """fp32 training on one tiny model (full 1500-position audio context,
    head dim 64), CPU against card, the card's attention through K1 and
    K1's causal mode: four micro-steps (two updates, accum_steps=2, cosine
    with warmup, trainable="^decoder"), then two LoRA steps on an int8
    base. Losses, and every leaf after the steps, within the tolerance of
    the CPU tests against JAX (trained leaves 1e-2 * lr, frozen leaves
    bit-identical); the encoder's attn.q.w gets a nonzero gradient through
    the kernel, equal to the plain path's."""
    from openai_whisper_coreml_tpu_torch.config import tiny_test_config
    from openai_whisper_coreml_tpu_torch.lora import add_lora
    from openai_whisper_coreml_tpu_torch.models.whisper import WhisperModel, build_model
    from openai_whisper_coreml_tpu_torch.params import params_tree
    from openai_whisper_coreml_tpu_torch.quantize import quantize_params
    from openai_whisper_coreml_tpu_torch.tokenizer import get_tokenizer
    from openai_whisper_coreml_tpu_torch.train import (TrainConfig, make_batch,
                                                       make_train_step)

    cfg = tiny_test_config(n_state=128, n_head=2, n_layer=2)
    tok = get_tokenizer(cfg)
    rng = np.random.default_rng(8)
    batches = [make_batch(cfg, tok, rng.standard_normal((2, cfg.n_mels, 3000))
                          .astype(np.float32), [f"one {i} two", f"three {i}"],
                          max_len=12) for i in range(4)]
    lr = 1e-2
    base = build_model(cfg, dtype=torch.float32, seed=0, device="cpu")
    lora_tree = add_lora(quantize_params(params_tree(base), min_size=0), rank=4)
    runs = (("decoder, accum 2, cosine", TrainConfig(
                learning_rate=lr, flash=True, accum_steps=2, schedule="cosine",
                warmup_steps=1, total_steps=3, trainable="^decoder"),
             lambda: build_model(cfg, dtype=torch.float32, seed=0, device="cpu"), 4),
            ("LoRA on int8", TrainConfig(learning_rate=lr, flash=True,
                                         trainable="lora_"),
             lambda: WhisperModel(cfg, copy.deepcopy(lora_tree)), 2))
    for name, tc, make, micro in runs:
        result = {}
        for dev in ("cpu", "cuda"):
            init_fn, step_fn = make_train_step(cfg, tc)
            model, state = init_fn(make().to(dev))
            before = snapshot(model)
            counts = (fa.launches, fa.launches_causal)
            losses = [float(step_fn(model, state, *batch)[2]["loss"])
                      for batch in batches[:micro]]
            launched = (fa.launches - counts[0], fa.launches_causal - counts[1])
            trained = {n for n, p in model.named_parameters() if p.requires_grad}
            result[dev] = (losses, snapshot(model), before, trained, launched)
        (l_cpu, p_cpu, b_cpu, trained, _), (l_gpu, p_gpu, _, _, launched) = (
            result["cpu"], result["cuda"])
        # remat: a train step runs a block's kernel twice (the forward and
        # the recompute in the backward) where the backward reaches the
        # block: every decoder block, encoder blocks only when they train
        want = (remat_factor(model.encoder) * micro * cfg.n_audio_layer,
                2 * micro * cfg.n_text_layer)
        worst = max((p_gpu[k] - p_cpu[k]).abs().max().item() for k in trained)
        frozen_ok = all(torch.equal(p_gpu[k], b_cpu[k]) and torch.equal(p_cpu[k], b_cpu[k])
                        for k in p_cpu if k not in trained)
        moved = all(not torch.equal(p_gpu[k], b_cpu[k]) for k in trained)
        log(f"fp32 train parity ({name}): losses cpu {l_cpu} card {l_gpu}; trained "
            f"leaves max |card - cpu| {worst:.3e} (limit {1e-2 * lr:.0e}); frozen "
            f"bit-identical {frozen_ok}; trained moved {moved}; launches K1, "
            f"K1-causal {launched} (expected {want})")
        if (not np.allclose(l_gpu, l_cpu, rtol=1e-4) or worst > 1e-2 * lr
                or not frozen_ok or not moved or launched != want):
            raise AssertionError(f"fp32 train parity failed ({name})")

    # the gradient the ctypes output used to lose
    model = build_model(cfg, dtype=torch.float32, seed=0, device="cuda")
    w = model.encoder.blocks[0].attn.q.w
    w.requires_grad_(True)
    g = torch.Generator(device="cuda").manual_seed(9)
    mel = torch.randn(1, cfg.n_mels, 3000, generator=g, device="cuda")
    proj = torch.randn(1, cfg.n_audio_ctx, cfg.n_audio_state, generator=g, device="cuda")
    grads = {flash: torch.autograd.grad((model.encoder(mel, flash=flash) * proj).sum(),
                                        [w])[0] for flash in (True, False)}
    err = (grads[True] - grads[False]).abs().max().item()
    scale = grads[False].abs().max().item()
    log(f"encoder attn.q.w gradient through K1 vs plain attention: max_abs "
        f"{err:.3e}, scale {scale:.3e}")
    if not (grads[True].abs().max().item() > 0 and err <= 1e-4 * scale):
        raise AssertionError("the encoder's q projection lost its gradient")


def write_corpus(root: str, n: int) -> None:
    """n speech-like WAVs of 4-11 s with a transcript each (flat layout)."""
    from openai_whisper_coreml_tpu_torch.utils.audio_io import save_wav

    words = "the quick brown fox jumps over a lazy dog near seven green hills".split()
    for i in range(n):
        save_wav(os.path.join(root, f"u{i}.wav"), speechy(4 + i, 40 + i))
        with open(os.path.join(root, f"u{i}.txt"), "w", encoding="utf-8") as f:
            f.write(" ".join(words[(i + j) % len(words)] for j in range(5 + i)))


@contextlib.contextmanager
def finetune_probe(calls, record):
    """Wrap finetune's building blocks for one run: count train steps and
    eval batches into the flash layers they run (`calls`), log-mel calls,
    time each step (synchronised), profile one step, and keep the model,
    its start, and the saved and restored train states (`record`)."""
    from torch.profiler import ProfilerActivity, profile

    from openai_whisper_coreml_tpu_torch import audio as audio_mod
    from openai_whisper_coreml_tpu_torch import finetune
    from openai_whisper_coreml_tpu_torch import train
    from openai_whisper_coreml_tpu_torch.ops import flash_attention as fa
    from openai_whisper_coreml_tpu_torch.utils import checkpoint

    def counted(fn, want, what):
        """Run fn; its K1 and K1-causal launches must equal `want`."""
        before = fa.launches, fa.launches_causal
        out = fn()
        got = fa.launches - before[0], fa.launches_causal - before[1]
        record.setdefault("launches_per_step", []).append(got)
        if got != want:
            raise AssertionError(f"{what}: K1, K1-causal launches {got}, "
                                 f"expected {want}")
        calls["encoder_layers"] += got[0]
        calls["causal_layers"] += got[1]
        return out

    real = (train.make_train_step, train.make_eval_step, audio_mod.log_mel_spectrogram,
            checkpoint.save_train_state, finetune.restore)

    def make_train_step(cfg, tc):
        init_fn, step_fn = real[0](cfg, tc)
        per_step = {}

        def init(model):
            record["model"] = model
            record["start"] = snapshot(model)
            out = init_fn(model)
            # remat runs a block's kernel again in the backward
            per_step["encoder"] = remat_factor(model.encoder) if tc.remat else 1
            per_step["decoder"] = 2 if tc.remat else 1
            return out

        def step(*args):
            profiled = len(record["step_s"]) == record.get("profile_step")
            torch.cuda.synchronize()
            # one launch per layer per forward, and one more per recompute
            want = ((per_step["encoder"] * cfg.n_audio_layer,
                     per_step["decoder"] * cfg.n_text_layer) if tc.flash else (0, 0))
            with (profile(activities=[ProfilerActivity.CUDA]) if profiled
                  else contextlib.nullcontext()) as prof:
                t = time.perf_counter()
                out = counted(lambda: step_fn(*args), want,
                              f"train step {len(record['step_s']) + 1}")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            record["step_s"].append(wall)
            if profiled:
                # wall under the profiler (device activity only); the share
                # against an unprofiled step of the same kind is in the log
                busy = sum(e.time_range.elapsed_us() for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
                record["profiled"] = {"step": len(record["step_s"]), "wall_s": wall,
                                      "device_busy_s": busy, "busy_share": busy / wall,
                                      "kernels": sum(
                                          1 for e in prof.events()
                                          if e.device_type == torch.autograd.DeviceType.CUDA)}
            return out

        return init, step

    def make_eval_step(cfg, tc):
        eval_fn = real[1](cfg, tc)

        def run(*args):
            want = (cfg.n_audio_layer, cfg.n_text_layer) if tc.flash else (0, 0)
            return counted(lambda: eval_fn(*args), want, "evaluation batch")

        return run

    def log_mel_spectrogram(*args, **kw):
        calls["log_mel"] += 1
        return real[2](*args, **kw)

    def save_train_state(path, model, opt_state=None, step=None):
        real[3](path, model, opt_state=opt_state, step=step)
        record["saved"] = (snapshot(model), host_copy(opt_state))

    def restore(path, model, device):
        opt_state, step = real[4](path, model, device)
        record["restored"] = (snapshot(model), host_copy(opt_state))
        return opt_state, step

    record.setdefault("step_s", [])
    train.make_train_step, train.make_eval_step = make_train_step, make_eval_step
    audio_mod.log_mel_spectrogram = log_mel_spectrogram
    checkpoint.save_train_state, finetune.restore = save_train_state, restore
    try:
        yield
    finally:
        (train.make_train_step, train.make_eval_step, audio_mod.log_mel_spectrogram,
         checkpoint.save_train_state, finetune.restore) = real


def states_equal(a, b) -> bool:
    """Bit equality of two (params by path, optimizer state) pairs."""
    def same(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, torch.Tensor):
            return x.dtype == y.dtype and torch.equal(x, y)
        return x == y

    return same(a[0], b[0]) and same(a[1], b[1])


def finetune_slice(kernels) -> None:
    """large-v3 through `finetune.main` (random bf16 weights, seed 0) on a
    synthetic corpus: (a) a full fine-tune with flash, accumulation, a
    cosine schedule with warmup and held-out evaluation; (b) LoRA rank 8
    for 2 steps with a saved train state, then --resume to step 3. Then the
    merged checkpoint of (b) is loaded and decodes one window. Checks the
    launches per step (K1 and K1-causal: each layer once per forward and
    again in the remat recompute; K4 once per new utterance), finite
    losses, that trained leaves moved and frozen ones are bit-identical,
    and that the restored state equals the saved one bit for bit."""
    from openai_whisper_coreml_tpu_torch import finetune, load_model
    from openai_whisper_coreml_tpu_torch.config import get_config
    from openai_whisper_coreml_tpu_torch.params import jax_path

    cfg = get_config("large-v3")
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        os.makedirs(corpus)
        write_corpus(corpus, 8)
        out = os.path.join(tmp, "ckpt")
        state_dir = os.path.join(tmp, "state")
        common = [corpus, "--model", "large-v3", "--flash", "--batch-size", "4",
                  "--log-every", "1", "--output", out]
        runs = (("finetune full", ["--steps", "4", "--accum-steps", "2", "--schedule",
                                   "cosine", "--warmup-steps", "1", "--holdout", "0.25",
                                   "--eval-every", "2"], 4),
                ("finetune LoRA", ["--lora-rank", "8", "--steps", "2", "--save-every",
                                   "2", "--save-state", state_dir], 2),
                ("finetune LoRA resumed", ["--lora-rank", "8", "--steps", "3",
                                           "--resume", state_dir], 1))
        records = {}
        # profiled: the full run's last step (an optimizer update, like its
        # second step, which runs unprofiled) and the resumed run's one step
        profile_at = {"finetune full": 3, "finetune LoRA resumed": 0}
        for name, flags, n_steps in runs:
            record = records[name] = {"profile_step": profile_at.get(name)}
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with main_path(name, kernels,
                           idle=("flash_attention_online", "sqa_self", "sqa_int8",
                                 "sqa_v3")
                           ) as calls, finetune_probe(calls, record):
                rc = finetune.main(common + flags)
            peak = torch.cuda.max_memory_allocated()
            if rc != 0 or len(record["step_s"]) != n_steps:
                raise AssertionError(f"{name}: rc {rc}, {len(record['step_s'])} steps")
            model, start = record["model"], record["start"]
            end = snapshot(model)
            trained = {n for n, p in model.named_parameters() if p.requires_grad}
            if trained != {n for n, v in end.items() if ("lora_" in n if "LoRA" in name
                                                         else v.is_floating_point())}:
                raise AssertionError(f"{name}: unexpected trainable set")
            moved = {jax_path(n) for n in trained if not torch.equal(end[n], start[n])}
            frozen_same = all(torch.equal(end[n], start[n]) for n in end if n not in trained)
            paths = {jax_path(n) for n in trained}
            log(f"[{name}] {n_steps} steps on {card()}: wall s per step "
                f"{[round(x, 3) for x in record['step_s']]}; peak device memory "
                f"{peak / 2**30:.2f} GiB; profiled step {record.get('profiled')}; "
                f"K1, K1-causal launches per train step and evaluation batch "
                f"{record['launches_per_step']}; "
                f"{len(moved)} of {len(paths)} trained leaves moved; frozen "
                f"leaves bit-identical {frozen_same}")
            # bf16 weights at 1.0 (layer-norm scales) move only by 2^-7 or more:
            # far above one update at lr 1e-5, so those leaves stay put
            still = sorted(paths - moved)
            if not frozen_same or any(not k.endswith("ln/scale") and
                                      not k.endswith("ln_post/scale") for k in still):
                raise AssertionError(f"{name}: leaves that did not move {still}")
            if name == "finetune LoRA resumed":
                if not states_equal(records["finetune LoRA"]["saved"], record["restored"]):
                    raise AssertionError("the restored train state differs from the saved")
                log("restored train state equals the saved one bit for bit")
            del record["model"], record["start"], model, start, end
            torch.cuda.empty_cache()
        final = out + "-final.safetensors"
        with main_path("finetuned decode", kernels,
                       idle=SERVING_IDLE + ("sqa_int8",)) as calls:
            model = load_model("large-v3", checkpoint=final, device="cuda")
            result = model.decode(model.log_mel(speechy(30, 50)), language="en",
                                  sample_len=48)
        if not (result.tokens and all(0 <= t < cfg.n_vocab for t in result.tokens)
                and np.isfinite(result.avg_logprob)):
            raise AssertionError(f"decode of the fine-tuned checkpoint: {result}")
        log(f"fine-tuned large-v3 ({os.path.getsize(final) / 1e9:.2f} GB checkpoint) "
            f"decoded {len(result.tokens)} tokens")


# launches of each kernel summed over the main paths
TOTALS: dict = {}


# kernels of a path that never launch there: K1's causal mode runs only in
# teacher forcing (training, and the word-timestamp pass), K5 only beyond
# 1536 keys (never in Whisper); K2 only in its probe chain (no decode path
# calls it, as in JAX)
SERVING_IDLE = ("flash_attention_causal", "flash_attention_online", "sqa_v3")
# a path with word timestamps launches K1's causal mode too
WORDS_IDLE = ("flash_attention_online", "sqa_v3")


def reset_counts(kernels) -> None:
    for mod, counter in kernels.values():
        setattr(mod, counter, 0)


def read_counts(kernels) -> dict:
    return {k: getattr(mod, counter) for k, (mod, counter) in kernels.items()}


@contextlib.contextmanager
def main_path(name, kernels, idle=SERVING_IDLE):
    """Count the path's kernel launches from 0, its encoder layers, log-mel
    calls and single-token decode steps; on exit check each kernel's count
    against what the path ran, and that every kernel but those in `idle`
    launched. A training path adds its flash layers to calls
    ("encoder_layers", "causal_layers") and its log-mel calls itself."""
    from openai_whisper_coreml_tpu_torch.models.whisper import WhisperModel

    from openai_whisper_coreml_tpu_torch import timing

    calls = {"encode": 0, "encoder_layers": 0, "causal_layers": 0, "log_mel": 0,
             "align_forwards": 0}
    encode, log_mel = WhisperModel.encode, WhisperModel.log_mel
    teacher_forced = timing._teacher_forced

    def counting_encode(self, mel):
        bump(calls, "encode")
        bump(calls, "encoder_layers", by=self.cfg.n_audio_layer)
        return encode(self, mel)

    def counting_log_mel(self, audio):
        bump(calls, "log_mel")
        return log_mel(self, audio)

    def counting_teacher_forced(model, *args, **kwargs):
        # the word-timestamp pass: one K1-causal launch per decoder layer
        bump(calls, "align_forwards")
        bump(calls, "causal_layers", by=model.cfg.n_text_layer)
        return teacher_forced(model, *args, **kwargs)

    WhisperModel.encode, WhisperModel.log_mel = counting_encode, counting_log_mel
    timing._teacher_forced = counting_teacher_forced
    reset_counts(kernels)
    t = time.perf_counter()
    try:
        with counting_steps(calls):
            yield calls
            torch.cuda.synchronize()
    finally:
        WhisperModel.encode, WhisperModel.log_mel = encode, log_mel
        timing._teacher_forced = teacher_forced
    seconds = time.perf_counter() - t
    launches = read_counts(kernels)
    expected = {"flash_attention": calls["encoder_layers"],
                "flash_attention_causal": calls["causal_layers"],
                "flash_attention_online": 0,
                "log_mel": calls["log_mel"],
                "sqa_self": calls["bf16_self_layers"],
                "sqa_int8": calls["int8_self_layers"] + calls["int8_cross_layers"],
                "sqa_v3": 0}
    log(f"[{name}] {seconds:.3f} s wall on {card()}; calls {calls}; "
        f"launches {launches}, expected {expected}")
    if launches != expected or not all(n for k, n in launches.items()
                                       if k not in idle):
        raise AssertionError(f"{name}: kernel launches {launches}, "
                             f"expected {expected}")
    for k, n in launches.items():
        TOTALS[k] = TOTALS.get(k, 0) + n


# the report keys of JAX's eval/harness.evaluate (WER languages)
EVAL_KEYS = {"n_utterances", "audio_seconds", "wall_seconds", "rtfx", "wer",
             "substitutions", "deletions", "insertions", "hits", "ref_words",
             "examples"}


@contextlib.contextmanager
def capture_batches():
    """Record what each `serve.transcribe_batch` call returns (`evaluate`
    reports three examples; its hypotheses and tokens are all here)."""
    from openai_whisper_coreml_tpu_torch import serve

    runs = []
    original = serve.transcribe_batch

    def recording(*args, **kwargs):
        runs.append(original(*args, **kwargs))
        return runs[-1]

    serve.transcribe_batch = recording
    try:
        yield runs
    finally:
        serve.transcribe_batch = original


def tokens_of(results) -> list:
    return [[s["tokens"] for s in r["segments"]] for r in results]


def check_report(report, n: int, name: str) -> None:
    if (set(report) != EVAL_KEYS or report["n_utterances"] != n
            or not report["rtfx"] > 0 or not np.isfinite(report["wer"])
            or len(report["examples"]) != min(3, n)):
        raise AssertionError(f"{name}: report {report}")


def eval_slice(wt, kernels) -> dict:
    """`eval.harness.evaluate` on large-v3 (int8 weights and cross-KV, bf16
    activations, random weights from seed 0) over a flat corpus of six
    speech-like utterances (4-9 s, one window each), batch 8, 32-token
    windows: the report has JAX's keys and a finite WER; the timed call's
    hypotheses and tokens equal a plain `transcribe_batch` of the same audio
    with the same options; K4, K1, K3 and K6 launch as the path implies."""
    from openai_whisper_coreml_tpu_torch.eval import harness
    from openai_whisper_coreml_tpu_torch.utils import audio_io

    model = wt.load_model("large-v3", dtype=torch.bfloat16, quantize="int8",
                          device="cuda")
    opts = dict(kv_dtype="int8", sample_len=32, temperature=(0.0,),
                no_speech_threshold=None)
    loader = "native" if audio_io.native_batch_loader() else "serial"
    with tempfile.TemporaryDirectory() as tmp:
        write_corpus(tmp, 6)
        with capture_batches() as runs, main_path("evaluate", kernels) as calls:
            report = harness.evaluate(model, tmp, batch_size=8, language="en", **opts)
        audios = [audio_io.load_audio(u.audio_path) for u in harness.discover(tmp)]
    check_report(report, 6, "evaluate")
    if len(runs) != 2 or calls["encode"] != 2:
        raise AssertionError(f"evaluate: {len(runs)} batches, {calls['encode']} encodes")
    plain = wt.transcribe_batch(model, audios, wt.ServeOptions(
        batch_size=8, language="en", **opts))
    if ([r["text"] for r in runs[1]] != [r["text"] for r in plain]
            or tokens_of(runs[1]) != tokens_of(plain)):
        raise AssertionError("evaluate's hypotheses differ from transcribe_batch's")
    log(f"evaluate large-v3 int8 on {card()}: audio loader {loader}; "
        + json.dumps({k: v for k, v in report.items() if k != "examples"}))
    del model
    torch.cuda.empty_cache()
    return report


def write_tone_corpus(root: str, phrases, tone_audio, n: int) -> None:
    """The trained pair's held-out variants (noise seeds 777 + i, class
    i % len(phrases)) as a flat corpus."""
    from openai_whisper_coreml_tpu_torch.utils.audio_io import save_wav

    for i in range(n):
        c = i % len(phrases)
        save_wav(os.path.join(root, f"t{i}.wav"), tone_audio(c, seed=777 + i))
        with open(os.path.join(root, f"t{i}.txt"), "w", encoding="utf-8") as f:
            f.write(phrases[c])


# fp32 decodes launch neither K3 (bf16 caches only) nor K6 (int8 only)
FP32_IDLE = SERVING_IDLE + ("sqa_self", "sqa_int8")
# the trained pair's training runs without flash: K4 only
TRAIN_IDLE = FP32_IDLE + ("flash_attention",)
WER_GATE, ACCEPTANCE_GATE = 0.30, 0.5


def trained_pair_slice(wt, kernels, ckpt: str) -> dict:
    """The trained tiny pair (tools/torch_spec_acceptance_trained.py's
    functions, its step caps and target loss) at tiny's full width, fp32 with
    TF32 off: the target, then the half-depth draft on a copy of its
    encoder, decoder only. Then `evaluate` over the eight held-out tone
    variants with the target, and with the draft on model.draft at K = 4
    (the governor off: every window drafts): WER <= 0.30 for both,
    speculative tokens equal to plain, acceptance >= 0.5. The speculative
    iteration's ms over the plain ms per token (the pair's break-even
    tokens per iteration) at B = 8, beside the measured tokens per
    iteration. The target is saved to `ckpt` for profile_slice."""
    from openai_whisper_coreml_tpu_torch import speculative
    from openai_whisper_coreml_tpu_torch.eval import harness
    from openai_whisper_coreml_tpu_torch.utils.checkpoint import save_params

    spec_tool = tool("torch_spec_acceptance_trained")
    phrases = spec_tool.PHRASES_SHORT
    t = time.perf_counter()
    with main_path("trained pair training", kernels, idle=TRAIN_IDLE):
        target, draft, rep_t, rep_d = spec_tool.train_pair(
            "tiny", phrases, steps=400, draft_steps=400, batch=8,
            target_loss=spec_tool.TARGET_LOSS, device="cuda", emit=log)
    log(f"trained pair on {card()}: target {rep_t}, draft {rep_d}, "
        f"{time.perf_counter() - t:.1f} s")
    save_params(target, ckpt, model_name="tiny")
    quiet = dict(batch_size=8, language="en", without_timestamps=True,
                 temperature=(0.0,), logprob_threshold=None,
                 compression_ratio_threshold=None, no_speech_threshold=None)
    reports, results = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        write_tone_corpus(tmp, phrases, spec_tool.tone_audio, 8)
        with capture_batches() as runs, main_path("trained pair evaluate", kernels,
                                                  idle=FP32_IDLE):
            reports["plain"] = harness.evaluate(target, tmp, **quiet)
        results["plain"] = runs[-1]
        before = dict(speculative.TOTALS)
        target.draft = draft
        try:
            with capture_batches() as runs, main_path(
                    "trained pair evaluate, draft K=4", kernels, idle=FP32_IDLE):
                reports["spec"] = harness.evaluate(
                    target, tmp, spec_k=4, spec_fallback=False, **quiet)
        finally:
            target.draft = None
        results["spec"] = runs[-1]
    spent = {k: speculative.TOTALS[k] - before[k] for k in before}
    acceptance = (spent["tokens"] - spent["iters"]) / max(spent["drafted"], 1)
    per_iter = spent["tokens"] / max(spent["iters"], 1)
    for name, report in reports.items():
        check_report(report, 8, f"trained pair evaluate ({name})")
    cores = spec_tool.Cores(target, draft, spec_tool.horizon(target.cfg, phrases))
    (race,) = spec_tool.race(cores, spec_tool.held_out(phrases, 8)[0], [4], repeats=3)
    out = {"target": rep_t, "draft": rep_d,
           "wer_plain": reports["plain"]["wer"], "wer_spec": reports["spec"]["wer"],
           "acceptance_rate": acceptance, "tokens_per_iter": per_iter, "spec": spent,
           "rtfx_plain": reports["plain"]["rtfx"], "rtfx_spec": reports["spec"]["rtfx"],
           "race_b8_k4": race, "card": card()}
    log("trained pair: " + json.dumps(out))
    if tokens_of(results["spec"]) != tokens_of(results["plain"]):
        raise AssertionError("speculative tokens differ from plain on the trained pair")
    if max(out["wer_plain"], out["wer_spec"]) > WER_GATE:
        raise AssertionError(f"trained pair WER {out['wer_plain']}, {out['wer_spec']} "
                             f"above {WER_GATE}: {reports}")
    if not acceptance >= ACCEPTANCE_GATE or not race["token_exact_vs_plain"]:
        raise AssertionError(f"trained pair acceptance {acceptance} below "
                             f"{ACCEPTANCE_GATE}, or race tokens differ: {race}")
    log(f"trained pair on {card()}: {per_iter:.3f} tokens per iteration at K = 4 "
        f"(acceptance {acceptance:.4f}) against a break-even of "
        f"{race['break_even_tokens_per_iter']:.3f} ({race['spec_ms_per_iter']:.3f} ms "
        f"an iteration over {race['plain_ms_per_token']:.3f} ms a plain token, B = 8)")
    del target, draft
    torch.cuda.empty_cache()
    return out


# a profile's CUDA kernels of each hand-written kernel, by name (csrc/)
TRACE_KERNELS = {"log_mel": "log_mel_kernel", "flash_attention": "fa_fwd_bf16_kernel",
                 "sqa": "sqa_kernel"}


# torch.profiler traces this process has started: profile_slice logs the
# records its trace lost at its start beside the count
PROFILER_TRACES = [0]


def count_profiler_traces() -> None:
    """Count every torch.profiler trace this process starts."""
    from torch.profiler import profile

    start = profile.start

    def counting_start(self):
        PROFILER_TRACES[0] += 1
        return start(self)

    profile.start = counting_start


def profile_slice(kernels, ckpt: str) -> dict:
    """The CLI with `--profile-dir` on one 8 s held-out tone of the trained
    tiny target (`ckpt`) with bf16 activations, int8 weights and cross-KV
    and a bf16 cache: a trace file is written, and its CUDA kernel events
    name K4 (log_mel_kernel), K1 (fa_fwd_bf16_kernel) and K3/K6
    (sqa_kernel) as often as the path launched them."""
    from openai_whisper_coreml_tpu_torch import cli
    from openai_whisper_coreml_tpu_torch.utils import profiling
    from openai_whisper_coreml_tpu_torch.utils.audio_io import save_wav

    spec_tool = tool("torch_spec_acceptance_trained")
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "tone.wav")
        save_wav(wav, spec_tool.tone_audio(2, seed=901))
        trace_dir = os.path.join(tmp, "trace")
        with main_path("cli --profile-dir", kernels) as calls:
            rc = cli.main([wav, "--model", "tiny", "--checkpoint", ckpt,
                           "--quantize", "int8", "--kv-dtype", "int8",
                           "--dtype", "bfloat16", "--language", "en",
                           "--without-timestamps",
                           "--temperature-increment-on-fallback", "0",
                           "--output-format", "txt", "--output-dir", tmp,
                           "--profile-dir", trace_dir])
        launches = read_counts(kernels)
        if rc != 0:
            raise AssertionError(f"cli --profile-dir returned {rc}")
        traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
        if len(traces) != 1:
            raise AssertionError(f"--profile-dir wrote {os.listdir(trace_dir)}")
        path = os.path.join(trace_dir, traces[0])
        size = os.path.getsize(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        with open(os.path.join(tmp, "tone.txt"), encoding="utf-8") as f:
            text = f.read().strip()
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(v in n for n in names) for k, v in TRACE_KERNELS.items()}
    want = {"log_mel": launches["log_mel"], "flash_attention": launches["flash_attention"],
            "sqa": launches["sqa_self"] + launches["sqa_int8"]}
    # device_trace's opening region: a zero fill and the marker kernels,
    # of which the profiler's loss at the trace's start takes the first
    region = [e for e in events
              if e.get("name") == "device_trace_markers" and e.get("ph") == "X"]
    if not region:
        raise AssertionError("the trace has no device_trace_markers region")
    lo = min(e["ts"] for e in region)
    hi = max(e["ts"] + e["dur"] for e in region)
    launched = profiling._MARKER_KERNELS + 1
    markers = sum(lo <= e["ts"] <= hi for e in events if e.get("cat") == "kernel")
    log(f"cli --profile-dir on {card()}: {size} bytes, {len(events)} events, "
        f"{len(names)} CUDA kernel events; hand-written kernels in the trace {found}, "
        f"launched {want}; transcript {text[:200]!r}; trace {PROFILER_TRACES[0]} "
        f"of this process: {markers} of its {launched} marker kernels in the trace, "
        f"{launched - markers} lost at its start")
    if found != want or not all(want.values()):
        raise AssertionError(f"the trace names kernels {found}, launched {want}")
    return {"trace_bytes": size, "kernel_events": len(names), "found": found,
            "trace_of_process": PROFILER_TRACES[0], "markers_found": markers,
            "markers_launched": launched}


def serve_audio() -> np.ndarray:
    """Four 30 s windows of noise: the serve path's and spec_decode's."""
    return (np.random.default_rng(0).standard_normal((4, 480_000)) * 0.1
            ).astype(np.float32)


def serve_slice(wt, model, kernels) -> dict:
    """Returns the batch-4 224-token decode's walls: the whole call's and
    its decode core's (`speculative.LAST_TIMING`), the plain loop that
    spec_decode compares with."""
    from openai_whisper_coreml_tpu_torch import speculative

    cfg = model.cfg
    audio = serve_audio()
    opts = wt.DecodingOptions(language="en", kv_dtype="int8", sample_len=224)
    # shortened from 224 tokens to keep the whole run near four minutes
    short = dataclasses.replace(opts, sample_len=64)
    outputs = []
    plain = {}
    with main_path("serve", kernels) as calls:
        for name, fn in (
                ("decode batch 4", lambda: model.decode(model.log_mel(audio), opts)),
                ("decode batch 1 (64 tokens)",
                 lambda: model.decode(model.log_mel(audio[:1]), short)),
                ("detect_language batch 4",
                 lambda: model.detect_language(model.log_mel(audio)))):
            t = time.perf_counter()
            outputs.append(fn())
            torch.cuda.synchronize()
            log(f"{name}: {time.perf_counter() - t:.3f} s wall")
            if not plain:
                plain = {"wall_s": time.perf_counter() - t,
                         "core": dict(speculative.LAST_TIMING)}
    if calls["encode"] != 3:
        raise AssertionError(f"serve: {calls['encode']} encoder calls, expected 3")

    results = outputs[0] + outputs[1]
    codes, probs = outputs[2]
    for r in results:
        if not (r.tokens and all(0 <= t < cfg.n_vocab for t in r.tokens)):
            raise AssertionError(f"tokens outside the vocab: {r.tokens[:16]}")
        if not (np.isfinite(r.avg_logprob) and 0.0 <= r.no_speech_prob <= 1.0):
            raise AssertionError(f"non-finite decode result {r}")
    if len(codes) != 4 or not all(abs(sum(p.values()) - 1.0) < 1e-3 for p in probs):
        raise AssertionError(f"language ID failed: {codes}")
    log(f"served tokens per row {[len(r.tokens) for r in results]}; "
        f"languages {codes}")
    feats = model.encode(model.log_mel(audio[:1]))
    logits = model.logits([[cfg.sot_token, cfg.lang_token_start,
                            cfg.transcribe_token]], feats)
    if not (logits.shape == (1, 3, cfg.n_vocab) and torch.isfinite(logits).all()):
        raise AssertionError("non-finite large-v3 logits")
    return plain


def check_segments(result, cfg, duration, words=False):
    """Schema, ids, times and tokens of a result. With words a segment's
    start moves to its first word's (openai), so starts need not grow
    within a window; seeks still do."""
    segs = result["segments"]
    if not segs or set(result) < {"text", "segments", "language", "duration"}:
        raise AssertionError(f"transcribe result without segments: {result}")
    if abs(result["duration"] - duration) > 0.05:
        raise AssertionError(f"duration {result['duration']} != {duration}")
    if [s["id"] for s in segs] != list(range(len(segs))):
        raise AssertionError("segment ids are not 0..n-1")
    for prev, s in zip([None] + segs, segs):
        if not (0 <= s["start"] <= s["end"] <= duration + 30):
            raise AssertionError(f"segment times out of order: {s}")
        if prev is not None and (s["seek"] < prev["seek"]
                                 or (s["start"] < prev["start"] and not words)):
            raise AssertionError(f"segments not monotone: {prev} then {s}")
        if not all(0 <= t < cfg.n_vocab for t in s["tokens"]):
            raise AssertionError(f"tokens outside the vocab: {s['tokens']}")
        if not (np.isfinite(s["avg_logprob"]) and 0 <= s["no_speech_prob"] <= 1):
            raise AssertionError(f"non-finite segment scores: {s}")


def transcribe_slice(model, kernels):
    import importlib

    tr = importlib.import_module("openai_whisper_coreml_tpu_torch.transcribe")
    cfg = model.cfg
    audio = speechy(70, 3)
    rungs = []
    real_decode = tr.decode

    def recording_decode(model_, feats, opts, **kw):
        rungs.append(opts.temperature)
        return real_decode(model_, feats, opts, **kw)

    tr.decode = recording_decode
    try:
        with main_path("transcribe", kernels) as calls:
            result = model.transcribe(audio, kv_dtype="int8", temperature=(0.0, 0.4),
                                      beam_size=2, best_of=2, sample_len=32)
    finally:
        tr.decode = real_decode
    check_segments(result, cfg, 70.0)
    windows = calls["encode"] - 1  # the first encode is language ID
    if calls["log_mel"] != 1 or windows < 3:
        raise AssertionError(f"transcribe: {calls}; expected one log-mel call "
                             f"and three windows or more")
    log(f"large-v3 transcribe of 70 s: {windows} windows, language "
        f"{result['language']}, rungs {rungs}, {len(result['segments'])} "
        f"segments, segment temperatures "
        f"{[s['temperature'] for s in result['segments']]}")


def serve_batch_slice(wt, model, kernels):
    """Six requests (10-70 s) through transcribe_batch: the static scheduler
    with the bf16 self-cache (K3 + K6), then the continuous scheduler with
    the int8 self-cache (K6 only), then beam 2 under the continuous
    scheduler with the int8 self-cache (K6 only; gate failures requeue into
    the sampled engine at t=0.4)."""
    cfg = model.cfg
    seconds = (10, 20, 35, 50, 65, 70)
    audios = [speechy(s, 30 + i) for i, s in enumerate(seconds)]
    runs = (("serve_batch static", dict(scheduler="static"), SERVING_IDLE),
            ("serve_batch continuous", dict(scheduler="continuous",
                                            cache_dtype="int8", chunk_tokens=16),
             SERVING_IDLE + ("sqa_self",)),
            ("serve_batch continuous beam", dict(scheduler="continuous", beam_size=2,
                                                 cache_dtype="int8", chunk_tokens=16),
             SERVING_IDLE + ("sqa_self",)))
    # 16-token windows (24 before the speculative paths joined, 48 before
    # the beam run did): the script stays near half its time limit on a
    # slow host
    for name, kw, idle in runs:
        opts = wt.ServeOptions(batch_size=4, sample_len=16, language="en",
                               temperature=(0.0, 0.4), kv_dtype="int8", **kw)
        with main_path(name, kernels, idle=idle) as calls:
            results = wt.transcribe_batch(model, audios, opts)
        for r, s in zip(results, seconds):
            check_segments(r, cfg, float(s))
        log(f"{name}: {calls['encode']} encoder calls, {calls['steps']} "
            f"single-token steps; segments per request "
            f"{[len(r['segments']) for r in results]}; temperatures "
            f"{sorted({seg['temperature'] for r in results for seg in r['segments']})}")


def check_words(result, name):
    """Every segment carries words; each word has start <= end inside the
    audio, starts do not decrease within a segment, and the result has
    words at all. Returns their count."""
    n = 0
    for s in result["segments"]:
        if "words" not in s:
            raise AssertionError(f"{name}: a segment without words: {s}")
        prev = 0.0
        for w in s["words"]:
            if not (prev <= w["start"] <= w["end"] <= result["duration"] + 1e-6
                    and 0.0 <= w["probability"] <= 1.0):
                raise AssertionError(f"{name}: word out of order or outside the "
                                     f"audio: {w} in {s}")
            prev = w["start"]
            n += 1
    if n == 0:
        raise AssertionError(f"{name}: no words")
    return n


def words_slice(wt, model, kernels):
    """Word timestamps at large-v3 (int8 weights, bf16): transcribe of 70 s
    with hallucination_silence_threshold=2.0 (the words on each window's own
    features), then transcribe_batch of the six requests under the
    continuous scheduler with the int8 cache (each request's windows
    encoded again, batch_size at a time, and aligned together). Each
    alignment forward launches K1's causal mode once per decoder layer,
    counted exactly; K1 counts the re-encodes."""
    cfg = model.cfg
    audio = speechy(70, 3)
    with main_path("transcribe words", kernels,
                   idle=WORDS_IDLE + ("sqa_self",)) as calls:
        result = model.transcribe(audio, kv_dtype="int8", temperature=(0.0, 0.4),
                                  sample_len=16, word_timestamps=True,
                                  hallucination_silence_threshold=2.0)
    check_segments(result, cfg, 70.0, words=True)
    n = check_words(result, "transcribe words")
    if calls["align_forwards"] == 0 or calls["encode"] < 2:
        raise AssertionError(f"transcribe words: {calls}")
    log(f"large-v3 transcribe of 70 s with words: {calls['encode'] - 1} windows, "
        f"{calls['align_forwards']} alignment forwards, {len(result['segments'])} "
        f"segments, {n} words")

    seconds = (10, 20, 35, 50, 65, 70)
    audios = [speechy(sec, 30 + i) for i, sec in enumerate(seconds)]
    opts = wt.ServeOptions(batch_size=4, sample_len=16, language="en",
                           temperature=(0.0, 0.4), kv_dtype="int8",
                           scheduler="continuous", cache_dtype="int8",
                           chunk_tokens=16, word_timestamps=True)
    with main_path("serve_batch continuous words", kernels,
                   idle=WORDS_IDLE + ("sqa_self",)) as calls:
        results = wt.transcribe_batch(model, audios, opts)
    words = []
    for r, sec in zip(results, seconds):
        check_segments(r, cfg, float(sec), words=True)
        words.append(check_words(r, "serve_batch continuous words"))
    log(f"serve_batch continuous with words: {calls['encode']} encoder calls, "
        f"{calls['align_forwards']} alignment forwards, {calls['steps']} steps; "
        f"words per request {words}")


def cli_slice(kernels):
    """The CLI on a 35 s WAV at large-v3 int8 with word timestamps and the
    large-v3-turbo draft (`--draft-model large-v3-turbo --spec-k 4`): the
    draft loads through load_model and decodes under the call's governor."""
    from openai_whisper_coreml_tpu_torch import cli, speculative
    from openai_whisper_coreml_tpu_torch.config import get_config
    from openai_whisper_coreml_tpu_torch.utils.audio_io import save_wav

    cfg = get_config("large-v3")
    spec_before = dict(speculative.TOTALS)
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "clip.wav")
        save_wav(wav, speechy(35, 5))  # two windows: the seek runs on the card
        with main_path("cli", kernels, idle=WORDS_IDLE) as calls:
            rc = cli.main([wav, "--model", "large-v3", "--quantize", "int8",
                           "--kv-dtype", "int8", "--dtype", "bfloat16",
                           "--temperature-increment-on-fallback", "0",
                           "--output-format", "all", "--language", "en",
                           "--word-timestamps", "--max-line-width", "42",
                           "--highlight-words", "--draft-model", "large-v3-turbo",
                           "--spec-k", str(SPEC_K), "--output-dir", tmp])
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        sizes = {}
        for fmt in ("txt", "srt", "vtt", "tsv", "json"):
            path = os.path.join(tmp, f"clip.{fmt}")
            sizes[fmt] = os.path.getsize(path)
        with open(os.path.join(tmp, "clip.json"), encoding="utf-8") as f:
            result = json.load(f)
        subtitles = {}
        for fmt in ("srt", "vtt"):
            with open(os.path.join(tmp, f"clip.{fmt}"), encoding="utf-8") as f:
                subtitles[fmt] = f.read()
    check_segments(result, cfg, 35.0, words=True)
    n_words = check_words(result, "cli")
    if (not subtitles["vtt"].startswith("WEBVTT") or min(sizes.values()) == 0
            or not all("<u>" in text for text in subtitles.values())):
        raise AssertionError(f"cli output files: {sizes}")
    if calls["encode"] < 2:
        raise AssertionError(f"cli: {calls['encode']} windows encoded, expected 2")
    spec = {k: speculative.TOTALS[k] - spec_before[k] for k in spec_before}
    if spec["iters"] == 0:
        raise AssertionError("cli --draft-model ran no speculative decode")
    log(f"cli wrote {sizes} bytes; {len(result['segments'])} segments, {n_words} "
        f"words, {calls['align_forwards']} alignment forwards; speculative {spec}")


def wav_bytes(audio: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(SR)
        wf.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def http(srv, path, body=None, headers=None):
    """(status, body bytes) of one request to the in-process server; an
    HTTP error status is returned, not raised."""
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=body,
                                 headers=headers or {},
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def multipart(fields: dict, data: bytes):
    bound = "chipsmokeboundary"
    body = b"".join(f"--{bound}\r\nContent-Disposition: form-data; name=\"{k}\""
                    f"\r\n\r\n{v}\r\n".encode() for k, v in fields.items())
    body += (f"--{bound}\r\nContent-Disposition: form-data; name=\"file\"; "
             f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode()
    body += data + f"\r\n--{bound}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={bound}"}


def server_routes(srv, name, short, temperature=None):
    """The server's other routes on one short WAV: word timestamps on
    /transcribe and as verbose_json words on /v1/audio/transcriptions,
    the OpenAI route as json and srt, /detect; each request at
    `temperature` when given (one rung), else the server's ladder. Returns
    (the words on /transcribe, the verbose_json answer)."""
    query = "" if temperature is None else f"&temperature={temperature}"
    form = {} if temperature is None else {"temperature": temperature}
    code, raw = http(srv, "/transcribe?word_timestamps=1" + query, short)
    if code != 200:
        raise AssertionError(f"{name}: word timestamps answered {code} {raw!r}")
    worded = json.loads(raw)
    n_words = check_words(worded, f"{name} /transcribe words")
    code, raw = http(srv, "/v1/audio/transcriptions", *multipart(
        {"language": "en", "response_format": "verbose_json",
         "timestamp_granularities[]": "word", **form}, short))
    verbose = json.loads(raw) if code == 200 else {}
    if code != 200 or verbose.get("words") != [
            w for seg in verbose["segments"] for w in seg["words"]]:
        raise AssertionError(f"{name}: verbose_json words answered {code} "
                             f"{raw[:300]!r}")
    check_words(verbose, f"{name} verbose_json words")
    outs = {}
    for fmt in ("json", "srt"):
        code, outs[fmt] = http(srv, "/v1/audio/transcriptions",
                               *multipart({"language": "en",
                                           "response_format": fmt, **form}, short))
        if code != 200:
            raise AssertionError(f"{name}: /v1/audio/transcriptions {fmt}: "
                                 f"{code} {outs[fmt][:200]!r}")
    if set(json.loads(outs["json"])) != {"text"} or b"-->" not in outs["srt"]:
        raise AssertionError(f"{name}: OpenAI answers {outs}")
    code, raw = http(srv, "/detect", short)
    detected = json.loads(raw)
    if code != 200 or detected["language"] not in detected["probs"]:
        raise AssertionError(f"{name}: /detect answered {code} {raw!r}")
    return n_words, verbose


def server_slice(model, kernels, name, options, idle, spec=False):
    """The HTTP server in-process on the loopback at large-v3 int8
    (`WhisperHTTPServer(model, port=0, batch_size=4, warmup=True)`):
    /readyz 503 then 200; four concurrent /transcribe WAV POSTs of 10-25 s,
    micro-batched into fewer batches than requests, with a /stream of 6 s
    in flight beside them; word timestamps on /transcribe and as
    verbose_json words on /v1/audio/transcriptions (K1's causal mode);
    /v1/audio/transcriptions as json and srt, /detect, /metrics in
    Prometheus form; then stop(). Launches are read after the requests.
    spec: the model carries a draft (`--draft-model` in-process), and the
    run is cut to what the draft changes: no warmup, two /transcribe POSTs
    of 10 and 15 s in one batch that decodes speculatively (options with
    spec_fallback off: a governor would withhold the floor draft), the
    /stream beside them ticking under the stream's own governor, and
    /metrics, which must hold the speculative counters and gauges."""
    from openai_whisper_coreml_tpu_torch.serve_http import WhisperHTTPServer

    cfg = model.cfg
    # one window each: the requests fit one batch
    seconds = (10, 15) if spec else (10, 15, 20, 25)
    audios = [speechy(sec, 60 + i) for i, sec in enumerate(seconds)]
    n_words, verbose = 0, {"words": []}
    with main_path(name, kernels, idle=idle) as calls:
        srv = WhisperHTTPServer(model, port=0, batch_size=4, batch_window_ms=300,
                                warmup=not spec, default_options=options)
        t0 = time.perf_counter()
        srv.start()
        try:
            first = http(srv, "/readyz")[0]
            while http(srv, "/readyz")[0] != 200:
                if time.perf_counter() - t0 > 600:
                    raise AssertionError(f"{name}: /readyz never turned 200")
                time.sleep(0.05)
            warm_s = time.perf_counter() - t0
            if first != (200 if spec else 503):
                raise AssertionError(f"{name}: /readyz was {first} at start")
            batches0 = srv.metrics.counter("batches_total")
            results = [None] * (len(audios) + 1)

            def post(i):
                if i < len(audios):
                    results[i] = http(srv, "/transcribe", wav_bytes(audios[i]))
                else:  # the stream, while the batch is in flight
                    time.sleep(0.5)
                    results[i] = http(srv, "/stream?language=en",
                                      wav_bytes(speechy(6, 70)))

            t1 = time.perf_counter()
            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(len(results))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            batch_s = time.perf_counter() - t1
            if any(t.is_alive() for t in threads) or any(
                    r is None or r[0] != 200 for r in results):
                raise AssertionError(f"{name}: requests failed: "
                                     f"{[r and (r[0], r[1][:200]) for r in results]}")
            batches = srv.metrics.counter("batches_total") - batches0
            for (_, raw), sec in zip(results, seconds):
                check_segments(json.loads(raw), cfg, float(sec))
            lines = [json.loads(line) for line in results[-1][1].decode().splitlines()
                     if line]
            if not lines or lines[-1]["final"] is not True or any("error" in x
                                                                  for x in lines):
                raise AssertionError(f"{name}: /stream answered {lines}")
            if batches >= len(audios):
                raise AssertionError(f"{name}: {batches} batches for {len(audios)} "
                                     f"requests: not micro-batched")
            if not spec:
                n_words, verbose = server_routes(srv, name, wav_bytes(audios[0]))
            code, prom = http(srv, "/metrics?format=prometheus")
            prom = prom.decode()
            if code != 200 or "whisper_tpu_requests_total" not in prom:
                raise AssertionError(f"{name}: /metrics answered {code} {prom[:200]}")
            if spec and not all(f"whisper_tpu_{m}" in prom for m in (
                    "spec_tokens", "spec_iters", "spec_tokens_per_iter",
                    "spec_acceptance_rate")):
                raise AssertionError(f"{name}: /metrics without the speculative "
                                     f"counters: {prom}")
            health = json.loads(http(srv, "/healthz")[1])
            if health["backend"] != model.device.type:
                raise AssertionError(f"{name}: /healthz {health}")
        finally:
            srv.stop()
    snap = srv.metrics.snapshot()
    log(f"{name}: warmup {warm_s:.3f} s; {len(audios)} /transcribe and a 6 s /stream in "
        f"{batch_s:.3f} s wall, {batches:.0f} batch(es); stream lines {len(lines)}; "
        f"words {n_words} on /transcribe, {len(verbose['words'])} in verbose_json; "
        f"batch latency {snap['summaries']['batch_latency_s']}; {calls['steps']} "
        f"single-token steps; counters {snap['counters']}")


def multistream_slice(model, kernels):
    """Two live streams of 4 s (different audio) through
    MultiStreamTranscriber's poll loop, 1 s chunks: each tick one K4 call
    and one encode (K1) for the due streams, K3 per step (streams decode
    with a bf16 cross-KV and cache, as in JAX, so K6 stays idle); then both
    flushes."""
    import openai_whisper_coreml_tpu_torch as wt

    cfg = model.cfg
    audios = [speechy(4, 80), speechy(4, 81)]
    with main_path("multistream", kernels,
                   idle=SERVING_IDLE + ("sqa_int8",)) as calls:
        mst = wt.MultiStreamTranscriber(model, n_streams=2, language="en")
        events = {0: [], 1: []}
        ticks = 0
        t = time.perf_counter()
        for off in range(0, 4 * SR, SR):
            for i, a in enumerate(audios):
                mst.feed(i, a[off:off + SR])
            got = mst.poll()
            ticks += 1
            for i, evs in got.items():
                events[i] += evs
        for i in events:
            events[i] += mst.finish(i)
        seconds = time.perf_counter() - t
    for evs in events.values():
        if not evs or not evs[-1].is_final or not all(
                0 <= tok < cfg.n_vocab for e in evs for tok in e.tokens):
            raise AssertionError(f"multistream events {events}")
    if calls["log_mel"] != ticks + 2:
        raise AssertionError(f"multistream: {calls['log_mel']} log-mel calls for "
                             f"{ticks} ticks and 2 flushes")
    log(f"multistream: {ticks} ticks + 2 flushes in {seconds:.3f} s; events per "
        f"stream {[len(e) for e in events.values()]}; {calls['steps']} steps")


def cli_stream_slice(kernels):
    """`cli.main --stream` on a 5 s WAV at large-v3 int8: 1 s chunks
    through StreamingTranscriber, confirmed text printed as it comes (K4 and
    K1 per tick, K3 per step; bf16 cross-KV and cache, as in JAX)."""
    from openai_whisper_coreml_tpu_torch import cli
    from openai_whisper_coreml_tpu_torch.config import get_config
    from openai_whisper_coreml_tpu_torch.utils.audio_io import save_wav

    cfg = get_config("large-v3")
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "stream.wav")
        save_wav(wav, speechy(5, 9))
        with main_path("cli --stream", kernels,
                       idle=SERVING_IDLE + ("sqa_int8",)) as calls:
            with contextlib.redirect_stdout(out):
                rc = cli.main([wav, "--stream", "--model", "large-v3", "--quantize",
                               "int8", "--dtype", "bfloat16", "--language", "en"])
    text = out.getvalue()
    if rc != 0 or not text.endswith("\n") or calls["log_mel"] != 6:
        raise AssertionError(f"cli --stream: rc {rc}, {calls}, output {text!r}")
    log(f"cli --stream of 5 s: {calls['log_mel']} decodes (5 ticks and the flush), "
        f"{calls['steps']} steps; printed {len(text)} characters")


SPEC_K = 4


def load_draft(wt, model):
    """The large-v3 target's draft: large-v3-turbo with int8 weights from
    seed 1 (its encoder's width and context are the target's, so it shares
    the target's features and runs no encoder)."""
    draft = wt.load_model("large-v3-turbo", dtype=torch.bfloat16, quantize="int8",
                          seed=1, device="cuda")
    wt.check_pair(model.cfg, draft.cfg)
    return draft


def check_grammar(results, cfg, name):
    """Every token in the vocabulary, below EOT (the harvest cut it), no
    special token, and timestamps that never decrease."""
    for r in results:
        stamps = [t for t in r.tokens if t >= cfg.timestamp_begin]
        if not (all(0 <= t < cfg.n_vocab for t in r.tokens)
                and all(t < cfg.eot_token or t >= cfg.timestamp_begin
                        for t in r.tokens)
                and stamps == sorted(stamps)
                and np.isfinite(r.avg_logprob)):
            raise AssertionError(f"{name}: tokens outside the grammar: {r.tokens[:32]}")


@contextlib.contextmanager
def walk_pairs(cfg, k: int, sample_len: int):
    """Replay the greedy speculative loop's acceptance walk from its rule
    calls (`speculative._apply_logit_rules`): an iteration filters the
    commit's logits, then the draft's K proposals' (T = 1 steps), then the
    verify's K columns (one T = K+1 step), and draft j and column j predict
    one position from one prefix. Yields a dict; on exit "mismatches" holds
    one entry per rejected proposal (a live row still accepting whose two
    filtered argmaxes differ): row, position, both picks, the verify's and
    the draft's margin between them (inf where the rules masked the other
    pick there), bf16's spacing at the picks' logits and, for a masked
    pick between text and a timestamp, the timestamp rule's own margin
    ("ts_rule_gap"); "accepted" the proposals the replay accepts, which
    must be the decode's n_sampled - n_iters. The replay's positions must
    be the loop's, iteration by iteration."""
    from openai_whisper_coreml_tpu_torch import speculative
    from openai_whisper_coreml_tpu_torch.decoding import NEG_INF

    rules = speculative._apply_logit_rules
    calls, out = [], {"mismatches": [], "accepted": 0}
    masked = NEG_INF / 2  # the rules mask with NEG_INF, a finite number

    def recording(logits, tokens, pos, cfg_, prompt_len, *args):
        filt = rules(logits, tokens, pos, cfg_, prompt_len, *args)
        calls.append((pos.clone(), filt, prompt_len))
        return filt

    speculative._apply_logit_rules = recording
    try:
        yield out
    finally:
        speculative._apply_logit_rules = rules
    per_iter = 1 + 2 * k
    if not calls or len(calls) % per_iter:
        raise AssertionError(f"walk_pairs: {len(calls)} rule calls, not a "
                             f"multiple of {per_iter}")
    eot, total_len = cfg.eot_token, calls[0][2] + sample_len
    finished = None
    for i in range(0, len(calls), per_iter):
        pos = calls[i][0].cpu().numpy()
        if finished is None:
            finished = np.zeros(pos.shape, bool)
        elif not np.array_equal(pos, new_pos):
            raise AssertionError(f"walk_pairs: replayed positions {new_pos}, "
                                 f"the loop's {pos}")
        g = calls[i][1].argmax(dim=-1).cpu().numpy()
        accepting = ~(finished | (g == eot) | (pos + 1 >= total_len))
        eot_hit = (g == eot) & ~finished
        acc = np.zeros(pos.shape, np.int64)
        for j in range(k):
            d_filt, v_filt = calls[i + 1 + j][1], calls[i + 1 + k + j][1]
            dp, vp = d_filt.argmax(dim=-1), v_filt.argmax(dim=-1)
            picks = torch.stack([dp, vp], dim=1)
            d_at = d_filt.gather(1, picks).cpu().numpy()  # at (dp, vp)
            v_at = v_filt.gather(1, picks).cpu().numpy()
            dp, vp = dp.cpu().numpy(), vp.cpu().numpy()
            match = accepting & (dp == vp)
            for row in np.nonzero(accepting & (dp != vp))[0]:
                both = np.concatenate([d_at[row], v_at[row]])
                scale = float(np.max(np.abs(both[both > masked])))
                m = {"row": int(row), "pos": int(pos[row] + j + 1),
                     "draft_pick": int(dp[row]), "verify_pick": int(vp[row]),
                     "verify_margin": (float(v_at[row, 1] - v_at[row, 0])
                                       if v_at[row, 0] > masked else np.inf),
                     "draft_margin": (float(d_at[row, 0] - d_at[row, 1])
                                      if d_at[row, 1] > masked else np.inf),
                     "bf16_spacing": float(2.0 ** (np.floor(np.log2(scale)) - 7)),
                     "ts_rule_gap": None}
                if np.isinf(m["verify_margin"]) or np.isinf(m["draft_margin"]):
                    # a pick the other side's rules masked: where one side
                    # picked text and the other a timestamp, the text side's
                    # timestamp mass less its best text logprob, the rule's
                    # own margin (it masks text when this is above 0)
                    text = [f for f, p_ in ((d_filt, dp), (v_filt, vp))
                            if p_[row] < cfg.timestamp_begin]
                    if len(text) == 1:
                        lp = torch.log_softmax(text[0][row], dim=-1)
                        ts = cfg.timestamp_begin
                        m["ts_rule_gap"] = float(torch.logsumexp(lp[ts:], dim=-1)
                                                 - lp[:ts].max())
                out["mismatches"].append(m)
            acc += match
            eot_hit |= match & (dp == eot)
            accepting = match & (dp != eot) & (pos + j + 2 < total_len)
        new_pos = np.where(finished, pos, pos + acc + 1)
        finished = finished | eot_hit | (new_pos >= total_len)
        out["accepted"] += int(acc.sum())


# a self-draft's rejected proposal in bf16 is a near-tie of the T = 1 and
# T = K+1 graphs' rounding when the two picks' logits lie within this many
# bf16 spacings in both; a fault in the verify path (a wrong mask, cache
# column or scale) moves a logit by O(1), tens of spacings
SELF_DRAFT_BF16_SPACINGS = 16


def check_near_ties(walk, stats, name, bound) -> None:
    """The replay accepted what the decode did, and every rejected
    proposal is a near-tie within bound(mismatch): both margins, or, where
    one side's rules masked the other's pick, the timestamp rule's margin
    (any other masked pick is a rule applied differently, not rounding)."""
    if walk["accepted"] != stats["tokens"] - stats["iters"]:
        raise AssertionError(f"{name}: the replay accepted {walk['accepted']}, "
                             f"the decode {stats['tokens'] - stats['iters']}")

    def near(m):
        gap = m["ts_rule_gap"]
        if gap is not None:
            return abs(gap) <= bound(m)
        return max(m["verify_margin"], m["draft_margin"]) <= bound(m)

    far = [m for m in walk["mismatches"] if not near(m)]
    if far:
        raise AssertionError(f"{name}: rejected proposals that are no near-tie: "
                             f"{far}")


def spec_decode_slice(wt, model, draft, kernels, plain) -> dict:
    """Speculative decoding at large-v3's full width: the int8 target and
    the large-v3-turbo draft, K = 4, serve's four 30 s windows, 224-token
    greedy, through `decoding.decode(draft=...)`. A main path, and held
    exactly: each loop iteration runs K+1 single-token draft steps, each
    one K3 launch (its bf16 cache) and one K6 launch (its int8 cross-KV)
    per draft layer, and the verify step (T = K+1) launches none; the
    iterations are the slowest row's (`LAST_TIMING["units"]`). Prints
    tokens per iteration, the acceptance rate (the random weights' floor)
    and the walls against serve's plain decode of the same windows. Then
    the target as its own draft: acceptance at least 0.9 in bf16, and each
    rejected proposal, replayed from the walk's rule calls (walk_pairs),
    printed with its margins and held to be a near-tie of the T=1 and
    T=K+1 graphs' rounding (check_near_ties); then a sampled rung at
    t = 0.4 with the self-draft, twice with one seed: the same tokens, in
    the grammar."""
    from openai_whisper_coreml_tpu_torch import decoding, speculative

    cfg = model.cfg
    audio = serve_audio()
    opts = wt.DecodingOptions(language="en", kv_dtype="int8", sample_len=224,
                              spec_k=SPEC_K)
    with main_path("spec_decode", kernels) as calls:
        t = time.perf_counter()
        mel = model.log_mel(audio)
        before = read_counts(kernels)
        results = decoding.decode(model, mel, opts, draft=draft)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launched = {k: n - before[k] for k, n in read_counts(kernels).items()}
    timing, stats = dict(speculative.LAST_TIMING), dict(speculative.LAST_STATS)
    want = draft.cfg.n_text_layer * (SPEC_K + 1) * timing["units"]
    if (timing["path"] != "spec" or calls["encode"] != 1
            or launched["sqa_self"] != want or launched["sqa_int8"] != want):
        raise AssertionError(f"spec_decode: {timing}, {calls}, launches {launched}, "
                             f"expected {want} K3 and K6 launches")
    check_grammar(results, cfg, "spec_decode")
    record = {"tokens_per_iter": stats["tokens_per_iter"],
              "acceptance_rate": stats["acceptance_rate"], "iters": timing["units"],
              "wall_s": wall, "core_s": timing["wall_s"],
              "ms_per_iter": timing["wall_s"] * 1e3 / timing["units"],
              "plain_wall_s": plain["wall_s"], "plain_core_s": plain["core"]["wall_s"],
              "plain_ms_per_token": plain["core"]["wall_s"] * 1e3
              / plain["core"]["units"]}
    log(f"[spec_decode] large-v3 int8 + large-v3-turbo draft, K={SPEC_K}, B=4, 224 "
        f"tokens on {card()}: {stats['tokens_per_iter']:.4f} tokens/iteration, "
        f"acceptance {stats['acceptance_rate']:.4f} (random-weights floor), "
        f"{timing['units']} iterations, {record['ms_per_iter']:.3f} ms/iteration; "
        f"wall {wall:.3f} s (core {timing['wall_s']:.3f} s) against the plain loop's "
        f"{plain['wall_s']:.3f} s (core {plain['core']['wall_s']:.3f} s, "
        f"{record['plain_ms_per_token']:.3f} ms/token); tokens per row "
        f"{[len(r.tokens) for r in results]}; K3 and K6 launches {want} each")

    feats = model.encode(mel)
    # the same 224-token horizon (at 50 tokens the acceptance read 0.886);
    # every rejected proposal is replayed from the walk's rule calls
    t = time.perf_counter()
    with walk_pairs(cfg, SPEC_K, opts.sample_len) as walk:
        decoding.decode(model, feats, opts, from_features=True, draft=model)
    wall = time.perf_counter() - t
    self_stats = dict(speculative.LAST_STATS)
    record["self_draft"] = {"acceptance_rate": self_stats["acceptance_rate"],
                            "tokens_per_iter": self_stats["tokens_per_iter"],
                            "wall_s": wall, "mismatches": walk["mismatches"]}
    log(f"[spec_decode] self-draft (bf16, {opts.sample_len} tokens): acceptance "
        f"{self_stats['acceptance_rate']:.4f}, {self_stats['tokens_per_iter']:.4f} "
        f"tokens/iteration, {wall:.3f} s (the rule calls recorded); "
        f"{len(walk['mismatches'])} rejected proposals, each with the verify's "
        f"and the draft's margins between the two picks and bf16's spacing "
        f"there: {walk['mismatches']}")
    if self_stats["acceptance_rate"] < 0.9:
        raise AssertionError(f"self-draft acceptance {self_stats}")
    check_near_ties(walk, self_stats, "bf16 self-draft",
                    lambda m: SELF_DRAFT_BF16_SPACINGS * m["bf16_spacing"])
    sampled = dataclasses.replace(opts, sample_len=32, temperature=0.4)
    runs = [decoding.decode(model, feats, sampled, from_features=True, draft=model,
                            seed=7) for _ in range(2)]
    if [r.tokens for r in runs[0]] != [r.tokens for r in runs[1]]:
        raise AssertionError("sampled speculative rung: one seed, other tokens")
    check_grammar(runs[0], cfg, "spec_decode sampled")
    log(f"[spec_decode] sampled rung t=0.4, self-draft, seed 7 twice: tokens equal, "
        f"tokens per row {[len(r.tokens) for r in runs[0]]}, acceptance "
        f"{speculative.LAST_STATS['acceptance_rate']:.4f}")
    return record


def spec_parity(wt):
    """fp32 on the card, TF32 off: the turbo config as target (its full
    widths, 4 text layers, random weights from seed 0), drafted by itself and
    by a second seed, features' dtype cross-KV and an fp32 cache: the
    speculative greedy tokens are the plain greedy loop's, or a row differs
    first where the target's two candidates lie within 1e-4 (a near-tie of
    summation order: cuBLAS may sum M = B and M = B(K+1) apart); each such
    margin is printed. The self-draft's rejected proposals are replayed
    from the walk's rule calls and must be near-ties within 1e-4 too, the
    same rules running in the draft's steps and the walk. Then the tiny model of fp32_parity with int8 cross-KV
    (K6 in the draft's steps on the card): the card's speculative tokens are
    the CPU's."""
    from openai_whisper_coreml_tpu_torch import decoding, speculative
    from openai_whisper_coreml_tpu_torch.config import get_config, tiny_test_config

    cfg = get_config("large-v3-turbo")
    target = wt.build_model(cfg, dtype=torch.float32, seed=0, device="cuda")
    drafts = {"self": target,
              "seed 1": wt.build_model(cfg, dtype=torch.float32, seed=1, device="cuda")}
    audio = (np.random.default_rng(2).standard_normal((3, 480_000)) * 0.1
             ).astype(np.float32)
    feats = target.encode(target.log_mel(audio))
    opts = wt.DecodingOptions(language="en", sample_len=48, spec_k=SPEC_K)
    plain = decoding.decode(target, feats, opts, from_features=True)
    tok = wt.get_tokenizer(cfg, language="en")
    prompt = [tok.sot, tok.language_token("en"), tok.transcribe]
    for name, draft in drafts.items():
        with walk_pairs(cfg, SPEC_K, opts.sample_len) as walk:
            spec = decoding.decode(target, feats, opts, from_features=True,
                                   draft=draft)
        if name == "self":
            stats = dict(speculative.LAST_STATS)
            log(f"fp32 spec parity (turbo target, self draft): acceptance "
                f"{stats['acceptance_rate']:.4f}; rejected proposals "
                f"{walk['mismatches']}")
            check_near_ties(walk, stats, "fp32 self-draft", lambda m: 1e-4)
        margins = []
        for row, (p, q) in enumerate(zip(plain, spec)):
            if p.tokens == q.tokens:
                continue
            i = next((j for j, (a, b) in enumerate(zip(p.tokens, q.tokens)) if a != b),
                     min(len(p.tokens), len(q.tokens)))
            a = p.tokens[i] if i < len(p.tokens) else cfg.eot_token
            b = q.tokens[i] if i < len(q.tokens) else cfg.eot_token
            logits = target.logits([prompt + p.tokens[:i]], feats[row:row + 1])[0, -1]
            margins.append((row, i, abs(float(logits[a] - logits[b]))))
        log(f"fp32 spec parity (turbo target, {name} draft): rows equal to plain "
            f"{[p.tokens == q.tokens for p, q in zip(plain, spec)]}; tokens per row "
            f"{[len(r.tokens) for r in spec]}; first-difference margins {margins}")
        if any(m >= 1e-4 for _, _, m in margins):
            raise AssertionError(f"fp32 spec parity ({name} draft): {margins}")
    del target, drafts
    torch.cuda.empty_cache()

    tiny = tiny_test_config(n_state=128, n_head=2, n_layer=2)
    cpu = wt.build_model(tiny, dtype=torch.float32, seed=0, device="cpu")
    cpu_d = wt.build_model(tiny, dtype=torch.float32, seed=1, device="cpu")
    mel = cpu.log_mel((np.random.default_rng(1).standard_normal((2, 480_000)) * 0.1
                       ).astype(np.float32))
    opts = wt.DecodingOptions(language="en", sample_len=48, spec_k=SPEC_K,
                              kv_dtype="int8")
    gpu, gpu_d = copy.deepcopy(cpu).to("cuda"), copy.deepcopy(cpu_d).to("cuda")
    on_card = decoding.decode(gpu, mel.cuda(), opts, draft=gpu_d)
    on_cpu = decoding.decode(cpu, mel, opts, draft=cpu_d)
    equal = [a.tokens == b.tokens for a, b in zip(on_card, on_cpu)]
    log(f"fp32 spec parity card vs cpu (tiny, int8 cross-KV): tokens equal {equal}, "
        f"tokens per row {[len(r.tokens) for r in on_card]}")
    if not all(equal):
        raise AssertionError("fp32 speculative decode: card and CPU differ")


def spec_entry_points(wt, model, draft, kernels):
    """The draft through the other entry points at cut depths, each a main
    path: transcribe(draft_model=...) of 20 s (16-token windows), then
    transcribe_batch of three requests (10, 20 and 35 s) under the static
    scheduler with model.draft set (16-token windows; the governor's
    verdict printed: it should withhold the floor draft once it holds
    min_iters of evidence)."""
    import importlib

    from openai_whisper_coreml_tpu_torch import speculative

    serve = importlib.import_module("openai_whisper_coreml_tpu_torch.serve")
    cfg = model.cfg
    before = dict(speculative.TOTALS)
    with main_path("transcribe draft", kernels) as calls:
        result = model.transcribe(speechy(20, 3), kv_dtype="int8",
                                  temperature=(0.0, 0.4), sample_len=16,
                                  draft_model=draft)
    check_segments(result, cfg, 20.0)
    spec = {k: speculative.TOTALS[k] - before[k] for k in before}
    if spec["iters"] == 0:
        raise AssertionError("transcribe(draft_model=...) ran no speculative decode")
    log(f"transcribe draft of 20 s: {calls['encode'] - 1} windows, "
        f"{len(result['segments'])} segments; speculative {spec}; "
        f"{calls['steps']} single-token steps")

    seconds = (10, 20, 35)
    audios = [speechy(sec, 30 + i) for i, sec in enumerate(seconds)]
    opts = wt.ServeOptions(batch_size=4, sample_len=16, language="en",
                           temperature=(0.0, 0.4), kv_dtype="int8",
                           scheduler="static", spec_k=SPEC_K)
    model.draft = draft
    try:
        before = dict(speculative.TOTALS)
        with main_path("serve_batch static draft", kernels) as calls:
            results = wt.transcribe_batch(model, audios, opts)
        gov = serve.spec_governor(model, opts)
    finally:
        model.draft = None
    for r, sec in zip(results, seconds):
        check_segments(r, cfg, float(sec))
    spec = {k: speculative.TOTALS[k] - before[k] for k in before}
    if spec["iters"] == 0:
        raise AssertionError("transcribe_batch with a draft ran no speculative decode")
    log(f"serve_batch static draft: {calls['encode']} encoder calls, "
        f"{calls['steps']} single-token steps; speculative {spec}; governor: "
        f"withholding {gov.disabled} (sampled {gov.disabled_sampled}), tokens/iter "
        f"{gov.tokens_per_iter}, threshold {gov.threshold:.4f} (prior "
        f"{gov.prior_threshold:.4f}, calibrated {gov.calibrated}), live ms/iter "
        f"{gov.live_iter_ms}, live ms/token {gov.live_tok_ms}")


def sqa_v3_probe_slice(kernels) -> list:
    """K2's path, as in JAX its probe chain (`tools/torch_sqa_v3_probe.py`):
    B=24, 32 layers, 4 steps a run, a warm-up run and two timed runs per
    variant (plain inline dequantisation, K6, K2 with int8 and with bf16
    A.V), over 3.0 GB of int8 K/V made on the card. Every K2 chain run
    launches exactly layers x steps. Before the timed runs K2 is held
    against its plain version at the chain's shapes, in both A.V modes: on
    layer 0 with the first query in bf16 and fp32, and on the last layer
    with the query its own chain feeds it; and against the inline-dequant
    oracle on layer 0."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import torch_sqa_v3_probe as probe

    layers, batch, iters, repeats, seq = 32, 24, 4, 2, 1500
    t = time.perf_counter()
    kv = probe.make_kv(layers, batch, 20, 64, seq, 1536)
    torch.cuda.synchronize()
    log(f"sqa_v3 probe: {sum(x.numel() * x.element_size() for x in kv) / 1e9:.3f} GB "
        f"of K/V and scales made on the card in {time.perf_counter() - t:.3f} s")
    for label, out, plain in probe.kernel_and_plain(kv, seq):
        check_errors(f"sqa_v3 probe kernel vs plain {label}", out, plain,
                     label["q"] == "bfloat16")
    # the error of int8 q (and int8 weights) against the inline-dequant
    # oracle over 30,720 outputs. JAX's bounds (max 0.012 / rms 0.004 with
    # int8 A.V, 0.004 / 0.0013 with bf16) come from 1,024 outputs; the max
    # grows with the sample, and this seed's int8 A.V max reads 0.0157 on
    # the H100 (PERF.md section 6), so that max is held at 0.02
    for check in probe.check_layer0(kv, seq):
        max_tol, rms_tol = ((0.02, 0.004) if check["check"] == "av_int8=True"
                            else (0.004, 0.0013))
        log(json.dumps({**check, "max_tol": max_tol, "rms_tol": rms_tol}))
        if not (check["max_abs_err"] < max_tol and check["rms_err"] < rms_tol):
            raise AssertionError(f"sqa_v3 probe layer 0: {check}")
    reset_counts(kernels)
    records = probe.probe(kv, seq, iters, repeats)
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    per_variant = layers * iters * (repeats + 1)
    expected = {k: 0 for k in launches}
    expected.update(sqa_v3=2 * per_variant, sqa_int8=per_variant)
    for record in records:
        log(json.dumps(record))
    log(f"[sqa_v3 probe] launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"sqa_v3 probe: launches {launches}, expected {expected}")
    for k, n in launches.items():
        TOTALS[k] = TOTALS.get(k, 0) + n
    del kv
    torch.cuda.empty_cache()
    return records


def host_profile(run, steps: int) -> dict:
    """cProfile of `run` (`steps` decode steps): host ms per step (inflated
    by the profiler's own cost per Python call), and the time and share
    inside the decode kernels' step entries, their per-call wrappers and
    the cache writes; the top functions by own time."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats  # (file, line, name) -> (cc, nc, tt, ct, callers)
    total = sum(v[2] for v in stats.values())
    groups = {"step entries": {("sqa_int8.py", "sqa_int8_layers"), ("sqa_int8.py", "attend"),
                               ("sqa_self.py", "sqa_self_layers"), ("sqa_self.py", "attend")},
              "per-call wrappers": {("sqa_int8.py", "sqa_int8"), ("sqa_self.py", "sqa_self")},
              "cache writes": {("decoder.py", "_cache_write"), ("decoder.py", "_cache_index")}}
    shares = {}
    for group, names in groups.items():
        cum = sum(v[3] for (f, _, name), v in stats.items()
                  if (os.path.basename(f), name) in names)
        shares[group] = {"ms_per_step": cum * 1e3 / steps, "share": cum / total}
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:8]
    return {"host_ms_per_step": total * 1e3 / steps, "groups": shares,
            "top_own_time": [(f"{os.path.basename(f)}:{name}", v[2] * 1e3 / steps)
                             for (f, _, name), v in top]}


def encoder_slice(model, kernels) -> dict:
    """The large-v3 encoder (bf16, int8 weights) on four 30 s windows:
    wall per `encode` (best of five), device-busy time per encode and K1's
    share of it (torch.profiler), through `tools/torch_encode_time.py`'s
    `measure`. A main path: K1 launches exactly 32 times per encode."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import torch_encode_time

    audio = (np.random.default_rng(0).standard_normal((4, 480_000)) * 0.1
             ).astype(np.float32)
    idle = tuple(k for k in kernels if k not in ("flash_attention", "log_mel"))
    with main_path("encoder", kernels, idle=idle) as calls:
        mel = model.log_mel(audio)
        result = torch_encode_time.measure(model, mel, runs=5)
    if result["flash_launches"] != model.cfg.n_audio_layer:
        raise AssertionError(f"encoder: {result['flash_launches']} K1 launches per "
                             f"encode, expected {model.cfg.n_audio_layer}")
    log(f"[encoder] large-v3 B=4 on {card()}: best wall {result['best_wall_ms']:.3f} ms "
        f"per encode (runs {[round(w, 3) for w in result['wall_ms']]}), device-busy "
        f"{result['device_busy_ms']:.3f} ms, K1 {result['flash_device_ms']:.3f} ms "
        f"({100 * result['flash_share']:.1f}%); {calls['encode']} encodes")
    return result


def profile_step(model, ss, si):
    """5 large-v3 B=4 decode steps at a 224-token horizon (256-column bf16
    cache, int8 cross-KV, positions 100-104: the inputs of
    tools/torch_sqa_time.py --step, from its step_inputs) four ways: the decode kernels
    through decode_step's per-step entries (K3 + K6), the same kernels
    through their per-call wrappers, self_kernel=False (K6 only) and the
    plain versions in the kernels' place. Prints device events and
    device-busy ms per step from torch.profiler, and wall ms per step (host
    clock, synchronised, outside the profiler; best of two alternating
    runs). Then the wrappers' host cost: host microseconds per call of each
    entry and each per-call wrapper at the step's shapes, and a cProfile of
    the kernels' step."""
    from torch.profiler import ProfilerActivity, profile

    from openai_whisper_coreml_tpu_torch.models import decoder as dec_mod

    timing = sqa_time()
    steps, pos0, host_us_per_call = timing.STEPS, timing.STEP_POS, timing.host_us_per_call
    tok, cross, cache, q = timing.step_inputs(model)

    def per_layer(fn):
        """An entry that calls fn(q (B,H,D), layer l of each stacked tensor,
        pos, valid_from) per layer: the kernels' per-call wrappers or their
        plain versions."""
        def layers(*args):
            *stacked, pos, valid_from = args
            return lambda q, l: fn(q[:, 0], *(t[l] for t in stacked), pos,
                                   valid_from)[:, None]
        return layers

    @contextlib.contextmanager
    def entries(self_fn, int8_fn):
        saved = dec_mod.sqa_self_layers, dec_mod.sqa_int8_layers
        dec_mod.sqa_self_layers = per_layer(self_fn)
        dec_mod.sqa_int8_layers = per_layer(int8_fn)
        try:
            yield
        finally:
            dec_mod.sqa_self_layers, dec_mod.sqa_int8_layers = saved

    modes = {"kernels": (True, contextlib.nullcontext),
             "kernels, per-call wrappers": (True, lambda: entries(ss.sqa_self,
                                                                  si.sqa_int8)),
             "self_kernel=False": (False, contextlib.nullcontext),
             "plain versions": (True, lambda: entries(ss.sqa_self_reference,
                                                      si.sqa_int8_reference))}

    def run(mode):
        self_kernel, ctx = modes[mode]
        with ctx():
            for i in range(steps):
                dec_mod.decode_step(model.decoder, tok, cross, cache, pos0 + i,
                                    self_kernel=self_kernel)

    wall = {}
    for mode in list(modes) + list(reversed(modes)):
        run(mode)  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(mode)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / steps
        wall[mode] = min(wall.get(mode, ms), ms)
    profile_out = {}
    for mode in modes:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(mode)
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3 / steps
        profile_out[mode] = {"device_events_per_step": len(device) / steps,
                             "device_busy_ms_per_step": busy_ms,
                             "wall_ms_per_step": wall[mode]}
        log(f"decode step profile ({mode}) on {card()}: "
            f"{len(device) / steps:.1f} device events and {busy_ms:.3f} ms "
            f"device-busy per step; {wall[mode]:.3f} ms wall per step")
    log("decode step profile: " + json.dumps(profile_out))

    # the wrappers' host cost at the step's shapes: one step's 32 calls each
    n = model.cfg.n_text_layer
    k8, ks, v8, vs = cross
    s_cols = k8.shape[-1]
    host = {
        "sqa_int8 cross, per-call wrapper": host_us_per_call(
            lambda l: si.sqa_int8(q[:, 0], k8[l], ks[l], v8[l], vs[l], s_cols - 1, 0),
            n),
        "sqa_int8 cross, step entry": host_us_per_call(
            lambda l, a=si.sqa_int8_layers(*cross, s_cols - 1, 0): a(q, l), n),
        "sqa_int8 cross, making the step entry": host_us_per_call(
            lambda l: si.sqa_int8_layers(*cross, s_cols - 1, 0), n),
        "sqa_self, per-call wrapper": host_us_per_call(
            lambda l: ss.sqa_self(q[:, 0], cache.k[l], cache.v[l], pos0, 0), n),
        "sqa_self, step entry": host_us_per_call(
            lambda l, a=ss.sqa_self_layers(cache.k, cache.v, pos0, 0): a(q, l), n),
        "sqa_self, making the step entry": host_us_per_call(
            lambda l: ss.sqa_self_layers(cache.k, cache.v, pos0, 0), n),
    }
    for name, us in host.items():
        log(f"host time per call, {name}: {us:.2f} us")
    cprof = {}
    for mode in ("kernels", "kernels, per-call wrappers"):
        cprof[mode] = out = host_profile(lambda: run(mode), steps)
        log(f"decode step host profile (cProfile, {mode}): "
            f"{out['host_ms_per_step']:.3f} ms host per step under cProfile")
        for group, v in out["groups"].items():
            log(f"  {group}: {v['ms_per_step']:.3f} ms per step, "
                f"{100 * v['share']:.2f}%")
        log("  top own time (ms per step): " + ", ".join(
            f"{name} {ms:.3f}" for name, ms in out["top_own_time"]))
    log("decode step host cost: " + json.dumps({"host_us_per_call": host,
                                                 "cprofile": cprof}))


# -- the DP x TP mesh (parallel/) ------------------------------------------------
# The ranks share the one card over gloo: NCCL refuses two ranks on one card,
# and gloo carries CUDA tensors for all_reduce (the only collective the
# sharded paths issue on the card), staging each through the host. The walls
# below prove the sharded path end to end; they are no multi-card figure.

PARALLEL_TIMEOUT_S = 420
PARALLEL_IDLE = ("flash_attention_causal", "flash_attention_online", "sqa_v3")
# the bf16 serving checks, sharded and unsharded alike. Without timestamps a
# greedy token is the argmax of the raw logits over the allowed tokens, so
# where the two models part, the unsharded model's margin between the two
# tokens is a difference of two logits (`bf16_ties`). The token counts are
# cut for the script's time limit (at 64 and 16 on an NVIDIA H100 80GB HBM3
# at 700 W, the rows that parted did so at tokens 13-18).
PARALLEL_DECODE = dict(language="en", sample_len=32, kv_dtype="int8",
                       without_timestamps=True)
PARALLEL_SERVE = dict(scheduler="continuous", batch_size=4, language="en",
                      kv_dtype="int8", sample_len=8, chunk_tokens=8,
                      temperature=(0.0,), no_speech_threshold=None,
                      without_timestamps=True)
# word timestamps under the mesh (fp32, turbo widths): transcribe of a 35 s
# clip, then transcribe_batch of three requests (16-token windows, no gates)
PARALLEL_WORDS = dict(language="en", sample_len=16, kv_dtype="int8",
                      word_timestamps=True, no_speech_threshold=None,
                      logprob_threshold=None, compression_ratio_threshold=None)
PARALLEL_WORDS_SECONDS = (6, 12, 35)
# the two stream classes under the mesh (bf16, turbo widths, bf16 cache):
# 8-token tick horizons (16 took 19.4 s on an NVIDIA H100 80GB HBM3 at 700 W)
PARALLEL_STREAM = dict(language="en", sample_len=8)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, fn, args, q):
    """A spawned rank: torchrun's environment, `initialize_distributed`
    (which picks gloo: the ranks share one card), then fn(*args)."""
    import traceback

    import torch.distributed as dist

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    try:
        from openai_whisper_coreml_tpu_torch.parallel import initialize_distributed

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        initialize_distributed(timeout_s=PARALLEL_TIMEOUT_S)
        try:
            q.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the phase
        q.put((rank, False, traceback.format_exc()))


def run_ranks(world: int, fn, *args) -> list:
    """fn(*args) on `world` spawned ranks (the parent holds a CUDA context,
    so spawn, never fork); every rank's result. A rank that fails or hangs
    fails the phase, and no rank outlives the call."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, fn, args, q),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        while len(results) + len(errors) < world:
            try:
                rank, ok, value = q.get(timeout=PARALLEL_TIMEOUT_S)
            except queue.Empty:
                errors.append(f"ranks silent for {PARALLEL_TIMEOUT_S} s")
                break
            (results.__setitem__(rank, value) if ok
             else errors.append(f"rank {rank}:\n{value}"))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    if errors:
        raise AssertionError("parallel ranks failed:\n" + "\n".join(errors))
    return [results[r] for r in range(world)]


def kernel_counters() -> dict:
    """Name -> (wrapper module, its launch counter); K1, its causal mode and
    K5 are one CUDA kernel whose wrapper counts each mode apart."""
    from openai_whisper_coreml_tpu_torch.ops import flash_attention as fa
    from openai_whisper_coreml_tpu_torch.ops import mel_kernel as mk
    from openai_whisper_coreml_tpu_torch.ops import sqa_int8 as si
    from openai_whisper_coreml_tpu_torch.ops import sqa_self as ss
    from openai_whisper_coreml_tpu_torch.ops import sqa_v3 as sv

    return {"flash_attention": (fa, "launches"),
            "flash_attention_causal": (fa, "launches_causal"),
            "flash_attention_online": (fa, "launches_online"),
            "log_mel": (mk, "launches"), "sqa_self": (ss, "launches"),
            "sqa_int8": (si, "launches"), "sqa_v3": (sv, "launches")}


def param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


# the training cases of the phase (tiny at full width, fp32): two updates of
# two micro-batches with a clip that acts, and one LoRA step on an int8
# base with adapters on column- and row-parallel linears. AdamW's eps = 1
# keeps each update proportional to its gradient: at eps = 1e-6 an element
# whose gradient sits near eps turns the float noise of another summation
# order into 1e-4 of its update, sharded or not.
PARALLEL_TRAIN = {
    "full": (dict(accum_steps=2, max_grad_norm=0.05, learning_rate=1e-3, eps=1.0,
                  flash=True), False, 4),
    "lora": (dict(trainable="lora_", learning_rate=1e-2, eps=1.0), True, 1),
}


def parallel_train_run(case: str, mesh=None):
    """(losses, the gathered tree as flat CPU tensors) of one case."""
    from openai_whisper_coreml_tpu_torch.config import get_config
    from openai_whisper_coreml_tpu_torch.lora import add_lora
    from openai_whisper_coreml_tpu_torch.models.whisper import model_from_params
    from openai_whisper_coreml_tpu_torch.parallel import gather_params
    from openai_whisper_coreml_tpu_torch.params import init_params
    from openai_whisper_coreml_tpu_torch.quantize import quantize_params
    from openai_whisper_coreml_tpu_torch.tokenizer import get_tokenizer
    from openai_whisper_coreml_tpu_torch.train import (TrainConfig, make_batch,
                                                        make_train_step)
    from openai_whisper_coreml_tpu_torch.utils.checkpoint import flatten_params

    tc_kw, lora, steps = PARALLEL_TRAIN[case]
    cfg = get_config("tiny")
    tree = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                       dtype=torch.float32, device="cuda")
    if lora:
        tree = add_lora(quantize_params(tree), rank=8, seed=1,
                        targets=r"(attn|cross_attn)/(q|v|out)$|mlp/fc2$")
        gen = torch.Generator(device="cuda").manual_seed(2)

        def seed_b(node):  # B from zero would leave A no gradient in one step
            if not isinstance(node, dict):
                return node
            out = {k: seed_b(v) for k, v in node.items()}
            if "lora_b" in node:
                out["lora_b"] = 0.02 * torch.randn(node["lora_b"].shape, generator=gen,
                                                   device="cuda")
            return out

        tree = seed_b(tree)
    model = model_from_params(cfg, tree, mesh=mesh)
    init_fn, step_fn = make_train_step(cfg, TrainConfig(**tc_kw), mesh=mesh)
    model, state = init_fn(model)
    tok = get_tokenizer(cfg)
    rng = np.random.default_rng(7)
    losses = []
    for s in range(steps):
        mel = rng.standard_normal((4, cfg.n_mels, 3000)).astype(np.float32)
        # data halves with unequal token counts
        texts = [f"one two three four five six {s}", f"seven eight nine {s} ten",
                 f"x {s}", f"{s}"]
        batch = make_batch(cfg, tok, mel, texts, max_len=24)
        model, state, metrics = step_fn(model, state, *batch)
        losses.append(float(metrics["loss"]))
    return losses, {k: v.detach().cpu() for k, v in
                    flatten_params(gather_params(model)).items()}


def stream_run(wt, model, data) -> dict:
    """A StreamingTranscriber over a 5 s clip in 1 s chunks, then a
    two-stream MultiStreamTranscriber (5 s and 3 s) polled each second:
    every event as (text, tokens, is_final)."""
    def events(evs):
        return [(e.text, list(e.tokens), e.is_final) for e in evs]

    clip = data["stream_clip"]
    st = wt.StreamingTranscriber(model, **PARALLEL_STREAM)
    single = []
    for off in range(0, len(clip), SR):
        single += events(st.feed(clip[off:off + SR]))
    single += events(st.finish())
    audios = [data["multi0"], data["multi1"]]
    mst = wt.MultiStreamTranscriber(model, n_streams=2, **PARALLEL_STREAM)
    multi = {0: [], 1: []}
    for off in range(0, max(len(a) for a in audios), SR):
        for i, a in enumerate(audios):
            if off < len(a):
                mst.feed(i, a[off:off + SR])
        for i, evs in mst.poll().items():
            multi[i] += events(evs)
    for i in multi:
        multi[i] += events(mst.finish(i))
    return {"single": single, "multi": [multi[0], multi[1]]}


def words_run(wt, model, data) -> dict:
    """transcribe of the 35 s clip and transcribe_batch of three requests,
    with word timestamps (PARALLEL_WORDS)."""
    reqs = [data[f"words_req{i}"] for i in range(len(PARALLEL_WORDS_SECONDS))]
    return {"transcribe": model.transcribe(data["words_clip"], temperature=0.0,
                                           **PARALLEL_WORDS),
            "batch": wt.transcribe_batch(model, reqs, wt.ServeOptions(
                batch_size=len(reqs), temperature=(0.0,), **PARALLEL_WORDS))}


def rank_phase(n_data: int, n_model: int, inputs: str, serve: bool, train: bool,
               words: bool = False, streams: bool = False) -> dict:
    """One mesh's work on this rank: fp32 parity at large-v3-turbo's widths,
    with (words) word timestamps on the same model; then (streams) the two
    stream classes at the turbo widths in bf16; then (serve) large-v3 bf16
    int8 serving, then (train) the training cases; on rank 0 the
    one-process training runs too, for the check."""
    import torch.distributed as dist

    import openai_whisper_coreml_tpu_torch as wt
    from openai_whisper_coreml_tpu_torch.config import get_config
    from openai_whisper_coreml_tpu_torch.parallel import make_mesh

    kernels = kernel_counters()
    mesh = make_mesh(n_data, n_model)
    tag = f"{n_data}x{n_model} rank {dist.get_rank()}"
    data = np.load(inputs)
    out = {}
    cfg = get_config("large-v3-turbo")
    model = wt.build_model(cfg, dtype=torch.float32, seed=0, device="cuda", mesh=mesh)
    mel = torch.as_tensor(data["mel"], device="cuda")
    idle = PARALLEL_IDLE + ("log_mel", "sqa_self")
    with main_path(f"parallel fp32 {tag}", kernels, idle=idle) as calls:
        with torch.no_grad():
            out["logits"] = model.logits(data["tokens"], model.encode(mel)).cpu().numpy()
        res = wt.decode(model, mel, wt.DecodingOptions(
            language="en", sample_len=32, kv_dtype="int8"))
    out["greedy"] = [r.tokens for r in res]
    out["fp32_calls"] = dict(calls)
    out["fp32_launches"] = read_counts(kernels)
    if words:
        # fp32 caches never take K3; K1-causal once per decoder layer of
        # each alignment forward, on the rank's heads
        t = time.perf_counter()
        with main_path(f"parallel words fp32 {tag}", kernels,
                       idle=PARALLEL_IDLE[1:] + ("sqa_self",)) as calls:
            out["words"] = words_run(wt, model, data)
        out["words_s"] = time.perf_counter() - t
        out["words_calls"] = dict(calls)
        out["words_launches"] = read_counts(kernels)
    del model
    torch.cuda.empty_cache()

    if streams:
        # streams decode with a bf16 cross-KV and cache: K4, K1 and K3
        model = wt.build_model(cfg, dtype=torch.bfloat16, seed=0, device="cuda",
                               mesh=mesh)
        t = time.perf_counter()
        with main_path(f"parallel streams bf16 {tag}", kernels,
                       idle=PARALLEL_IDLE + ("sqa_int8",)) as calls:
            out["streams"] = stream_run(wt, model, data)
        out["streams_s"] = time.perf_counter() - t
        out["streams_calls"] = dict(calls)
        out["streams_launches"] = read_counts(kernels)
        del model
        torch.cuda.empty_cache()

    if serve:
        model = wt.load_model("large-v3", dtype=torch.bfloat16, quantize="int8",
                              device="cuda", mesh=mesh)
        out["param_bytes"] = param_bytes(model)
        t = time.perf_counter()
        with main_path(f"parallel decode {tag}", kernels, idle=PARALLEL_IDLE) as calls:
            res = wt.decode(model, model.log_mel(data["audio"]),
                            wt.DecodingOptions(**PARALLEL_DECODE))
        out["decode_s"] = time.perf_counter() - t
        out["decode"] = [r.tokens for r in res]
        out["decode_launches"] = read_counts(kernels)
        out["decode_steps"] = calls["steps"]
        clips = [data[f"clip{i}"] for i in range(6)]
        t = time.perf_counter()
        with main_path(f"parallel transcribe_batch {tag}", kernels,
                       idle=PARALLEL_IDLE) as calls:
            results = wt.transcribe_batch(model, clips,
                                          wt.ServeOptions(**PARALLEL_SERVE))
        out["batch_s"] = time.perf_counter() - t
        out["batch"] = [[t for s in r["segments"] for t in s["tokens"]] for r in results]
        out["batch_launches"] = read_counts(kernels)
        out["batch_steps"] = calls["steps"]
        del model
        torch.cuda.empty_cache()

    if train:
        for case in PARALLEL_TRAIN:
            t = time.perf_counter()
            losses, tree = parallel_train_run(case, mesh)
            out[f"train_{case}_s"] = time.perf_counter() - t
            out[f"train_{case}"] = losses
            if dist.get_rank() == 0:
                want_losses, want = parallel_train_run(case)
                pairs = [(tree[k].float(), v.float()) for k, v in want.items()]
                out[f"train_{case}_ref"] = want_losses
                # relative to each leaf's scale
                out[f"train_{case}_leaf_err"] = max(
                    float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
                    for g, w in pairs)
                out[f"train_{case}_leaves_close"] = set(tree) == set(want) and all(
                    torch.allclose(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))
                    for g, w in pairs)
    return out


def int8_logits(model, feats, prompt, tokens, i: int) -> torch.Tensor:
    """The model's logits (fp32, on the host) after prompt + tokens[:i],
    over int8 cross-KV as the decodes run (one prefill, no cache reuse)."""
    from openai_whisper_coreml_tpu_torch.models import decoder as dec_mod

    cfg = model.cfg
    seq = torch.tensor([prompt + tokens[:i]], device="cuda")
    cross = dec_mod.precompute_cross(model.decoder, feats, "int8")
    cache = dec_mod.init_kv_cache(cfg, 1, feats.dtype, feats.device)
    with torch.no_grad():
        logits, _ = dec_mod.decode_step(model.decoder, seq, cross, cache, 0)
    return logits[0, -1].float().cpu()


def first_difference(p, q, eot: int) -> tuple:
    """(i, p's token there, q's token there) where two token lists part."""
    i = next((j for j, (a, b) in enumerate(zip(p, q)) if a != b), min(len(p), len(q)))
    return i, (p[i] if i < len(p) else eot), (q[i] if i < len(q) else eot)


def bf16_ties(model, model32, mels, plain, got, prompt) -> list:
    """The fp32 gate's near-tie rule at bf16 spacing, for each row where
    the sharded model's tokens `got` leave the unsharded model's `plain`:
    (row, position, the unsharded model's margin between its token and the
    sharded model's, its bf16 error there, the same weights' fp32 margin
    for the sharded model's token). The bf16 error is the largest gap
    between the unsharded model's logits and the same weights' computed in
    fp32 (`model32`); a margin within twice that is a tie that bf16 cannot
    order (the sharded model rounds in other places: it sums fp32 partials,
    where the unsharded model rounds each whole product to bf16)."""
    out, feats = [], None
    for row, (p, q) in enumerate(zip(plain, got)):
        if p == q:
            continue
        if feats is None:
            feats, feats32 = model.encode(mels), model32.encode(mels)
        i, a, b = first_difference(p, q, model.cfg.eot_token)
        logits = int8_logits(model, feats[row:row + 1], prompt, p, i)
        logits32 = int8_logits(model32, feats32[row:row + 1], prompt, p, i)
        out.append((row, i, abs(float(logits[a] - logits[b])),
                    float((logits - logits32).abs().max()),
                    float(logits32[b] - logits32[a])))
    return out


def _float32(tree):
    """A parameter tree with its float leaves in fp32 (int8 leaves kept)."""
    if isinstance(tree, dict):
        return {k: _float32(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def parallel_slice(wt, model, kernels) -> dict:
    """The DP x TP mesh on spawned ranks sharing the card over gloo: fp32
    parity of (1, 2), (2, 1) and (2, 2) against the unsharded turbo-width
    model in this process; large-v3 bf16 int8 serving on (1, 2) beside
    `model` (the unsharded large-v3 int8 of the serving phases); training
    on (1, 2) and (2, 1) against the one-process step; the CLI under
    torch.distributed.run with --tensor-parallel 2."""
    from openai_whisper_coreml_tpu_torch.config import get_config

    t_phase = time.perf_counter()
    cfg = get_config("large-v3-turbo")
    ref = wt.build_model(cfg, dtype=torch.float32, seed=0, device="cuda")
    audio = (np.random.default_rng(4).standard_normal((4, 480_000)) * 0.1
             ).astype(np.float32)
    mel = ref.log_mel(audio)
    tokens = np.random.default_rng(5).integers(0, cfg.n_vocab, (4, 8))
    feats = ref.encode(mel)
    with torch.no_grad():
        want_logits = ref.logits(tokens, feats).cpu().numpy()
    want = [r.tokens for r in wt.decode(ref, mel, wt.DecodingOptions(
        language="en", sample_len=32, kv_dtype="int8"))]
    clips = [speechy(s, 40 + i) for i, s in enumerate((8, 12, 16, 20, 10, 14))]
    word_inputs = {"words_clip": speechy(35, 50),
                   "stream_clip": speechy(5, 53), "multi0": speechy(5, 54),
                   "multi1": speechy(3, 55),
                   **{f"words_req{i}": speechy(sec, 51 + i)
                      for i, sec in enumerate(PARALLEL_WORDS_SECONDS)}}
    t = time.perf_counter()
    want_words = words_run(wt, ref, word_inputs)
    log(f"parallel words fp32 unsharded: {time.perf_counter() - t:.1f} s wall")
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, mel=mel.cpu().numpy(), tokens=tokens, audio=audio,
                 **{f"clip{i}": c for i, c in enumerate(clips)}, **word_inputs)
        ranks = {}
        for n_data, n_model in ((1, 2), (2, 1), (2, 2)):
            t = time.perf_counter()
            ranks[(n_data, n_model)] = run_ranks(
                n_data * n_model, rank_phase, n_data, n_model, inputs,
                (n_data, n_model) == (1, 2), n_data * n_model == 2,
                n_data * n_model == 2, (n_data, n_model) == (1, 2))
            log(f"parallel {n_data}x{n_model}: {time.perf_counter() - t:.1f} s wall "
                f"on {card()} (ranks spawned and joined; gloo stages every "
                f"collective through the host: no multi-card figure)")

    tok = wt.get_tokenizer(cfg, language="en")
    prompt = [tok.sot, tok.language_token("en"), tok.transcribe]
    summary = {}
    for mesh, results in ranks.items():
        for r, res in enumerate(results):
            err = float(np.abs(res["logits"] - want_logits).max())
            margins = []
            for row, (p, q) in enumerate(zip(want, res["greedy"])):
                if p == q:
                    continue
                i, a, b = first_difference(p, q, cfg.eot_token)
                logits = int8_logits(ref, feats[row:row + 1], prompt, p, i)
                margins.append((row, i, abs(float(logits[a] - logits[b]))))
            k1 = res["fp32_launches"]["flash_attention"]
            log(f"parallel fp32 {mesh} rank {r}: logits max_abs {err:.3e}; rows equal "
                f"{[p == q for p, q in zip(want, res['greedy'])]}; first-difference "
                f"margins {margins}; K1 {k1} for {res['fp32_calls']['encode']} "
                f"encodes, K6 {res['fp32_launches']['sqa_int8']}")
            if (err > 1e-3 or any(m >= 1e-4 for _, _, m in margins)
                    or k1 != cfg.n_audio_layer * res["fp32_calls"]["encode"]):
                raise AssertionError(f"parallel fp32 parity failed on {mesh} rank {r}")
            summary[f"fp32_{mesh[0]}x{mesh[1]}_logits_max_abs"] = max(
                err, summary.get(f"fp32_{mesh[0]}x{mesh[1]}_logits_max_abs", 0.0))
    del ref, feats
    torch.cuda.empty_cache()
    summary.update(parallel_words_check(ranks, want_words, cfg))
    summary.update(parallel_streams_check(ranks[(1, 2)], cfg))

    # serving on (1, 2) beside the unsharded large-v3 int8 model, and the
    # same weights computed in fp32 (model32) for the rows that part
    from openai_whisper_coreml_tpu_torch.models.whisper import model_from_params
    from openai_whisper_coreml_tpu_torch.params import params_tree
    from openai_whisper_coreml_tpu_torch.serve import _batched_mels, _windows_for

    lcfg = get_config("large-v3")
    dec_mel = model.log_mel(audio)
    plain_dec = [r.tokens for r in wt.decode(model, dec_mel,
                                             wt.DecodingOptions(**PARALLEL_DECODE))]
    plain_batch = [[t for s in r["segments"] for t in s["tokens"]] for r in
                   wt.transcribe_batch(model, clips, wt.ServeOptions(**PARALLEL_SERVE))]
    batch_mel = torch.stack([_windows_for(m, len(c), 0)[0].mel
                             for m, c in zip(_batched_mels(model, clips), clips)])
    model32 = model_from_params(lcfg, _float32(params_tree(model)))
    prompt = list(wt.get_tokenizer(lcfg, language="en")
                  .sot_sequence_including_notimestamps)
    full_bytes = param_bytes(model)
    for r, res in enumerate(ranks[(1, 2)]):
        share = res["param_bytes"] / full_bytes
        toks = [t for row in res["decode"] + res["batch"] for t in row]
        agree_dec = [p == q for p, q in zip(plain_dec, res["decode"])]
        agree_batch = [p == q for p, q in zip(plain_batch, res["batch"])]
        ties = (bf16_ties(model, model32, dec_mel, plain_dec, res["decode"], prompt)
                + bf16_ties(model, model32, batch_mel, plain_batch, res["batch"], prompt))
        log(f"parallel serving 1x2 rank {r} (large-v3 bf16, int8 weights and "
            f"cross-KV, bf16 cache): {res['param_bytes']} parameter bytes of the "
            f"unsharded {full_bytes} ({share:.4f}); decode of 4 windows x {PARALLEL_DECODE['sample_len']} tokens "
            f"{res['decode_s']:.2f} s ({res['decode_steps']} steps, launches "
            f"{res['decode_launches']}), equal to the unsharded model {agree_dec}; "
            f"transcribe_batch of 6 requests (continuous) {res['batch_s']:.2f} s "
            f"({res['batch_steps']} steps, launches {res['batch_launches']}), equal "
            f"{agree_batch}; on {card()}")
        log(f"parallel serving 1x2 rank {r}: rows that part (row, position, unsharded "
            f"margin, its bf16 error, fp32 margin for the sharded token) {ties}")
        if share > 0.57 or not toks or not all(0 <= t < lcfg.n_vocab for t in toks):
            raise AssertionError(f"parallel serving failed on rank {r}")
        if any(m > 2 * e for _, _, m, e, _ in ties):
            raise AssertionError(f"parallel serving rank {r}: a row parts from the "
                                 f"unsharded model beyond a bf16 tie: {ties}")
        for key in ("decode_launches", "batch_launches"):
            if not all(res[key][k] for k in ("flash_attention", "log_mel",
                                             "sqa_self", "sqa_int8")):
                raise AssertionError(f"parallel serving rank {r}: {key} {res[key]}")
        summary[f"serve_rank{r}_param_share"] = share
        summary[f"serve_rank{r}_decode_s"] = res["decode_s"]
        summary[f"serve_rank{r}_batch_s"] = res["batch_s"]
        summary[f"serve_rank{r}_rows_equal"] = sum(agree_dec + agree_batch)
    summary["serve_param_bytes_unsharded"] = full_bytes
    del model32
    torch.cuda.empty_cache()

    for mesh in ((1, 2), (2, 1)):
        res = ranks[mesh][0]
        for case in PARALLEL_TRAIN:
            got, ref_losses = res[f"train_{case}"], res[f"train_{case}_ref"]
            others_equal = all(o[f"train_{case}"] == got for o in ranks[mesh][1:])
            log(f"parallel training {mesh} {case}: losses {got}, one process "
                f"{ref_losses}; leaves within rtol 1e-5 {res[f'train_{case}_leaves_close']} "
                f"(worst relative error {res[f'train_{case}_leaf_err']:.3e}); "
                f"{res[f'train_{case}_s']:.2f} s")
            if (not np.allclose(got, ref_losses, rtol=1e-5) or not others_equal
                    or not res[f"train_{case}_leaves_close"]):
                raise AssertionError(f"parallel training failed: {mesh} {case}")

    summary["cli_s"] = parallel_cli()
    summary.update(parallel_server())
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"parallel_slice: {summary['phase_s']:.1f} s on {card()}")
    return summary


def parallel_words_check(ranks, want, cfg) -> dict:
    """Every rank's words on (1, 2) and (2, 1) against the unsharded fp32
    model's: segments' tokens and word times equal, probabilities within
    1e-5; K1-causal launched once per decoder layer of each alignment
    forward (`main_path` held each rank to it)."""
    out = {}
    for mesh in ((1, 2), (2, 1)):
        for r, res in enumerate(ranks[mesh]):
            got = res["words"]
            pairs = [(got["transcribe"], want["transcribe"])] + list(
                zip(got["batch"], want["batch"]))
            equal = [[s["tokens"] for s in a["segments"]]
                     == [s["tokens"] for s in b["segments"]]
                     and words_key(a["segments"]) == words_key(b["segments"])
                     for a, b in pairs]
            err = max(word_probs_err(a["segments"], b["segments"]) for a, b in pairs)
            n_words = check_words(got["transcribe"], f"parallel words {mesh} rank {r}")
            n_words += sum(len(seg.get("words") or []) for a in got["batch"]
                           for seg in a["segments"])
            calls, launches = res["words_calls"], res["words_launches"]
            log(f"parallel words fp32 {mesh} rank {r}: transcribe of 35 s and "
                f"transcribe_batch of {len(PARALLEL_WORDS_SECONDS)} requests "
                f"{res['words_s']:.2f} s; results equal to the unsharded model "
                f"{equal}; {n_words} words, probabilities max_abs {err:.3e}; "
                f"{calls['align_forwards']} alignment forwards, K1-causal "
                f"{launches['flash_attention_causal']}; on {card()}")
            if (not all(equal) or err > 1e-5
                    or launches["flash_attention_causal"]
                    != cfg.n_text_layer * calls["align_forwards"]
                    or not calls["align_forwards"]):
                raise AssertionError(f"parallel words failed on {mesh} rank {r}")
            out[f"words_{mesh[0]}x{mesh[1]}_prob_max_abs"] = max(
                err, out.get(f"words_{mesh[0]}x{mesh[1]}_prob_max_abs", 0.0))
            out[f"words_{mesh[0]}x{mesh[1]}_s"] = res["words_s"]
    return out


def parallel_streams_check(results, cfg) -> dict:
    """The (1, 2) ranks' stream events: equal on every rank, tokens in the
    vocabulary, each stream ending in a final event; K4, K1 and K3 were
    counted on each rank by `main_path`."""
    lead = results[0]["streams"]
    for r, res in enumerate(results):
        ev = res["streams"]
        toks = [t for _, tokens, _ in ev["single"] + ev["multi"][0] + ev["multi"][1]
                for t in tokens]
        log(f"parallel streams bf16 (1, 2) rank {r}: {res['streams_s']:.2f} s; "
            f"{len(ev['single'])} events of the stream, "
            f"{[len(e) for e in ev['multi']]} of the two multistream streams, "
            f"{len(toks)} tokens; equal to rank 0 {ev == lead}; launches "
            f"{res['streams_launches']}; on {card()}")
        if (ev != lead or not toks or not all(0 <= t < cfg.n_vocab for t in toks)
                or not all(e[-1][2] for e in [ev["single"], *ev["multi"]])):
            raise AssertionError(f"parallel streams failed on rank {r}: {ev}")
    return {"streams_1x2_s": results[0]["streams_s"],
            "streams_1x2_events": len(lead["single"]) + sum(map(len, lead["multi"]))}


def rank_pid(launcher: int, rank: int) -> int:
    """The pid of the torchrun worker of `rank`: a child of the launcher
    process with RANK=rank in its environment."""
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid != launcher:
                continue
            with open(f"/proc/{pid}/environ", "rb") as f:
                if f"RANK={rank}".encode() in f.read().split(b"\0"):
                    return int(pid)
        except OSError:  # a process that ended meanwhile
            continue
    raise AssertionError(f"no rank {rank} among the launcher's children")


def parallel_server() -> dict:
    """The HTTP server at large-v3-turbo int8 (int8 cross-KV) under
    `python -m torch.distributed.run --standalone --nproc-per-node 2 -m
    openai_whisper_coreml_tpu_torch.serve_http ... --tensor-parallel 2
    --warmup`: rank 0 serves, rank 1 follows its commands. Once /readyz is
    200: /transcribe with and without words, the OpenAI route (verbose_json
    words, json, srt), /detect, one /stream, two concurrent /transcribe
    requests, then /metrics; then an interrupt to rank 0 stops the server
    and releases rank 1, and the launcher must return 0. Cut for time: 8
    tokens a window (--sample-len 8), batches of 2, one temperature a
    request, a 2 s stream."""
    import signal
    import types

    from openai_whisper_coreml_tpu_torch.config import get_config

    cfg = get_config("large-v3-turbo")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    srv = types.SimpleNamespace(port=free_port())
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        log_path = os.path.join(tmp, "server.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", "2", "-m", "openai_whisper_coreml_tpu_torch.serve_http",
                 "--model", "large-v3-turbo", "--quantize", "int8", "--kv-dtype", "int8",
                 "--tensor-parallel", "2", "--host", "127.0.0.1", "--port", str(srv.port),
                 "--warmup", "--sample-len", "8", "--batch-size", "2"],
                stdout=logf, stderr=subprocess.STDOUT, env=env, cwd=root,
                start_new_session=True)
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"parallel server exited with {proc.returncode}")
                if time.perf_counter() - t0 > PARALLEL_TIMEOUT_S:
                    raise AssertionError("parallel server: /readyz never turned 200")
                try:
                    if http(srv, "/readyz")[0] == 200:
                        break
                except urllib.error.URLError:  # not listening yet
                    pass
                time.sleep(0.5)
            out["server_ready_s"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            short = wav_bytes(speechy(6, 80))
            code, raw = http(srv, "/transcribe?language=en&temperature=0", short)
            if code != 200:
                raise AssertionError(f"parallel server /transcribe: {code} {raw[:300]!r}")
            check_segments(json.loads(raw), cfg, 6.0)
            n_words, verbose = server_routes(srv, "parallel server", short, "0")
            code, raw = http(srv, "/stream?language=en", wav_bytes(speechy(2, 81)))
            lines = [json.loads(x) for x in raw.decode().splitlines() if x]
            if (code != 200 or not lines or lines[-1]["final"] is not True
                    or any("error" in x for x in lines)):
                raise AssertionError(f"parallel server /stream: {code} {lines}")
            pair = [None, None]

            def post(i):
                pair[i] = http(srv, "/transcribe?language=en&temperature=0",
                               wav_bytes(speechy(5 + 3 * i, 82 + i)))

            threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=PARALLEL_TIMEOUT_S)
            for (code, raw), sec in zip(pair, (5, 8)):
                if code != 200:
                    raise AssertionError(f"parallel server concurrent: {code} {raw[:300]!r}")
                check_segments(json.loads(raw), cfg, float(sec))
            code, raw = http(srv, "/metrics")
            metrics = json.loads(raw)
            if code != 200 or metrics["counters"]["requests_total"] < 7:
                raise AssertionError(f"parallel server /metrics: {code} {metrics}")
            out["server_requests_s"] = time.perf_counter() - t1
            os.kill(rank_pid(proc.pid, 0), signal.SIGINT)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            with open(log_path) as f:
                server_log = f.read()
    out["server_s"] = time.perf_counter() - t0
    log("parallel server log: " + " | ".join(
        line for line in server_log.splitlines()
        if "warmup done" in line or "serving" in line or "batch done" in line))
    log(f"parallel server (torch.distributed.run, 2 ranks, --tensor-parallel 2, "
        f"large-v3-turbo int8): rc {rc}; ready after {out['server_ready_s']:.1f} s "
        f"(the warm-up batch included), {metrics['counters'].get('requests_total')} "
        f"requests in {out['server_requests_s']:.1f} s, {n_words} words on "
        f"/transcribe, {len(verbose['words'])} in verbose_json, {len(lines)} stream "
        f"lines, {metrics['counters'].get('batches_total')} batches; "
        f"{out['server_s']:.1f} s in all on {card()}")
    if rc != 0:
        raise AssertionError(f"parallel server: the launcher returned {rc}:\n"
                             f"{server_log[-3000:]}")
    return out


def parallel_cli() -> float:
    """The CLI on a 35 s WAV (two 224-token windows) at large-v3-turbo int8
    (large-v3's widths and encoder, a 4-layer decoder) under
    torch.distributed.run with two ranks and --tensor-parallel 2: rank 0
    alone writes the files and reports them. The decoder's depth is cut
    for time: a large-v3 step of two ranks sharing the card cost
    0.26-0.41 s on an NVIDIA H100 80GB HBM3 at 700 W (each of its 96
    all-reduces waits for the other process's turn on the card), and the
    clip took 147 s there (a 20 s clip 76-114 s); decode and
    transcribe_batch hold large-v3's depth."""
    from openai_whisper_coreml_tpu_torch.config import get_config
    from openai_whisper_coreml_tpu_torch.utils.audio_io import save_wav

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "clip.wav")
        save_wav(wav, speechy(35, 5))
        out_dir = os.path.join(tmp, "out")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "openai_whisper_coreml_tpu_torch", wav,
             "--model", "large-v3-turbo", "--quantize", "int8", "--kv-dtype", "int8",
             "--dtype", "bfloat16", "--temperature-increment-on-fallback", "0",
             "--output-format", "all", "--language", "en", "--tensor-parallel", "2",
             "--output-dir", out_dir],
            capture_output=True, text=True, timeout=PARALLEL_TIMEOUT_S, env=env, cwd=root)
        seconds = time.perf_counter() - t
        reports = [l for l in proc.stderr.splitlines() if " -> " in l]
        files = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
        log(f"parallel cli (torch.distributed.run, 2 ranks, --tensor-parallel 2): "
            f"rc {proc.returncode}, {seconds:.1f} s wall on {card()}; files {files}; "
            f"reports {reports}; stdout {proc.stdout.strip()[-300:]!r}")
        if (proc.returncode != 0 or len(reports) != 1
                or files != [f"clip.{f}" for f in ("json", "srt", "tsv", "txt", "vtt")]):
            raise AssertionError(f"parallel cli failed:\n{proc.stderr[-3000:]}")
        with open(os.path.join(out_dir, "clip.json"), encoding="utf-8") as f:
            check_segments(json.load(f), get_config("large-v3-turbo"), 35.0)
    return seconds


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    import openai_whisper_coreml_tpu_torch as wt
    from openai_whisper_coreml_tpu_torch.ops import flash_attention as fa
    from openai_whisper_coreml_tpu_torch.ops import mel_kernel as mk
    from openai_whisper_coreml_tpu_torch.ops import sqa_int8 as si
    from openai_whisper_coreml_tpu_torch.ops import sqa_self as ss
    from openai_whisper_coreml_tpu_torch.ops import sqa_v3 as sv

    t_start = time.perf_counter()
    count_profiler_traces()
    log(card())
    log(sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = kernel_counters()

    # by library name; K3 (ss), K6 (si) and K2 (sv) are entry points of one
    # library
    build_kernels({"flash_attention": fa, "mel": mk, "sqa": sv})
    records = [check_flash(fa), *check_flash_causal(fa), check_mel(mk),
               check_sqa_self(ss), check_sqa_int8(si), check_sqa_v3(sv, si)]
    check_flash_grad(fa)
    fp32_parity(wt, fa, mk, si)
    spec_parity(wt)
    word_parity(wt, fa)
    convert_slice()
    train_parity(fa)
    sqa_v3_probe_slice(kernels)

    t0 = time.perf_counter()
    model = wt.load_model("large-v3", dtype=torch.bfloat16, quantize="int8",
                          device="cuda")
    torch.cuda.synchronize()
    log(f"large-v3 int8 loaded in {time.perf_counter() - t0:.1f} s, "
        f"{model.num_params} parameters")
    encoder = encoder_slice(model, kernels)
    plain = serve_slice(wt, model, kernels)
    draft = load_draft(wt, model)
    spec = spec_decode_slice(wt, model, draft, kernels, plain)
    spec_entry_points(wt, model, draft, kernels)
    transcribe_slice(model, kernels)
    serve_batch_slice(wt, model, kernels)
    words_slice(wt, model, kernels)
    # no quality gates: no window of the random model is skipped as silence;
    # 16-token windows (32 before the word requests joined)
    served = {"language": "en", "kv_dtype": "int8", "sample_len": 16,
              "temperature": (0.0,), "no_speech_threshold": None}
    server_slice(model, kernels, "server static", served, WORDS_IDLE)
    # then with the turbo draft on the model, as `--draft-model` sets it
    model.draft = draft
    try:
        server_slice(model, kernels, "server static draft",
                     {**served, "spec_k": SPEC_K, "spec_fallback": False},
                     SERVING_IDLE, spec=True)
    finally:
        model.draft = None
    del draft
    server_slice(model, kernels, "server continuous beam",
                 {**served, "scheduler": "continuous", "beam_size": 2,
                  "chunk_tokens": 16}, WORDS_IDLE)
    multistream_slice(model, kernels)
    parallel = parallel_slice(wt, model, kernels)
    profile_step(model, ss, si)
    del model
    torch.cuda.empty_cache()
    cli_slice(kernels)
    cli_stream_slice(kernels)
    finetune_slice(kernels)
    evaluation = eval_slice(wt, kernels)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "tiny-trained.safetensors")
        pair = trained_pair_slice(wt, kernels, ckpt)
        profile = profile_slice(kernels, ckpt)

    for record in records:
        record["launches"] = TOTALS[record["name"]]
    records[0]["encoder_large_v3_b4"] = encoder
    log("spec_decode: " + json.dumps(spec))
    log("evaluate: " + json.dumps({k: v for k, v in evaluation.items() if k != "examples"}))
    log("trained pair: " + json.dumps({k: pair[k] for k in (
        "acceptance_rate", "tokens_per_iter", "wer_plain", "wer_spec", "card")}))
    log("profile: " + json.dumps(profile))
    log("parallel: " + json.dumps(parallel))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": records}))
    log(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
