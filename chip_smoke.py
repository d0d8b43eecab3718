"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Phases (each raises, so the script exits non-zero, on failure):
  1. find the card (exit non-zero without CUDA) and print its name and
     power limit;
  2. build the Hopper flash-attention kernel from csrc/ and time the build;
  3. hold the kernel against its plain PyTorch version on the card at the
     encoder's geometry (bf16) and on a ragged shape, in bf16 and fp32, and
     time both at the encoder's geometry;
  4. fp32 parity: one tiny model (full 1500-position audio context, head
     dim 64) decodes the same mel on the CPU and on the card; the greedy
     tokens must be equal and the kernel must have run;
  5. the slice: large-v3 with random bf16/int8 weights serves a batch of 4
     random 30 s windows, then one window, then language ID on the batch;
     the kernel must have launched once per encoder layer per encoder call.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Needs no network and no JAX.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

BF16_MAX_ABS, BF16_MEAN_ABS, FP32_MAX_ABS = 1e-2, 1e-3, 2e-5


def log(*args):
    print(*args, flush=True)


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


def check_kernel(fa) -> dict:
    """Kernel vs plain version on the same inputs; returns the JSON record."""
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
            ref = fa.flash_attention_reference(q, k, v).float()
            err = (out.float() - ref).abs()
            max_abs, mean_abs = err.max().item(), err.mean().item()
            log(f"kernel vs plain {shape} {dtype}: max_abs {max_abs:.3e} "
                f"mean_abs {mean_abs:.3e}")
            if dtype == torch.bfloat16:
                ok = max_abs <= BF16_MAX_ABS and mean_abs <= BF16_MEAN_ABS
                worst = max(worst, max_abs)
                if shape[1] == 1500:
                    timing = (q, k, v)
            else:
                ok = max_abs <= FP32_MAX_ABS
            if not (ok and torch.isfinite(out).all()):
                raise AssertionError(f"flash kernel disagrees at {shape} {dtype}")
    q, k, v = timing
    times = {}
    for name, fn in (("plain", fa.flash_attention_reference),
                     ("kernel", fa.flash_attention),
                     ("kernel2", fa.flash_attention),
                     ("plain2", fa.flash_attention_reference)):
        times[name] = cuda_ms(lambda: fn(q, k, v))
    kernel_ms = min(times["kernel"], times["kernel2"])
    plain_ms = min(times["plain"], times["plain2"])
    log(f"flash (4,1500,20,64) bf16 on {card()}: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (runs: {times})")
    return {"name": "flash_attention", "route": "cuda",
            "source": "openai_whisper_coreml_tpu_torch/csrc/flash_attention.cu",
            "replaces": "openai_whisper_coreml_tpu/ops/flash_attention.py:57",
            "max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms}


def fp32_parity(wt, fa):
    from openai_whisper_coreml_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config(n_state=128, n_head=2, n_layer=2)  # D=64, T=1500
    cpu = wt.build_model(cfg, dtype=torch.float32, seed=0, device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    audio = (np.random.default_rng(1).standard_normal((2, 480_000)) * 0.1
             ).astype(np.float32)
    mel = cpu.log_mel(audio)
    mel_err = (gpu.log_mel(audio).cpu() - mel).abs().max().item()
    opts = wt.DecodingOptions(language="en", sample_len=64)
    before = fa.launches
    res_gpu = gpu.decode(mel.cuda(), opts)
    launched = fa.launches - before
    res_cpu = cpu.decode(mel, opts)
    toks_gpu = [r.tokens for r in res_gpu]
    toks_cpu = [r.tokens for r in res_cpu]
    log(f"fp32 parity: mel max_abs {mel_err:.3e}; tokens equal "
        f"{toks_gpu == toks_cpu} ({[len(t) for t in toks_gpu]} tokens); "
        f"kernel launches {launched}")
    if mel_err > 1e-4 or toks_gpu != toks_cpu or launched != cfg.n_audio_layer:
        raise AssertionError(f"fp32 CPU/CUDA parity failed: {toks_cpu} vs "
                             f"{toks_gpu}, launches {launched}")


def serve_slice(wt, fa) -> int:
    t0 = time.perf_counter()
    model = wt.load_model("large-v3", dtype=torch.bfloat16, quantize="int8",
                          device="cuda")
    torch.cuda.synchronize()
    cfg = model.cfg
    log(f"large-v3 int8 loaded in {time.perf_counter() - t0:.1f} s, "
        f"{model.num_params} parameters")
    audio = (np.random.default_rng(0).standard_normal((4, 480_000)) * 0.1
             ).astype(np.float32)
    opts = wt.DecodingOptions(language="en", kv_dtype="int8", sample_len=224)
    requests = (("decode batch 4", lambda: model.decode(model.log_mel(audio), opts)),
                ("decode batch 1", lambda: model.decode(model.log_mel(audio[:1]), opts)),
                ("detect_language batch 4",
                 lambda: model.detect_language(model.log_mel(audio))))
    where = card()
    fa.launches = 0
    outputs = []
    for name, fn in requests:
        t = time.perf_counter()
        outputs.append(fn())
        torch.cuda.synchronize()
        log(f"{name}: {time.perf_counter() - t:.3f} s wall on {where}")
    launches = fa.launches

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
    expected = 3 * cfg.n_audio_layer  # three encoder calls
    log(f"flash kernel launches on the large-v3 path: {launches} "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError(f"flash kernel launched {launches} times, "
                             f"expected {expected}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    import openai_whisper_coreml_tpu_torch as wt
    from openai_whisper_coreml_tpu_torch.ops import _build
    from openai_whisper_coreml_tpu_torch.ops import flash_attention as fa

    log(card())
    log(sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    fa.load_kernel()
    info = _build.BUILD_INFO["flash_attention"]
    log(f"flash kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['seconds']:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line:
            log("  ptxas:", line.strip())

    record = check_kernel(fa)
    fp32_parity(wt, fa)
    record["launches"] = serve_slice(wt, fa)

    log(json.dumps({"kernels": [record]}))
    log(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
