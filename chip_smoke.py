"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Phases (each raises, so the script exits non-zero, on failure):
  1. find the card (exit non-zero without CUDA) and print its name and
     power limit;
  2. build the Hopper kernels from csrc/, one nvcc per source, all at once,
     and print ptxas' register and shared-memory lines;
  3. hold the flash-attention kernel (K1) against its plain PyTorch version
     at the encoder's geometry (bf16) and on a ragged shape, in bf16 and
     fp32, and time both at the encoder's geometry;
  4. hold the log-mel kernel (K4) against its plain version at (4, 480 000)
     x 128 mels, a ragged (3, 112 000) x 80 and a one-hour bucket
     (1, 61 920 000) x 128; time both at the first and the last shape and
     record both's peak device memory at the last;
  5. fp32 parity: one tiny model (full 1500-position audio context, head
     dim 64) decodes the same mel, and transcribes the same 50 s audio, on
     the CPU and on the card; tokens and segments must be equal;
  6. the serving slice: large-v3 with random bf16/int8 weights serves a
     batch of 4 random 30 s windows, then one window, then language ID;
  7. long-form transcribe of ~70 s audio on that model: int8 cross-KV, the
     ladder (0.0, 0.4) with beam 2 on t=0 and best_of 2 above;
  8. the CLI in-process on a 35 s WAV: large-v3, int8 weights and
     cross-KV, bf16, all five output formats.
Phases 6-8 are the main paths: each starts with the kernels' launch counts
at 0 and checks them against what the path implies (one K4 launch per
log-mel call, one K1 launch per encoder layer per encode).

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Needs no network and no JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BF16_MAX_ABS, BF16_MEAN_ABS, FP32_MAX_ABS = 1e-2, 1e-3, 2e-5
MEL_MAX_ABS = 1e-4
SR = 16_000


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


def alternate(plain, kernel, iters=20) -> tuple[float, float, dict]:
    """Time plain, kernel, kernel, plain; the best of each pair."""
    times = {}
    for name, fn in (("plain", plain), ("kernel", kernel), ("kernel2", kernel),
                     ("plain2", plain)):
        times[name] = cuda_ms(fn, iters)
    return (min(times["kernel"], times["kernel2"]),
            min(times["plain"], times["plain2"]), times)


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
            if "registers" in line or "spill" in line:
                log("    ptxas:", line.strip())


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
            ref = fa.flash_attention_reference(q, k, v).float()
            err = (out.float() - ref).abs()
            max_abs, mean_abs = err.max().item(), err.mean().item()
            log(f"flash kernel vs plain {shape} {dtype}: max_abs {max_abs:.3e} "
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
    kernel_ms, plain_ms, times = alternate(
        lambda: fa.flash_attention_reference(q, k, v),
        lambda: fa.flash_attention(q, k, v))
    log(f"flash (4,1500,20,64) bf16 on {card()}: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (runs: {times})")
    return {"name": "flash_attention", "route": "cuda",
            "source": "openai_whisper_coreml_tpu_torch/csrc/flash_attention.cu",
            "replaces": "openai_whisper_coreml_tpu/ops/flash_attention.py:57",
            "max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms}


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


def check_mel(mk) -> dict:
    """K4 vs its plain version on the same padded audio; the JSON record
    carries the times at (4, 480 000) x 128."""
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    record = None
    for b, n, n_mels in ((4, 480_000, 128), (3, 16_000 * 7, 80),
                         (1, 61_920_000, 128)):
        x = torch.randn(b, n, generator=g, device="cuda") * 0.1
        padded = torch.nn.functional.pad(x[:, None], (200, 200), mode="reflect")[:, 0]
        out = mk.log_mel_kernel(padded, n_mels)
        torch.cuda.synchronize()
        err = (out - mk.log_mel_kernel_reference(padded, n_mels)).abs()
        max_abs, mean_abs = err.max().item(), err.mean().item()
        log(f"mel kernel vs plain ({b}, {n}) x {n_mels}: max_abs {max_abs:.3e} "
            f"mean_abs {mean_abs:.3e}")
        if not (max_abs <= MEL_MAX_ABS and torch.isfinite(out).all()):
            raise AssertionError(f"mel kernel disagrees at ({b}, {n}) x {n_mels}")
        worst = max(worst, max_abs)
        if n_mels == 80:
            continue
        kernel_ms, plain_ms, times = alternate(
            lambda: mk.log_mel_kernel_reference(padded, n_mels),
            lambda: mk.log_mel_kernel(padded, n_mels), iters=10)
        log(f"mel ({b}, {n}) x {n_mels} on {card()}: kernel {kernel_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms (runs: {times})")
        if record is None:
            record = {"name": "log_mel", "route": "cuda",
                      "source": "openai_whisper_coreml_tpu_torch/csrc/mel.cu",
                      "replaces": "openai_whisper_coreml_tpu/ops/mel_kernel.py:51",
                      "ms": kernel_ms, "plain_ms": plain_ms}
        else:
            kernel_peak = peak_bytes(lambda: mk.log_mel_kernel(padded, n_mels))
            plain_peak = peak_bytes(lambda: mk.log_mel_kernel_reference(padded, n_mels))
            log(f"mel one-hour bucket peak device memory beyond its input: "
                f"kernel {kernel_peak} B, plain {plain_peak} B")
    record["max_abs_err"] = worst
    return record


def fp32_parity(wt, fa, mk):
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
    log(f"fp32 decode parity: mel max_abs {mel_err:.3e}; tokens equal "
        f"{toks_gpu == toks_cpu} ({[len(t) for t in toks_gpu]} tokens); "
        f"flash launches {launched}")
    if mel_err > 1e-4 or toks_gpu != toks_cpu or launched != cfg.n_audio_layer:
        raise AssertionError(f"fp32 CPU/CUDA parity failed: {toks_cpu} vs "
                             f"{toks_gpu}, launches {launched}")

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

    def key(segs):
        return [(s["seek"], s["start"], s["end"], s["tokens"], s["text"])
                for s in segs]

    log(f"fp32 transcribe parity (50 s): mel max_abs card vs cpu {mel_err:.3e}; "
        f"{len(seg_gpu)} segments, equal {key(seg_gpu) == key(seg_cpu)}; "
        f"mel launches {mel_launches}")
    # the segments are the gate; the mel is held to the frontend's fidelity
    # gate (1e-3 against fp64): on this input fp32 already puts the lowest,
    # low-energy mel band ~7e-5 from an fp64 oracle on the CPU alone
    if key(seg_gpu) != key(seg_cpu) or mel_launches != 1 or mel_err > 1e-3:
        raise AssertionError(f"fp32 transcribe parity failed:\n{key(seg_cpu)}\n"
                             f"vs\n{key(seg_gpu)}")


# launches of each kernel summed over the main paths
TOTALS: dict = {}


@contextlib.contextmanager
def main_path(name, kernels):
    """Count the path's kernel launches from 0, and its encoder layers and
    log-mel calls; on exit check that K1 launched once per encoder layer
    run and K4 once per log-mel call, and that both launched."""
    from openai_whisper_coreml_tpu_torch.models.whisper import WhisperModel

    calls = {"encode": 0, "encoder_layers": 0, "log_mel": 0}
    encode, log_mel = WhisperModel.encode, WhisperModel.log_mel

    def counting_encode(self, mel):
        calls["encode"] += 1
        calls["encoder_layers"] += self.cfg.n_audio_layer
        return encode(self, mel)

    def counting_log_mel(self, audio):
        calls["log_mel"] += 1
        return log_mel(self, audio)

    WhisperModel.encode, WhisperModel.log_mel = counting_encode, counting_log_mel
    for mod in kernels.values():
        mod.launches = 0
    t = time.perf_counter()
    try:
        yield calls
        torch.cuda.synchronize()
    finally:
        WhisperModel.encode, WhisperModel.log_mel = encode, log_mel
    seconds = time.perf_counter() - t
    launches = {k: mod.launches for k, mod in kernels.items()}
    expected = {"flash_attention": calls["encoder_layers"],
                "log_mel": calls["log_mel"]}
    log(f"[{name}] {seconds:.3f} s wall on {card()}; calls {calls}; "
        f"launches {launches}, expected {expected}")
    if launches != expected or not all(launches.values()):
        raise AssertionError(f"{name}: kernel launches {launches}, "
                             f"expected {expected}")
    for k, n in launches.items():
        TOTALS[k] = TOTALS.get(k, 0) + n


def serve_slice(wt, model, kernels):
    cfg = model.cfg
    audio = (np.random.default_rng(0).standard_normal((4, 480_000)) * 0.1
             ).astype(np.float32)
    opts = wt.DecodingOptions(language="en", kv_dtype="int8", sample_len=224)
    outputs = []
    with main_path("serve", kernels) as calls:
        for name, fn in (
                ("decode batch 4", lambda: model.decode(model.log_mel(audio), opts)),
                ("decode batch 1", lambda: model.decode(model.log_mel(audio[:1]), opts)),
                ("detect_language batch 4",
                 lambda: model.detect_language(model.log_mel(audio)))):
            t = time.perf_counter()
            outputs.append(fn())
            torch.cuda.synchronize()
            log(f"{name}: {time.perf_counter() - t:.3f} s wall")
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


def check_segments(result, cfg, duration):
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
        if prev is not None and (s["seek"] < prev["seek"] or s["start"] < prev["start"]):
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


def cli_slice(kernels):
    from openai_whisper_coreml_tpu_torch import cli
    from openai_whisper_coreml_tpu_torch.config import get_config
    from openai_whisper_coreml_tpu_torch.utils.audio_io import save_wav

    cfg = get_config("large-v3")
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "clip.wav")
        save_wav(wav, speechy(35, 5))
        with main_path("cli", kernels):
            rc = cli.main([wav, "--model", "large-v3", "--quantize", "int8",
                           "--kv-dtype", "int8", "--dtype", "bfloat16",
                           "--temperature-increment-on-fallback", "0",
                           "--output-format", "all", "--language", "en",
                           "--output-dir", tmp])
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        sizes = {}
        for fmt in ("txt", "srt", "vtt", "tsv", "json"):
            path = os.path.join(tmp, f"clip.{fmt}")
            sizes[fmt] = os.path.getsize(path)
        with open(os.path.join(tmp, "clip.json"), encoding="utf-8") as f:
            result = json.load(f)
        with open(os.path.join(tmp, "clip.vtt"), encoding="utf-8") as f:
            vtt = f.read()
    check_segments(result, cfg, 35.0)
    if not vtt.startswith("WEBVTT") or min(sizes.values()) == 0:
        raise AssertionError(f"cli output files: {sizes}")
    log(f"cli wrote {sizes} bytes; {len(result['segments'])} segments")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    import openai_whisper_coreml_tpu_torch as wt
    from openai_whisper_coreml_tpu_torch.ops import flash_attention as fa
    from openai_whisper_coreml_tpu_torch.ops import mel_kernel as mk

    log(card())
    log(sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {"flash_attention": fa, "log_mel": mk}

    build_kernels({"flash_attention": fa, "mel": mk})
    records = [check_flash(fa), check_mel(mk)]
    fp32_parity(wt, fa, mk)

    t0 = time.perf_counter()
    model = wt.load_model("large-v3", dtype=torch.bfloat16, quantize="int8",
                          device="cuda")
    torch.cuda.synchronize()
    log(f"large-v3 int8 loaded in {time.perf_counter() - t0:.1f} s, "
        f"{model.num_params} parameters")
    serve_slice(wt, model, kernels)
    transcribe_slice(model, kernels)
    del model
    torch.cuda.empty_cache()
    cli_slice(kernels)

    for record in records:
        record["launches"] = TOTALS[record["name"]]
    log(json.dumps({"kernels": records}))
    log(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
