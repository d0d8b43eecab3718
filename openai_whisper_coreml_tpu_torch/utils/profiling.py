"""Spans and device traces (port of `utils/profiling.py`).

A span names a region of the port's work in a torch.profiler trace: a
`torch.profiler.record_function` range, on the same clock as the CUDA
kernels and the runtime calls that launched them, so that each kernel can
be given to the span that was open when it was launched. The trace is the
span store; it is written out when the trace ends.

Spans are off unless a `spans_on()` context is open. Off, `annotate`
returns one shared no-op context and makes no `record_function`, and the
sites that run several times a layer (the linears' and the norm's) test
`SPANS` with a plain `if` and enter no context at all. `device_trace`
(the CLI's `--profile-dir`) opens `spans_on`.

The spans (PERF.md §3 names the metric each one serves):

    mel               audio.log_mel_spectrogram
    encoder           models/encoder.AudioEncoder.forward
    layer_norm        models/layers.layer_norm
    linear.weight_cast  the int8 weight's cast in models/layers.fp32_product
                      and before a fused linear
    linear.epilogue   scale, LoRA term, bias and cast of every unfused linear
    linear.fused      each launch of ops.fused_linear (models/layers.linear)
    cross_kv          models/decoder.precompute_cross_kv(_int8)
    decode_step       models/decoder.decode_step
    lang_step         decoding._detect_language_core
    lang_results      decoding.detect_language's copies and dicts
    fallback_round    each rung above temperature 0 in serve
    reassemble        serve._reassemble

The audio language model's (`models/audio_lm.py`, `models/moe.py`):

    connector         the encoder's frames pooled and projected to tokens
    rms_norm          models/layers.rms_norm
    attention         the decoder's attention core: RoPE, the packed rows
                      laid out (B, T), PyTorch's fused attention (no kernel
                      of the port takes GQA at head dim 128) and back; its
                      q/k/v and o linears are outside it
    moe               models/moe.MoE.forward, inclusive of:
    moe.router        the fp32 gate, softmax, top-p pick, the host's counts
    moe.permute       the routed rows grouped by expert (sort and gather)
    moe.experts       each held routed expert's SwiGLU on its rows
    moe.shared        the shared experts on every row
    moe.combine       the weighted scatter-add of the experts' rows
    lm_head           the last rows' norm, the untied head, log-softmax
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Iterator, Optional, TypeVar

import torch

F = TypeVar("F", bound=Callable)

SPANS = False  # True while a spans_on() context is open; set only there
_OFF = contextlib.nullcontext()
_open = 0  # spans_on() contexts open, across threads
_open_lock = threading.Lock()


@contextlib.contextmanager
def spans_on() -> Iterator[None]:
    """Turn the port's spans on for the body (nested and concurrent
    contexts count: spans stay on until the last one closes)."""
    global SPANS, _open
    with _open_lock:
        _open += 1
        SPANS = True
    try:
        yield
    finally:
        with _open_lock:
            _open -= 1
            SPANS = _open > 0


def annotate(name: str):
    """The span `name` when spans are on (a record_function range), else
    one shared no-op context."""
    if not SPANS:
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str) -> Callable[[F], F]:
    """Decorator: each call of the function is the span `name`."""
    def wrap(fn: F) -> F:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not SPANS:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


# torch.profiler drops records at the start of each trace, and the more
# traces a process has taken the more it drops (torch 2.11 on an NVIDIA H100:
# past 64 kernel records in a process with chip_smoke.py's few dozen earlier
# traces, where the CLI's one log-mel launch went missing; chip_smoke.py
# counts the loss, PERF.md). A run of marker kernels opens each trace and
# takes the loss, so the traced code's kernels stay
_MARKER_KERNELS = 1024


@contextlib.contextmanager
def device_trace(logdir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace of the CPU and, with a card, its CUDA kernels,
    with the port's spans on, written into `logdir` as
    `<host>_<pid>.<ns>.pt.trace.json` (Chrome trace format: TensorBoard's
    profiler plugin, Perfetto, chrome://tracing) when logdir is set; no-op
    otherwise. On the card the trace opens with a region of marker
    kernels, `device_trace_markers`."""
    if not logdir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                tensorboard_trace_handler)

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)), spans_on():
        if on_card:
            with record_function("device_trace_markers"):
                marker = torch.zeros(1, device="cuda")
                for _ in range(_MARKER_KERNELS):
                    marker.add_(1)
                torch.cuda.synchronize()
        yield
        if on_card:
            torch.cuda.synchronize()
