"""What the per-layer readers read, and the arithmetic they share.

A traced run leaves one `Record`: the traced slice on the card
(`trace.SliceRecord`), the program's own counters read around it, and
what the harness knows of the slice's work. Each reader in `metrics/`
takes the record and returns a number, or None where it finds nothing to
read (the harness then leaves the metric out)."""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .spec import HERE
from .trace import SliceRecord, kernels_named

K1 = ("fa_fwd_bf16_kernel<false>",)
K3 = ("sqa_kernel<", "Bf16KV")
K6 = ("sqa_kernel<", "Int8KV")


@dataclass
class Record:
    dims: Dict[str, int]
    slice: Optional[SliceRecord] = None
    counters: Dict[str, float] = field(default_factory=dict)  # program counters over the slice
    window_counters: Dict[str, float] = field(default_factory=dict)  # over the whole window
    decode: Dict[str, Any] = field(default_factory=dict)  # prompt_len, sample_len
    windows: int = 0  # windows the harness handed the slice


def load_reader(name: str):
    """`metrics/<name>.py`'s `read`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def roofline_pct(rec: Record, parts, cost) -> Optional[float]:
    """Sum of the kernels' bounds over the sum of their device times, in %;
    `cost(kernel)` gives a launch's bound in seconds."""
    ks = kernels_named(rec.slice, *parts)
    spent = sum(k.end_ns - k.start_ns for k in ks) * 1e-9
    if not ks or spent <= 0:
        return None
    return 100.0 * sum(cost(k) for k in ks) / spent


def idle_pct(rec: Record) -> Optional[float]:
    if rec.slice is None or rec.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.slice.busy_s / rec.slice.window_s)


def slice_work(rec: Record) -> Dict[str, float]:
    """The model work the slice completed, read from its launches: windows
    encoded (K1's grid rows over the encoder's layers), single-token row
    steps (K3's grid rows over the decoder's layers) and the prompt tokens
    of each window decoded."""
    d = rec.dims
    windows = sum(k.grid[2] for k in kernels_named(rec.slice, *K1)) / d["n_audio_layer"]
    steps = sum(k.grid[2] for k in kernels_named(rec.slice, *K3)) / d["n_text_layer"]
    prompt = rec.decode.get("prompt_len", 0)
    sample = rec.decode.get("sample_len", 1)
    return {"windows": windows, "row_steps": steps, "prompt_tokens": prompt * windows,
            "context": prompt + sample / 2.0 + 0.5}


def mfu_pct(rec: Record) -> Optional[float]:
    """Model FLOPs of the slice's work over its length times the bf16 dense
    peak, in %."""
    from portbench.metrics import counts

    if rec.slice is None or rec.slice.window_s <= 0:
        return None
    w = slice_work(rec)
    if w["windows"] <= 0 and w["row_steps"] <= 0:
        return None
    flops = counts.model_flops(rec.dims, w["windows"], w["windows"],
                               w["row_steps"] + w["prompt_tokens"], w["context"])
    return 100.0 * flops / (rec.slice.window_s * counts.PEAK_OPS_S["bf16"])
