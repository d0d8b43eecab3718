"""Tracing / profiling utilities (port of `utils/profiling.py`).

Named stage timers aggregated into reports (RTFx per stage), and a context
manager around `torch.profiler` for device-level traces (CPU ops and CUDA
kernels) that TensorBoard's profiler plugin or Perfetto can read.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional


@dataclass
class StageTimer:
    """Accumulates wall time + work units per named stage."""

    totals: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    units: Dict[str, float] = field(default_factory=lambda: defaultdict(float))

    @contextlib.contextmanager
    def stage(self, name: str, work_units: float = 0.0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.units[name] += work_units

    def report(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name, total in self.totals.items():
            entry = {
                "seconds": round(total, 4),
                "calls": self.counts[name],
                "mean_ms": round(1e3 * total / max(self.counts[name], 1), 3),
            }
            if self.units[name]:
                entry["units_per_sec"] = round(self.units[name] / total, 2)
            out[name] = entry
        return out

    def dump(self) -> str:
        return json.dumps(self.report(), sort_keys=True)


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
    written into `logdir` as `<host>_<pid>.<ns>.pt.trace.json` (Chrome trace
    format: TensorBoard's profiler plugin, Perfetto, chrome://tracing) when
    logdir is set; no-op otherwise. On the card the trace opens with a
    region of marker kernels, `device_trace_markers`."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                tensorboard_trace_handler)

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        if on_card:
            with record_function("device_trace_markers"):
                marker = torch.zeros(1, device="cuda")
                for _ in range(_MARKER_KERNELS):
                    marker.add_(1)
                torch.cuda.synchronize()
        yield
        if on_card:
            torch.cuda.synchronize()


def annotate(name: str):
    """Named region inside a device trace (torch.profiler.record_function)."""
    import torch

    return torch.profiler.record_function(name)
