"""A traced slice of a run: `torch.profiler` over the card's activity
(kernels, copies, sets, and the host's CUDA runtime and driver calls),
reduced to plain records that the per-layer readers take.

The slice opens with 1,024 marker kernels, which take the loss of the
records that torch.profiler drops at a trace's start, then a float64 fill
that marks where the slice begins on the device; it ends with a second
fill after the slice's work has been synchronised. The slice's length is
the time between the two fills on the device's clock, and every device
interval between them counts as busy."""

from __future__ import annotations

import bisect
import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
                "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                "cudaLaunchCooperativeKernel")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER_KERNELS = 1024


@dataclass
class Kernel:
    name: str
    start_ns: int
    end_ns: int
    grid: Tuple[int, int, int]


@dataclass
class SliceRecord:
    """What one traced slice saw on the card."""

    window_ns: Tuple[int, int]  # the slice on the device's clock
    device: List[Tuple[int, int, str]] = field(default_factory=list)  # busy intervals
    kernels: List[Kernel] = field(default_factory=list)
    launches: int = 0  # host launch calls in the slice
    runtime: List[Tuple[int, int, str]] = field(default_factory=list)  # host CUDA calls
    host_s: float = 0.0  # the slice on the host's clock

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return union_ns([(a, b) for a, b, _ in self.device], self.window_ns) * 1e-9


def union_ns(intervals, window: Tuple[int, int]) -> int:
    """Length of the union of `intervals` clipped to `window`."""
    lo, hi = window
    spans = sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi)
    total, cur_a, cur_b = 0, None, None
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def idle_gaps(rec: SliceRecord, top: int = 10) -> List[List]:
    """The idle time between device intervals, summed by what the host did
    for most of it (the CUDA call it was in, else "python") and the
    operation the card woke for: [label, seconds], longest first."""
    lo, hi = rec.window_ns
    spans = sorted((a, b, n) for a, b, n in rec.device if b > lo and a < hi)
    runtime = sorted(rec.runtime)
    starts = [r[0] for r in runtime]
    by: Dict[str, float] = {}
    cur = lo
    for a, b, name in spans + [(hi, hi, "slice end")]:
        if a > cur:
            j = bisect.bisect_left(starts, a) - 1
            host = "python"
            if j >= 0 and 2 * (min(runtime[j][1], a) - max(runtime[j][0], cur)) >= a - cur:
                host = runtime[j][2]
            label = f"{host} before {short(name)}"
            by[label] = by.get(label, 0.0) + (a - cur) * 1e-9
        cur = max(cur, b)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def device_ops(rec: SliceRecord, top: int = 10) -> List[List]:
    """Device time by kernel (or copy) name: [name, seconds], most first."""
    by: Dict[str, float] = {}
    for a, b, name in rec.device:
        by[short(name)] = by.get(short(name), 0.0) + (b - a) * 1e-9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def short(name: str, width: int = 160) -> str:
    """A kernel's name without its argument list and namespaces, at most
    `width` long."""
    for ns in ("(anonymous namespace)::", "at::native::", "std::"):
        name = name.replace(ns, "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    s = "".join(out).strip()
    return s[:width]


def _grid(meta: str) -> Tuple[int, int, int]:
    if not meta:
        return (0, 0, 0)
    try:
        obj = json.loads(meta if meta.lstrip().startswith("{") else "{" + meta + "}")
    except ValueError:
        return (0, 0, 0)
    g = obj.get("grid") or [0, 0, 0]
    return (int(g[0]), int(g[1]), int(g[2]))


@contextlib.contextmanager
def traced_slice(device, out: list):
    """Trace the body's work on `device`; appends its SliceRecord to `out`
    when the body ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flag = torch.empty(1, dtype=torch.float64, device=device)
        marker = torch.ones(1, device=device)
        for _ in range(MARKER_KERNELS):
            marker.add_(1)
        torch.cuda.synchronize(device)
        flag.fill_(1.0)
        h0 = time.perf_counter()
        yield
        torch.cuda.synchronize(device)
        host_s = time.perf_counter() - h0
        flag.fill_(2.0)
        torch.cuda.synchronize(device)
    events = prof.profiler.kineto_results.events()
    rec = reduce(events, host_s)
    if rec.kernels and not any(k.grid[2] for k in rec.kernels):
        # this torch's events carry no launch metadata: read the grids
        # from the Chrome trace
        rec = reduce(events, host_s, chrome_grids(prof))
    out.append(rec)


def _kind(e) -> str:
    """An event's kind: kineto's activity type where the event carries it,
    else from its device and name (kernels, copies and sets run on the
    device; the host's CUDA calls are named cuda* / cu*)."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return str(at())
    name = e.name()
    if "CUDA" in str(e.device_type()):
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def reduce(events, host_s: float, grids=None) -> SliceRecord:
    """The kineto events of a traced slice as a SliceRecord. `grids` gives
    each kernel name's grids in time order, where the events do not carry
    their launch metadata."""
    fills, device, kernels, runtime = [], [], [], []
    for e in events:
        kind = _kind(e)
        name = e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if kind in DEVICE_KINDS:
            if kind == "kernel" and "FillFunctor<double>" in name:
                fills.append((a, b))
                continue
            device.append((a, b, name))
            if kind == "kernel":
                meta = getattr(e, "metadata_json", None)
                kernels.append(Kernel(name, a, b, _grid(meta()) if meta else (0, 0, 0)))
        elif kind in ("cuda_runtime", "cuda_driver"):
            runtime.append((a, b, name))
    if len(fills) < 2:
        raise RuntimeError(f"traced slice: {len(fills)} of its 2 marker fills recorded")
    if grids is not None:
        kernels.sort(key=lambda k: k.start_ns)
        taken: Dict[str, int] = {}
        for k in kernels:
            i = taken.get(k.name, 0)
            taken[k.name] = i + 1
            if i < len(grids.get(k.name, ())):
                k.grid = grids[k.name][i]
    fills.sort()
    lo, hi = fills[0][1], fills[-1][0]
    rec = SliceRecord((lo, hi), host_s=host_s)
    rec.device = [d for d in device if d[1] > lo and d[0] < hi]
    rec.kernels = [k for k in kernels if lo <= k.start_ns < hi]
    rec.runtime = [r for r in runtime if lo <= r[0] < hi]
    rec.launches = sum(1 for _, _, n in rec.runtime if n in LAUNCH_CALLS)
    return rec


def chrome_grids(prof) -> dict:
    """Kernel name -> its launches' grids in time order, from the
    profiler's Chrome trace (written under TMPDIR, read, removed): for a
    torch whose events do not carry their launch metadata."""
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    launches = sorted((ev["ts"], ev["name"], tuple(int(x) for x in ev["args"]["grid"]))
                      for ev in doc.get("traceEvents", [])
                      if ev.get("cat") == "kernel" and "grid" in ev.get("args", {}))
    grids: Dict[str, list] = {}
    for _, name, grid in launches:
        grids.setdefault(name, []).append(grid)
    return grids


def kernels_named(rec: Optional[SliceRecord], *parts: str) -> List[Kernel]:
    """The slice's kernels whose name holds every one of `parts`."""
    if rec is None:
        return []
    return [k for k in rec.kernels if all(p in k.name for p in parts)]
