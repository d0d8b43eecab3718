"""A spanned slice: a traced slice (`trace.traced_slice`'s markers and
fills) with the host's CPU activity recorded too and the program's spans
on, reduced to device time and idle gaps by span.

Each kernel, copy and set is given to the innermost span open on the host
when the runtime call that launched it ran: kineto's correlation id joins
the device activity to its call, and the call's thread and start find the
span. The device runs later than the span, so device times are never
compared with it. Activity launched under no span is "unspanned"; an idle
gap is named by the innermost span open on the host for most of it, else
"harness".

`portbench/spans.py` takes a plain and a spanned slice of a language-ID
cell and prints what this module reads from them (`SPAN_METRICS`). The
benchmark's traced runs do not take a spanned slice."""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .trace import DEVICE_KINDS, MARKER_KERNELS, SliceRecord, _kind, reduce, short

UNSPANNED = "unspanned"
HARNESS = "harness"

# name -> (span, inclusive): device time under the span (inclusive: launched
# under it or a span nested in it; self: its innermost span is that one),
# in ms a window
SPAN_METRICS = {
    "langid.mel_ms_per_window": ("mel", True),
    "langid.encoder_ms_per_window": ("encoder", True),
    "langid.linear_epilogue_ms_per_window": ("linear.epilogue", False),
    "langid.weight_cast_ms_per_window": ("linear.weight_cast", False),
    "langid.layer_norm_ms_per_window": ("layer_norm", False),
    "langid.cross_kv_ms_per_window": ("cross_kv", True),
}


@dataclass
class SpanSlice:
    """What a spanned slice saw: its device activity (`slice`), the
    program's spans on the host, and for each of `slice.device` the spans
    open on the host when it was launched, outermost first (none:
    unspanned)."""

    slice: SliceRecord
    spans: List[Tuple[int, int, str, int]] = field(default_factory=list)  # start, end, name, thread
    chains: List[Tuple[str, ...]] = field(default_factory=list)


@contextlib.contextmanager
def spanned_slice(device, out: list, spans_on):
    """Trace the body's work on `device` and the host's CPU activity with
    the program's spans on (`spans_on`, the program's context), between
    the same markers and fills as `trace.traced_slice`; appends its
    SpanSlice to `out` when the body ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        flag = torch.empty(1, dtype=torch.float64, device=device)
        marker = torch.ones(1, device=device)
        for _ in range(MARKER_KERNELS):
            marker.add_(1)
        torch.cuda.synchronize(device)
        flag.fill_(1.0)
        h0 = time.perf_counter()
        with spans_on():
            yield
        torch.cuda.synchronize(device)
        host_s = time.perf_counter() - h0
        flag.fill_(2.0)
        torch.cuda.synchronize(device)
    out.append(reduce_spans(prof.profiler.kineto_results.events(), host_s))


def _is_span(e) -> bool:
    """A user annotation: a span on the host, or its copy on the device's
    timeline that kineto adds."""
    f = getattr(e, "is_user_annotation", None)
    if f is not None:
        return bool(f())
    at = getattr(e, "activity_type", None)
    return at is not None and "user_annotation" in str(at())


def _thread(e) -> int:
    """The host thread an event ran on (kineto gives spans and runtime calls
    the system's thread id there)."""
    return e.device_resource_id()


def _open_at(spans, queries) -> Dict[int, tuple]:
    """For each query (time, key), the spans of one thread (start, end, name,
    ...) open at that time, outermost first: {key: (span, ...)}. The spans
    nest, as the ranges of one thread do."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out: Dict[int, tuple] = {}
    stack: list = []
    i = 0
    for t, key in sorted(queries):
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[key] = tuple(stack)
    return out


def reduce_spans(events, host_s: float) -> SpanSlice:
    """The kineto events of a spanned slice as a SpanSlice: the device
    intervals and the slice's bounds as `trace.reduce` reads them (the
    spans' copies on the device's timeline left out), each interval's
    chain of spans found through its runtime call."""
    events = list(events)
    spans, calls, corr = [], {}, {}
    for e in events:
        if _is_span(e):
            if "CUDA" not in str(e.device_type()):
                a = e.start_ns()
                spans.append((a, a + e.duration_ns(), e.name(), _thread(e)))
            continue
        kind = _kind(e)
        if kind in ("cuda_runtime", "cuda_driver"):
            calls[e.correlation_id()] = (e.start_ns(), _thread(e))
        elif kind in DEVICE_KINDS:
            a = e.start_ns()
            corr[(a, a + e.duration_ns(), e.name())] = e.correlation_id()
    rec = reduce([e for e in events if not _is_span(e)], host_s)
    queries: Dict[int, list] = {}
    for i, d in enumerate(rec.device):
        call = calls.get(corr.get(d))
        if call is not None:
            queries.setdefault(call[1], []).append((call[0], i))
    chains = [()] * len(rec.device)
    for thread, qs in queries.items():
        mine = [s for s in spans if s[3] == thread]
        for i, open_ in _open_at(mine, qs).items():
            chains[i] = tuple(s[2] for s in open_)
    return SpanSlice(rec, spans, chains)


def _clipped_s(d, window) -> float:
    return max(0, min(d[1], window[1]) - max(d[0], window[0])) * 1e-9


def _top(by: Dict[str, float], top: int) -> List[List]:
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def span_seconds(ss: SpanSlice) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Device seconds by span: (self, inclusive). Self: the intervals whose
    innermost span is that one (`UNSPANNED` for those under none);
    inclusive: those launched under that span or any span nested in it."""
    self_s: Dict[str, float] = {}
    incl: Dict[str, float] = {}
    for d, chain in zip(ss.slice.device, ss.chains):
        s = _clipped_s(d, ss.slice.window_ns)
        inner = chain[-1] if chain else UNSPANNED
        self_s[inner] = self_s.get(inner, 0.0) + s
        for name in set(chain) or (UNSPANNED,):
            incl[name] = incl.get(name, 0.0) + s
    return self_s, incl


def top_level_seconds(ss: SpanSlice) -> Dict[str, float]:
    """Device seconds by outermost span (`UNSPANNED` for none): these sum to
    the slice's device time."""
    by: Dict[str, float] = {}
    for d, chain in zip(ss.slice.device, ss.chains):
        name = chain[0] if chain else UNSPANNED
        by[name] = by.get(name, 0.0) + _clipped_s(d, ss.slice.window_ns)
    return by


def device_spans(ss: SpanSlice, top: int = 16) -> List[List]:
    """Device seconds by innermost span: [span, seconds], most first."""
    return _top(span_seconds(ss)[0], top)


def span_ops(ss: SpanSlice, top: int = 3) -> Dict[str, List[List]]:
    """Each innermost span's device seconds by kernel (or copy) name:
    {span: [[name, seconds], ...]}, most first."""
    by: Dict[str, Dict[str, float]] = {}
    for d, chain in zip(ss.slice.device, ss.chains):
        ops = by.setdefault(chain[-1] if chain else UNSPANNED, {})
        name = short(d[2], 60)
        ops[name] = ops.get(name, 0.0) + _clipped_s(d, ss.slice.window_ns)
    return {span: _top(ops, top) for span, ops in by.items()}


def _gaps(rec: SliceRecord):
    """The idle intervals between device intervals, as `trace.idle_gaps`
    finds them: (start, end, what the host did for most of it (the CUDA
    call it was in, else "python"), the operation the card woke for)."""
    lo, hi = rec.window_ns
    busy = sorted((a, b, n) for a, b, n in rec.device if b > lo and a < hi)
    runtime = sorted(rec.runtime)
    starts = [r[0] for r in runtime]
    cur = lo
    for a, b, name in busy + [(hi, hi, "slice end")]:
        if a > cur:
            j = bisect.bisect_left(starts, a) - 1
            host = "python"
            if j >= 0 and 2 * (min(runtime[j][1], a) - max(runtime[j][0], cur)) >= a - cur:
                host = runtime[j][2]
            yield cur, a, host, name
        cur = max(cur, b)


def idle_gaps_by_span(ss: SpanSlice, top: int = 10) -> List[List]:
    """The idle gaps of `trace.idle_gaps`, each named first by the innermost
    span open on the host for most of it (`HARNESS` where no span was):
    [label, seconds], longest first."""
    gaps = list(_gaps(ss.slice))
    best: List[Optional[tuple]] = [None] * len(gaps)  # innermost span over most of it
    # a span covering most of a gap holds its middle
    mids = [((a + b) // 2, i) for i, (a, b, _, _) in enumerate(gaps)]
    for thread in {s[3] for s in ss.spans}:
        for i, open_ in _open_at([s for s in ss.spans if s[3] == thread], mids).items():
            a, b = gaps[i][:2]
            for s in reversed(open_):
                if 2 * (min(s[1], b) - max(s[0], a)) >= b - a:
                    if best[i] is None or s[0] > best[i][0]:
                        best[i] = s
                    break
    where = [HARNESS if s is None else s[2] for s in best]
    by: Dict[str, float] = {}
    for (a, b, host, name), span in zip(gaps, where):
        label = f"{span}: {host} before {short(name)}"
        by[label] = by.get(label, 0.0) + (b - a) * 1e-9
    return _top(by, top)


def span_ms_per_window(ss: Optional[SpanSlice], windows: int, name: str,
                       inclusive: bool) -> Optional[float]:
    """The spanned slice's device time under span `name` over the windows
    it identified, in ms: inclusive or self (`span_seconds`). None without
    a spanned slice or where the span never opened."""
    if ss is None or windows <= 0 or name not in {s[2] for s in ss.spans}:
        return None
    self_s, incl = span_seconds(ss)
    return 1e3 * (incl if inclusive else self_s).get(name, 0.0) / windows


def unspanned_pct(ss: Optional[SpanSlice]) -> Optional[float]:
    """The spanned slice's device time launched under no span over its busy
    time, in %."""
    if ss is None or ss.slice.busy_s <= 0:
        return None
    return 100.0 * span_seconds(ss)[0].get(UNSPANNED, 0.0) / ss.slice.busy_s


def readings(ss: Optional[SpanSlice], windows: int) -> Dict[str, float]:
    """The numbers of `SPAN_METRICS` and `langid.unspanned_share` that the
    spanned slice holds, by name; none without one."""
    out = {}
    for name, (span, inclusive) in SPAN_METRICS.items():
        value = span_ms_per_window(ss, windows, span, inclusive)
        if value is not None:
            out[name] = value
    share = unspanned_pct(ss)
    if share is not None:
        out["langid.unspanned_share"] = share
    return out
