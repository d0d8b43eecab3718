"""A traced run's record that also carries a spanned slice: the plain
traced slice (`trace.traced_slice`) and its program counters as `Record`
has them, then a spanned slice (`spans.spanned_slice`) taken over the
calls that follow it, with the counters read around that slice too.

Readers of span metrics read `spans`, `span_counters` and `span_decode`;
the others read the plain slice as before, so the spans' cost (the CPU
activity recorded, the ranges) stays out of every timing taken from it."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .readers import Record
from .spans import SpanSlice


@dataclass
class SpannedRecord(Record):
    spans: Optional[SpanSlice] = None  # None where the program has no spans
    span_counters: Dict[str, float] = field(default_factory=dict)  # over the spanned slice
    span_decode: Dict[str, Any] = field(default_factory=dict)  # its work, as `decode` is
    span_windows: int = 0  # windows the harness handed the spanned slice
