"""Serving observability: structured logging and a process-local metrics
registry (port of `utils/obs.py`).

Standard `logging` with key=value structured lines for the serving stack,
and thread-safe counters, gauges and latency reservoirs that
`serve_http`'s /metrics endpoint reports as JSON or in Prometheus text
form. Stdlib only. The logger namespace `whisper_tpu`, its
$WHISPER_TPU_LOG_LEVEL variable and the metric prefix are the JAX
package's names, kept so that one dashboard or scraper reads both servers
alike; they say nothing about the device.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

_LOG_FORMAT = ("%(asctime)s %(levelname)s %(name)s %(message)s")
_configured = False
_configure_lock = threading.Lock()


def get_logger(name: str) -> logging.Logger:
    """Namespaced logger (`whisper_tpu.<name>`), configured once per process.

    Level comes from $WHISPER_TPU_LOG_LEVEL (default INFO; set WARNING to
    quiet the serving logs, DEBUG for per-batch scheduler detail).
    """
    global _configured
    root = logging.getLogger("whisper_tpu")
    with _configure_lock:
        if not _configured:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter(_LOG_FORMAT))
            root.addHandler(handler)
            root.propagate = False
            root.setLevel(os.environ.get("WHISPER_TPU_LOG_LEVEL", "INFO"))
            _configured = True
    return root.getChild(name)


def kv(**fields) -> str:
    """Render fields as a stable key=value suffix for structured lines."""
    return " ".join(f"{k}={v}" for k, v in fields.items())


class _Reservoir:
    """Fixed-size sliding window of float observations (latency quantiles)."""

    def __init__(self, size: int = 512):
        self._vals: List[float] = []
        self._size = size

    def add(self, v: float) -> None:
        self._vals.append(v)
        if len(self._vals) > self._size:
            del self._vals[: len(self._vals) - self._size]

    def quantile(self, q: float) -> Optional[float]:
        if not self._vals:
            return None
        s = sorted(self._vals)
        idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
        return s[idx]

    @property
    def count(self) -> int:
        return len(self._vals)


class Metrics:
    """Thread-safe counters/gauges/latency summaries for one serving process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._reservoirs: Dict[str, _Reservoir] = {}
        self._started = time.time()

    def inc(self, name: str, by: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + by

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._reservoirs.setdefault(name, _Reservoir()).add(value)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def snapshot(self) -> Dict[str, object]:
        """JSON-ready dump: counters, gauges, and p50/p95 per summary."""
        with self._lock:
            out: Dict[str, object] = {
                "uptime_s": round(time.time() - self._started, 3),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "summaries": {
                    name: {
                        "count": r.count,
                        "p50": r.quantile(0.50),
                        "p95": r.quantile(0.95),
                    }
                    for name, r in self._reservoirs.items()
                },
            }
        return out

    def prometheus(self, prefix: str = "whisper_tpu") -> str:
        """Prometheus text exposition format (one scrape target per server;
        quantiles exported as {quantile=...} summary series)."""
        snap = self.snapshot()
        lines = []

        def emit(name, value, labels=""):
            lines.append(f"{prefix}_{name}{labels} {value}")

        emit("uptime_seconds", snap["uptime_s"])
        for name, v in sorted(snap["counters"].items()):
            # counters may already carry a _total suffix (requests_total);
            # normalise so every series ends in exactly one _total
            base = name[: -len("_total")] if name.endswith("_total") else name
            lines.append(f"# TYPE {prefix}_{base}_total counter")
            emit(f"{base}_total", v)
        for name, v in sorted(snap["gauges"].items()):
            lines.append(f"# TYPE {prefix}_{name} gauge")
            emit(name, v)
        for name, s in sorted(snap["summaries"].items()):
            lines.append(f"# TYPE {prefix}_{name} summary")
            emit(f"{name}_count", s["count"])
            for q in (0.50, 0.95):
                emit(name, s[f"p{int(q * 100)}"],
                     labels=f'{{quantile="{q}"}}')
        return "\n".join(lines) + "\n"
