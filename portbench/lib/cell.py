"""The interface between `run.py` and a traffic kind (`traffic/<kind>.py`).

A kind module has two functions:

    setup(ctx) -> state      make the inputs from the seed and warm up the
                             shapes the window will use (counted in setup_s)
    window(ctx, state) -> Outcome
                             drive the entry for `ctx.seconds`, trace a
                             slice when `ctx.trace`, and hand back what the
                             program served

Inputs are drawn so that every seed gets the same sizes and gaps in
another order (`stratified`): the seed changes which recording comes when,
not how much work a run holds."""

from __future__ import annotations

import math
import statistics
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .readers import Record


@dataclass
class Ctx:
    cell: Dict[str, Any]  # workloads/<cell>.json
    config: Dict[str, Any]  # configs/<config>.json
    dims: Dict[str, int]
    cfg: Any  # the program's configuration object, whatever its family
    seed: int
    seconds: float
    trace: bool
    device: Any
    model: Any = None

    @property
    def params(self) -> Dict[str, Any]:
        return self.cell["params"]

    def log(self, *args) -> None:
        print(f"[{self.cell['name']}]", *args, file=sys.stderr, flush=True)


@dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: Dict[str, float]  # end-to-end metrics by name
    answers: List[dict]  # what the program served, for the judge
    kind: str  # what the family's judge reads: "transcripts", "languages", "windows", ...
    record: Optional[Record] = None  # for the per-layer readers (traced runs)
    close: Callable[[], None] = lambda: None  # frees what the program holds
    extra: Dict[str, Any] = field(default_factory=dict)  # the kind's own readings


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, stream])


def stratified_lognormal(n: int, median: float, sigma: float, lo: float, hi: float,
                         gen: np.random.Generator) -> np.ndarray:
    """n values at the n middle quantiles of a log-normal (clipped to
    [lo, hi]), in an order drawn from `gen`."""
    z = [statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    vals = np.clip(median * np.exp(sigma * np.asarray(z)), lo, hi)
    return vals[gen.permutation(n)]


def stratified_gaps(n: int, total: float, gen: np.random.Generator) -> np.ndarray:
    """n exponential inter-arrival gaps at the n middle quantiles, scaled
    to sum to `total`, in an order drawn from `gen`: Poisson arrivals whose
    count and mean rate every seed shares."""
    gaps = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    gaps *= total / gaps.sum()
    return gaps[gen.permutation(n)]
