"""The trace reduction: the idle share from synthetic device intervals,
the slice bounds from the marker fills, launches, grids and gaps."""

from __future__ import annotations

import pytest

from portbench.lib import trace
from portbench.lib.readers import Record, idle_pct


class Ev:
    def __init__(self, kind, name, start, dur, meta=""):
        self.kind, self.n, self.s, self.d, self.meta = kind, name, start, dur, meta

    def activity_type(self):
        return self.kind

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def metadata_json(self):
        return self.meta


def test_union_of_overlapping_intervals():
    assert trace.union_ns([(0, 10), (5, 15), (20, 30)], (0, 100)) == 25
    assert trace.union_ns([(0, 10), (5, 15), (20, 30)], (8, 25)) == 12
    assert trace.union_ns([], (0, 10)) == 0


def test_idle_share_from_synthetic_intervals():
    rec = trace.SliceRecord((100, 1100), device=[(100, 300, "a"), (250, 400, "b"),
                                                 (900, 1000, "c")])
    assert rec.busy_s == pytest.approx(400e-9)
    assert idle_pct(Record({}, rec)) == pytest.approx(60.0)
    assert idle_pct(Record({}, None)) is None


def test_reduce_bounds_launches_and_grids():
    fill = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<double>>()"
    events = [
        Ev("kernel", "marker", 0, 5),
        Ev("kernel", fill, 100, 10),  # the slice opens at 110
        Ev("cuda_runtime", "cudaLaunchKernel", 120, 5),
        Ev("kernel", "void fa_fwd_bf16_kernel<false>(x)", 130, 20,
           '"grid": [12, 20, 64], "block": [384, 1, 1]'),
        Ev("cuda_runtime", "cudaLaunchKernelExC", 160, 5),
        Ev("cuda_runtime", "cudaStreamSynchronize", 170, 100),
        Ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 200, 10),
        Ev("kernel", fill, 300, 10),  # the slice closes at 300
        Ev("kernel", "late", 400, 10),
    ]
    rec = trace.reduce(events, host_s=0.0)
    assert rec.window_ns == (110, 300)
    assert rec.launches == 2
    assert [k.grid for k in rec.kernels] == [(12, 20, 64)]
    assert rec.busy_s == pytest.approx(30e-9)
    gaps = dict(map(tuple, trace.idle_gaps(rec)))
    assert sum(gaps.values()) == pytest.approx(160e-9)
    # the host sat in the synchronise for most of the last gap (170-270 of
    # 210-300), and ran Python through the gap before the kernel
    assert gaps["cudaStreamSynchronize before slice end"] == pytest.approx(90e-9)
    assert gaps["python before void fa_fwd_bf16_kernel<false>"] == pytest.approx(20e-9)
    ops = dict(map(tuple, trace.device_ops(rec)))
    assert ops["void fa_fwd_bf16_kernel<false>"] == pytest.approx(20e-9)


def test_reduce_refuses_a_slice_without_its_markers():
    with pytest.raises(RuntimeError):
        trace.reduce([Ev("kernel", "x", 0, 1)], host_s=0.0)
