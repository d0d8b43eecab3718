"""`metrics/linear_roofline.langid.py` on synthetic slices: the share
reckoned by hand, None without the kernel, and no more than 100 % when the
kernels take exactly the card's peak."""

from __future__ import annotations

import pytest

from portbench import families
from portbench.lib import spec
from portbench.lib.readers import Record, load_reader
from portbench.lib.trace import Kernel, SliceRecord

CONFIG = spec.config_file("large-v3")
D = families.of(CONFIG).dims(CONFIG)
K1 = "void fa_fwd_bf16_kernel<false>(CUtensorMap_st, CUtensorMap_st)"
FUSED = ("void (anonymous namespace)::fused_linear_kernel(CUtensorMap_st, CUtensorMap_st, "
         "CUtensorMap_st, float const*, float const*, int, int, int)")
READ = load_reader("linear_roofline.langid")


def _slice(windows: int, fused_ns):
    # one K1 launch a layer over every window: grid (tiles, heads, windows)
    ks = [Kernel(K1, 0, 10, (8, 20, windows)) for _ in range(D["n_audio_layer"])]
    ks += [Kernel(FUSED, 100 * i, 100 * i + ns, (132, 1, 1)) for i, ns in enumerate(fused_ns)]
    return Record(D, SliceRecord((0, 10**12), kernels=ks))


def _window_flops():
    n, t, f = 1280, 1500, 5120
    encoder = 32 * (2 * t * n * n * 4 + 2 * t * n * f * 2)
    cross = 32 * 2 * (2 * t * n * n)
    return encoder + cross


def test_large_v3_window_is_2_2_tflop():
    assert _window_flops() == pytest.approx(2.20e12, rel=0.01)


def test_reading_is_the_hand_reckoned_share():
    # 192 windows, 256 launches a call of 64: 768 launches of 5 us each
    rec = _slice(192, [5_000] * 768)
    want = 100 * 192 * _window_flops() / 989e12 / (768 * 5_000e-9)
    assert READ(rec) == pytest.approx(want)


def test_reading_is_none_without_the_kernel():
    assert READ(_slice(192, [])) is None
    assert READ(Record(D, None)) is None
    # the kernel without K1's windows: no work to read
    rec = _slice(192, [5_000])
    rec.slice.kernels = [k for k in rec.slice.kernels if "fused" in k.name]
    assert READ(rec) is None


def test_reading_stays_within_100_at_the_peak():
    peak_ns = 192 * _window_flops() / 989e12 * 1e9
    rec = _slice(192, [peak_ns / 4] * 4)
    assert READ(rec) == pytest.approx(100.0)
    assert READ(_slice(192, [peak_ns / 4 * 1.01] * 4)) < 100.0
