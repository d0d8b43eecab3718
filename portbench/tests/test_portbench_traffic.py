"""The traffic kinds' arithmetic: draws shared by every seed, calls cut
at window boundaries, windows that close at a call boundary, and the p95
over every request with the failed ones above every answer."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import openai_whisper_coreml_tpu_torch.serve as serve
from portbench.lib import cell as cellmod
from portbench.traffic import batch_queue, http_open_loop


def test_every_seed_draws_the_same_sizes_and_gaps():
    a = cellmod.stratified_lognormal(64, 240, 0.75, 60, 1200, cellmod.rng(1, 1))
    b = cellmod.stratified_lognormal(64, 240, 0.75, 60, 1200, cellmod.rng(2**33 + 5, 1))
    assert not np.array_equal(a, b) and np.array_equal(np.sort(a), np.sort(b))
    assert a.min() >= 60 and a.max() <= 1200
    g = cellmod.stratified_gaps(100, 20.0, cellmod.rng(3, 3))
    assert g.sum() == pytest.approx(20.0) and g.min() > 0


def test_calls_hold_exactly_their_windows_and_cut_at_window_boundaries():
    calls = batch_queue.plan_calls([95.0, 20.0, 400.0, 61.0], windows_per_call=8, n_calls=2)
    for call in calls:
        assert sum(-(-n // 480_000) for _, _, n in call) == 8
        assert all(start % 480_000 == 0 for _, start, _ in call)
    # the 400 s recording (14 windows) opens in call 1 and goes on in call 2
    assert calls[0][-1][0] == 2 and calls[1][0][0] == 2 and calls[1][0][1] > 0
    with pytest.raises(ValueError):
        batch_queue.plan_calls([30.0], windows_per_call=8, n_calls=1)


def test_p95_counts_failures_above_every_answer():
    lat = [0.1 * i for i in range(1, 20)] + [60.0]  # 19 answers, one failure
    assert http_open_loop.p95_nearest_rank(lat) == pytest.approx(1.9)
    lat2 = lat[:-2] + [60.0, 61.0]
    assert http_open_loop.p95_nearest_rank(lat2) == 60.0


def test_window_closes_at_a_call_boundary(monkeypatch):
    def fake(model, pieces, options):
        time.sleep(0.05)
        return [{"text": "", "segments": []} for _ in pieces]

    monkeypatch.setattr(serve, "transcribe_batch", fake)
    ctx = cellmod.Ctx(cell={"name": "t", "params": {"windows_per_call": 2}}, config={},
                      dims={"n_text_layer": 1}, cfg=None, seed=1, seconds=0.12, trace=False,
                      device=torch.device("cpu"))
    pool = [[np.zeros(480_000, np.float32)] * 2]
    out = batch_queue.window(ctx, {"pool": pool, "options": serve.ServeOptions(batch_size=2)})
    assert out.attempted == 6  # three calls: the third ends past 0.12 s
    rtfx = out.e2e["rtfx"]
    assert 180 / 0.2 < rtfx < 180 / 0.15
