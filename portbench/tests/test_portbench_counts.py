"""`metrics/counts.py` against counts made by hand at a tiny size, and the
readers' arithmetic on synthetic slices."""

from __future__ import annotations

import pytest

from portbench.lib.readers import Record, mfu_pct, roofline_pct, K1, K6
from portbench.lib.trace import Kernel, SliceRecord
from portbench.metrics import counts

D = {"n_mels": 4, "n_vocab": 10, "n_audio_ctx": 6, "n_audio_state": 8, "n_audio_head": 2,
     "n_audio_layer": 2, "n_text_ctx": 16, "n_text_state": 8, "n_text_head": 2,
     "n_text_layer": 3, "n_ffn": 32, "n_langs": 1}


def test_encoder_flops_by_hand():
    stem = 2 * 12 * 3 * 4 * 8 + 2 * 6 * 3 * 8 * 8  # conv1 over 12 frames, conv2 over 6
    proj = 2 * 6 * 8 * 8 * 4  # q, k, v, out
    attn = 2 * 6 * 6 * 8 * 2  # QK^T and PV
    mlp = 2 * 6 * 8 * 32 * 2
    assert counts.encoder_flops(D) == stem + 2 * (proj + attn + mlp)


def test_decoder_token_flops_by_hand():
    per_layer = 2 * 8 * 8 * 6 + 2 * 5 * 8 * 2 + 2 * 6 * 8 * 2 + 2 * 8 * 32 * 2
    assert counts.decoder_token_flops(D, context=5) == 3 * per_layer + 2 * 8 * 10
    assert counts.cross_kv_flops(D) == 3 * 2 * 6 * 8 * 8 * 2


def test_kernel_counts_by_hand():
    k1 = counts.k1(batch=2, heads=3, t=5, head_dim=4)
    assert k1["ops"] == 2 * 2 * 2 * 3 * 5 * 5 * 4
    assert k1["bytes"] == 4 * 2 * 5 * 3 * 4 * 2
    k6 = counts.k6(batch=2, heads=3, cols=7, head_dim=4)
    assert k6["ops"] == 4 * 2 * 3 * 7 * 4
    assert k6["bytes"] == 2 * 2 * 3 * 4 * 7 + 2 * 2 * 3 * 7 * 4 + 2 * 2 * 3 * 4 * 2
    assert k6["bound_s"] == pytest.approx(k6["bytes"] / counts.HBM_BYTES_S)
    assert counts.bound_s(0, 989e12, "bf16") == pytest.approx(1.0)


def _kernel(name, t0, ns, grid):
    return Kernel(name, t0, t0 + ns, grid)


def test_roofline_is_bound_over_time():
    k6 = "void sqa_kernel<Int8KV, __nv_bfloat16, __nv_bfloat16>(x)"
    ks = [_kernel(k6, 0, 1000, (8, 2, 4)), _kernel(k6, 2000, 3000, (8, 2, 4)),
          _kernel("void other()", 0, 500, (1, 1, 1))]
    rec = Record(D, SliceRecord((0, 10_000), kernels=ks))
    cost = counts.k6(4, 2, 6, 4)["bound_s"]
    got = roofline_pct(rec, K6, lambda k: counts.k6(k.grid[2], k.grid[1], 6, 4)["bound_s"])
    assert got == pytest.approx(100 * 2 * cost / 4000e-9)
    assert roofline_pct(rec, K1, lambda k: 1.0) is None


def test_mfu_counts_the_slice_work():
    k1 = "void fa_fwd_bf16_kernel<false>(x)"
    k3 = "void sqa_kernel<Bf16KV, __nv_bfloat16, __nv_bfloat16>(x)"
    ks = [_kernel(k1, 0, 10, (1, 2, 4)) for _ in range(2)]  # 4 windows, 2 layers
    ks += [_kernel(k3, 0, 10, (1, 2, 4)) for _ in range(3 * 5)]  # 5 steps of 4 rows
    rec = Record(D, SliceRecord((0, 10**9), kernels=ks), decode={"prompt_len": 4,
                                                                "sample_len": 5})
    flops = counts.model_flops(D, 4, 4, 20 + 16, 4 + 2.5 + 0.5)
    assert mfu_pct(rec) == pytest.approx(100 * flops / 989e12)
    assert mfu_pct(Record(D, None)) is None
