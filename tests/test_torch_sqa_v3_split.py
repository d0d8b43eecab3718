"""The column split of K2 (`ops/sqa_v3.py`, int8 x int8 cross-attention
decode) on the CPU.

K2 is K6's kernel body in a mode of its own (`csrc/sqa.cu`): each row's
columns split across a thread-block cluster, the CTAs' shares combined
over distributed shared memory; the card runs it
(tests/test_torch_kernels_cuda.py). `emulate` below writes its slices and
exchanges in PyTorch:
  - every CTA quantises the same query to the same q8 and row scale;
  - each slice's logits and its (max, sum) pair; the row's max m and sum l
    from the pairs (exchange one);
  - int8 A.V: each slice's weights pv = exp(s - m) * v_scale and its
    largest weight; the row's wmax as their max (the one-float exchange);
    the codes w8 = clip(rint(pv * (127 / wmax))); each slice's int32 A.V
    64-vector, summed across slices as integers (exchange two);
  - bf16 A.V: each slice's fp32 sum of bf16(pv) * v8, added in rank order.
Held against the plain version `sqa_cross_int8_reference` (the codes, the
row's wmax and the integer sums bit-equal to the ones its unsplit math
gives; its output through them bit-equal too) and against JAX's Pallas
kernel in interpret mode at `tests/test_torch_sqa_v3.py`'s tolerance
(1e-4), at split counts 1..8 and 16, B=24, s_len < S and 12288 columns."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu.ops import sqa_v3 as jsv3
from openai_whisper_coreml_tpu.ops.sqa_int8 import quantize_kv_column as jax_quantize
from openai_whisper_coreml_tpu_torch.ops import sqa_int8 as si
from openai_whisper_coreml_tpu_torch.ops import sqa_v3 as sv
from openai_whisper_coreml_tpu_torch.quantize import ieee_div

torch.set_num_threads(1)

JAX_ABS = 1e-4


def emulate(q, k8, k_scale, v8, v_scale, s_len, splits, vec_cols, av_int8=True):
    """The kernel's slices and exchanges in PyTorch: (out (B, H, D) fp32,
    per (b, h): the codes (S,) with 0 past s_len, the row's wmax and the
    int32 A.V sum (D,), int8 A.V only)."""
    b_, h_, d_, cols = k8.shape
    q8, qs = sv.quantize_q_rows(q)
    out = torch.zeros(b_, h_, d_)
    codes = torch.zeros(b_, h_, cols, dtype=torch.int32)
    wmaxes = torch.zeros(b_, h_)
    sums = torch.zeros(b_, h_, d_, dtype=torch.int64)
    slices = si.slice_bounds(0, s_len - 1, vec_cols, splits)
    for b in range(b_):
        for h in range(h_):
            qb = q8[b, h].float()
            parts = []
            for c0, c1 in slices:
                inside = torch.arange(c0, min(c1, s_len))
                dot = qb @ k8[b, h][:, inside].float()  # exact: integers below 2^24
                s = dot * (k_scale[b, h, 0, inside] * qs[b, h, 0]) * d_ ** -0.5
                pair = ((s.max(), torch.exp(s - s.max()).sum()) if len(inside)
                        else (torch.tensor(-torch.inf), torch.tensor(0.0)))
                parts.append((inside, s, pair))
            # exchange one: the row's max and sum from the slices' pairs
            m = max(m_i for _, _, (m_i, _) in parts)
            l = sum(l_i * torch.exp(m_i - m) for _, _, (m_i, l_i) in parts if l_i > 0)
            pvs = [(inside, torch.exp(s - m) * v_scale[b, h, 0, inside])
                   for inside, s, _ in parts]
            if av_int8:
                # the one-float exchange: the row's largest weight
                wmax = max([pv.max() for _, pv in pvs if len(pv)] + [torch.tensor(1e-20)])
                r = ieee_div(torch.tensor(127.0), wmax)
                acc = torch.zeros(d_, dtype=torch.int64)
                for inside, pv in pvs:  # exchange two: int32 64-vectors, as integers
                    w8 = torch.clamp(torch.round(pv * r), -127, 127).long()
                    codes[b, h, inside] = w8.int()
                    part = v8[b, h][:, inside].long() @ w8
                    assert part.abs().max() < 2 ** 31  # an int32 in the kernel
                    acc += part
                sums[b, h], wmaxes[b, h] = acc, wmax
                out[b, h] = acc.float() * ieee_div(wmax, torch.tensor(127.0)) / l
            else:
                acc = torch.zeros(d_)
                for inside, pv in pvs:  # exchange two: fp32 64-vectors in rank order
                    acc = acc + v8[b, h][:, inside].float() @ pv.bfloat16().float()
                out[b, h] = acc / l
    return out.to(q.dtype), codes, wmaxes, sums


def plain_intermediates(q, k8, k_scale, v8, v_scale, s_len):
    """The codes, wmax, int8 A.V sums and softmax sum of the plain
    version's unsplit math (its own lines, kept apart here to read them)."""
    d, s = q.shape[-1], k8.shape[-1]
    q8, qs = sv.quantize_q_rows(q)
    dot = torch.einsum("bhd,bhds->bhs", q8.float(), k8.float())
    lg = dot * (k_scale[:, :, 0, :] * qs) * d ** -0.5
    lg = torch.where(torch.arange(s) < s_len, lg, si.MASK_VALUE)
    p = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    pv = p * v_scale[:, :, 0, :]
    wmax = pv.amax(dim=-1, keepdim=True).clamp(min=1e-20)
    w8 = torch.clamp(torch.round(pv * ieee_div(127.0, wmax)), -127, 127)
    acc = torch.einsum("bhs,bhds->bhd", w8.double(), v8.double())
    return w8.int(), wmax[..., 0], acc.long(), p.sum(dim=-1, keepdim=True)


def _data(b, h, s, seed, poison_from=None):
    """q (B, H, 64) fp32 and JAX-quantised int8 K/V with fp32 column scales
    (numpy); columns from `poison_from` on are 127 with 1e6 scales."""
    rng = np.random.default_rng(seed)
    k8, ks = (np.array(x) for x in jax_quantize(jnp.asarray(rng.standard_normal((b, h, 64, s)),
                                                            jnp.float32)))
    v8, vs = (np.array(x) for x in jax_quantize(jnp.asarray(rng.standard_normal((b, h, 64, s)),
                                                            jnp.float32)))
    if poison_from is not None:
        for x, val in ((k8, 127), (v8, 127), (ks, 1e6), (vs, 1e6)):
            x[..., poison_from:] = val
    q = rng.standard_normal((b, h, 64)).astype(np.float32)
    return q, k8, ks, v8, vs


def _check(data, s_len, splits, vec_cols):
    q, k8, ks, v8, vs = (torch.from_numpy(x) for x in data)
    plain_codes, plain_wmax, plain_sums, denom = plain_intermediates(q, k8, ks, v8, vs, s_len)
    for av_int8 in (True, False):
        out, codes, wmax, sums = emulate(q, k8, ks, v8, vs, s_len, splits, vec_cols, av_int8)
        plain = sv.sqa_cross_int8_reference(q, k8, ks, v8, vs, s_len=s_len, av_int8=av_int8)
        if av_int8:
            assert torch.equal(codes, plain_codes)
            assert torch.equal(wmax, plain_wmax) and torch.equal(sums, plain_sums)
            # the plain version's output from the emulated codes and sums
            through = sums.double().float() * ieee_div(wmax[..., None], 127.0) / denom
            assert torch.equal(through, plain)
        np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=JAX_ABS, rtol=0)
        ref = np.asarray(jsv3.sqa_cross_int8(*(jnp.asarray(x) for x in data), s_len=s_len,
                                             av_int8=av_int8, interpret=True))
        np.testing.assert_allclose(out.numpy(), ref, atol=JAX_ABS, rtol=0)


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5, 6, 7, 8, 16])
def test_emulated_exchanges_match_the_plain_version_and_jax(splits):
    """The probe's geometry cut to size: 1500 real columns of 1536, rows
    and slices on 16-byte vectors, the padding poisoned."""
    data = _data(2, 3, 1536, splits, poison_from=1500)
    _check(data, 1500, splits, 16)


@pytest.mark.parametrize("splits,vec_cols", [(4, 4), (8, 4), (16, 4)])
def test_emulated_exchanges_on_4_byte_vectors(splits, vec_cols):
    """Rows off 16-byte boundaries (S = 203) split on 4-column vectors,
    s_len < S."""
    data = _data(3, 2, 203, 20 + splits)
    _check(data, 199, splits, vec_cols)


def test_emulated_exchanges_at_the_probe_batch():
    """B=24 (the probe's batch) at the rule's split count."""
    splits = si.split_count(1536, 24 * 20)
    data = _data(24, 1, 1536, 5, poison_from=1500)
    _check(data, 1500, splits, 16)


def test_emulated_exchanges_at_the_column_limit():
    """12288 columns (K2's limit) at the rule's split count, 16, where the
    row's int8 A.V sum may pass 2^24 and only integers stay exact."""
    cols = sv.MAX_COLS
    splits = si.split_count(cols, 1 * 2)
    assert splits == si.MAX_SPLITS
    data = _data(1, 2, cols, 6)
    _check(data, cols, splits, 16)
    _check(data, cols - 37, splits, 16)


def test_the_row_wmax_is_the_max_of_weights_taken_with_the_row_max():
    """Each slice's weights use the row's max m, so the row's wmax is the
    plain version's bit for bit. With one column's V scale raised 50-fold
    the largest weight lies in another slice than the largest logit: a
    wmax folded from per-slice maxima (exp(m_i - m) * wmax_i) would round
    differently in some of the 24 rows."""
    q, k8, ks, v8, vs = _data(4, 6, 1536, 9, poison_from=1500)
    vs[..., 1400] *= 50
    _check((q, k8, ks, v8, vs), 1500, 4, 16)
