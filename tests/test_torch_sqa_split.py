"""The column split of the decode kernels K3 (`ops/sqa_self.py`) and K6
(`ops/sqa_int8.py`) on the CPU.

The kernels split each row's columns across a thread-block cluster and
combine the CTAs' shares in two exchanges over distributed shared memory;
the card runs them (tests/test_torch_kernels_cuda.py). Here:
  - the split rule and the slices (`split_count`, `slice_bounds`, mirrored
    by csrc/sqa.cu): every column of [lo, hi] lies in exactly one slice,
    the slices are contiguous runs of whole vectors that fit the kernel's
    shared memory, and the split count stays within the cluster limit;
  - an emulation of the two exchanges, written here in PyTorch (a (max,
    sum) pair per slice, where the kernel forms one per warp and folds them
    by the same rule; the row's max and sum from the pairs; weights
    normalised by them; P.V per slice, added in rank order), held against
    the port's plain versions and against JAX's Pallas kernels in interpret
    mode, with empty slices and rows with no column in bounds.

K6's emulation is held to 1e-5 of both, as tests/test_torch_sqa.py holds
the plain version to JAX. K3 rounds each normalised probability to bf16
before P.V: a sum taken in another order can move a probability across a
bf16 rounding boundary, one bf16 ulp (2^-8 of it), so K3's emulation is
held to the bf16 tolerance that file uses for bf16 outputs (1e-2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu.ops.sqa_int8 import quantize_kv_column as jax_qkv
from openai_whisper_coreml_tpu.ops.sqa_int8 import sqa_int8 as jax_sqa_int8
from openai_whisper_coreml_tpu.ops.sqa_self import sqa_self as jax_sqa_self
from openai_whisper_coreml_tpu_torch.ops import sqa_int8 as si
from openai_whisper_coreml_tpu_torch.ops import sqa_self as ss

torch.set_num_threads(1)

FP32_ABS = 1e-5
BF16_ABS, BF16_MEAN = 1e-2, 1e-3


def _bf16_close(ours, ref):
    err = (ours.float() - ref.float()).abs()
    assert err.max().item() <= BF16_ABS and err.mean().item() <= BF16_MEAN


def _cap(cols, vec_cols, splits):
    """The most columns a slice can have: the kernel's shared-memory size."""
    return -(-(-(-cols // vec_cols)) // splits) * vec_cols


def _check_partition(lo, hi, cols, vec_cols, splits):
    """The slices of [lo, hi]: contiguous runs of whole vectors in rank
    order, so each column of [lo, hi] lies in exactly one; none longer than
    the kernel's shared memory holds; lengths within a vector; a non-empty
    slice holds a column in bounds, and no slice starts past the row."""
    slices = si.slice_bounds(lo, hi, vec_cols, splits)
    assert len(slices) == splits
    assert slices[0][0] <= lo < slices[0][0] + vec_cols and hi < slices[-1][1]
    assert slices[-1][1] <= -(-(hi + 1) // vec_cols) * vec_cols
    for (_, a1), (b0, _) in zip(slices, slices[1:]):
        assert a1 == b0
    covered = 0
    for c0, c1 in slices:
        assert c0 % vec_cols == 0 and c1 % vec_cols == 0 and c0 <= c1
        assert c1 - c0 <= _cap(cols, vec_cols, splits)
        inside = max(0, min(c1 - 1, hi) - max(c0, lo) + 1)
        assert (c1 == c0) == (inside == 0)
        covered += inside
    assert covered == hi - lo + 1
    lengths = [c1 - c0 for c0, c1 in slices]
    assert max(lengths) - min(lengths) <= vec_cols


@pytest.mark.parametrize("rows", [20, 80, 160, 480])
def test_split_rule_stays_within_the_cluster_and_covers_every_column(rows):
    """At every column count the kernels take: the rule's count is 1..16
    and its slices partition the whole row, for 4-byte (int8 4, bf16 2
    columns) and 16-byte vectors (int8 16, bf16 8)."""
    for cols in range(1, si.MAX_COLS + 1):
        splits = si.split_count(cols, rows)
        assert 1 <= splits <= si.MAX_SPLITS
        assert -(-cols // splits) <= max(si.MAX_SLICE_COLS, -(-cols // si.MAX_SPLITS))
        for vec_cols in (2, 4, 8, 16):
            _check_partition(0, cols - 1, cols, vec_cols, splits)


@pytest.mark.parametrize("vec_cols", [2, 4, 8, 16])
def test_slices_partition_random_per_row_bounds(vec_cols):
    rng = np.random.default_rng(vec_cols)
    for _ in range(400):
        cols = int(rng.integers(1, si.MAX_COLS + 1))
        lo = int(rng.integers(0, cols))
        hi = int(rng.integers(lo, cols))
        for splits in (1, 2, 3, 4, 8, 16, si.split_count(cols, int(rng.integers(1, 500)))):
            _check_partition(lo, hi, cols, vec_cols, splits)


def test_split_rule_at_the_model_shapes():
    """The counts the sweep chose at the decode step's shapes (PERF.md)."""
    assert si.split_count(1500, 4 * 20) == 4  # large-v3 B=4 cross K/V
    assert si.split_count(1500, 8 * 20) == 4  # continuous beam 2 at B=4
    assert si.split_count(256, 4 * 20) == 4  # B=4 cache of a 224-token window
    assert si.split_count(448, 8 * 20) == 2
    assert si.split_count(448, 1 * 20) == 8  # the streaming path's one row


def _bounds(lo, hi, cols):
    """The kernel's bounds: pos clamped to the last column; a row with no
    column in bounds takes every column with the mask value."""
    lo, hi = max(lo, 0), min(hi, cols - 1)
    return (0, cols - 1, True) if lo > hi else (lo, hi, False)


def emulate(kernel, q, k, v, k_scale, v_scale, pos, valid_from, splits, vec_cols):
    """The kernels' split and two exchanges in PyTorch (fp32), (B,H,D)."""
    b_, h_, d_, cols = k.shape
    pos = torch.as_tensor(pos).expand(b_)
    valid_from = torch.as_tensor(valid_from).expand(b_)
    out = torch.zeros(b_, h_, d_)
    for b in range(b_):
        lo, hi, none = _bounds(int(valid_from[b]), int(pos[b]), cols)
        slices = si.slice_bounds(lo, hi, vec_cols, splits)
        for h in range(h_):
            if kernel == "sqa_self":
                qb = q[b, h].to(torch.bfloat16).float()
                kb, vb = (x[b, h].to(torch.bfloat16).float() for x in (k, v))
            else:
                qb, kb, vb = q[b, h].float(), k[b, h].float(), v[b, h].float()
            logits, pairs = [], []
            for c0, c1 in slices:
                first = max(c0, lo)
                inside = torch.arange(first, max(first, min(c1 - 1, hi) + 1))
                if none:
                    s = torch.full((len(inside),), si.MASK_VALUE)
                else:
                    s = qb @ kb[:, inside]
                    if kernel == "sqa_int8":
                        s = s * k_scale[b, h, 0, inside]
                    s = s * d_ ** -0.5
                logits.append((inside, s))
                if len(inside):  # an empty slice's pair is (-inf, 0)
                    m_i = s.max()
                    pairs.append((m_i, torch.exp(s - m_i).sum()))
                else:
                    pairs.append((torch.tensor(-torch.inf), torch.tensor(0.0)))
            # exchange one: the row's max and sum from every CTA's pair
            m = max(m_i for m_i, _ in pairs)
            l = sum(l_i * torch.exp(m_i - m) for m_i, l_i in pairs if l_i > 0)
            # exchange two: P.V per slice, added in rank order
            acc = torch.zeros(d_)
            for inside, s in logits:
                p = torch.exp(s - m) / l
                if kernel == "sqa_self":
                    w = p.to(torch.bfloat16).float()
                else:
                    w = p * v_scale[b, h, 0, inside]
                acc = acc + vb[:, inside] @ w
            out[b, h] = acc
    return out


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# (pos, valid_from) per row: the whole row; pos inside the first slice
# (every other CTA empty); valid_from inside a late slice; pos past the last
# column; no column in bounds (valid_from > pos: uniform weights)
ROWS = [(None, 0), (2, 0), (None, -10), (10 ** 6, 1), (5, 9)]


def _row_bounds(cols):
    pos = [cols - 1 if p is None else p for p, _ in ROWS]
    vf = [cols + f if f < 0 else f for _, f in ROWS]
    return np.asarray(pos, np.int32), np.asarray(vf, np.int32)


@pytest.mark.parametrize("splits,vec_cols", [(1, 4), (2, 4), (4, 4), (8, 4), (16, 4),
                                             (3, 16), (8, 16)])
def test_emulated_exchanges_match_the_plain_version_and_jax_int8(splits, vec_cols):
    """K6: the split and two exchanges give the plain version's output and
    JAX's kernel's (interpret mode) within 1e-5, on each row's bounds."""
    rng = np.random.default_rng(splits * vec_cols)
    cols = 160
    q = _normal(rng, len(ROWS), 2, 64)
    k8, ks = (np.asarray(a) for a in jax_qkv(jnp.asarray(_normal(rng, len(ROWS), 2, 64, cols))))
    v8, vs = (np.asarray(a) for a in jax_qkv(jnp.asarray(_normal(rng, len(ROWS), 2, 64, cols))))
    pos, vf = _row_bounds(cols)
    ours = emulate("sqa_int8", _t(q), _t(k8), _t(v8), _t(ks), _t(vs), _t(pos), _t(vf),
                   splits, vec_cols)
    plain = si.sqa_int8_reference(_t(q), _t(k8), _t(ks), _t(v8), _t(vs), _t(pos), _t(vf))
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), atol=FP32_ABS)
    for i in range(len(ROWS)):
        row = jax_sqa_int8(*(jnp.asarray(x[i:i + 1]) for x in (q, k8, ks, v8, vs)),
                           jnp.int32(pos[i]), jnp.int32(vf[i]))
        np.testing.assert_allclose(ours[i:i + 1].numpy(), np.asarray(row), atol=FP32_ABS)


@pytest.mark.parametrize("splits,vec_cols", [(1, 2), (2, 2), (4, 2), (8, 2), (16, 2),
                                             (4, 8)])
def test_emulated_exchanges_match_the_plain_version_and_jax_self(splits, vec_cols):
    """K3: the same within bf16's tolerances (max 1e-2, mean 1e-3): the
    one-ulp flips of the bf16 probabilities."""
    rng = np.random.default_rng(100 + splits * vec_cols)
    cols = 96
    q, k, v = (_normal(rng, len(ROWS), 2, 64, *extra) for extra in ((), (cols,), (cols,)))
    pos, vf = _row_bounds(cols)
    ours = emulate("sqa_self", _t(q), _t(k), _t(v), None, None, _t(pos), _t(vf), splits,
                   vec_cols)
    plain = ss.sqa_self_reference(_t(q), _t(k), _t(v), _t(pos), _t(vf))
    _bf16_close(ours, plain)
    for i in range(len(ROWS)):
        row = jax_sqa_self(*(jnp.asarray(x[i:i + 1]) for x in (q, k, v)), jnp.int32(pos[i]),
                           jnp.int32(vf[i]))
        _bf16_close(ours[i:i + 1], _t(row))


def test_a_row_with_no_column_in_bounds_weighs_every_column_alike():
    """valid_from > pos: every slice's pair is (mask value, its columns), so
    the row's weights are bf16(1/C) over all columns, as in the plain
    versions."""
    rng = np.random.default_rng(7)
    cols = 40
    q, k, v = (_t(_normal(rng, 1, 2, 64, *extra)) for extra in ((), (cols,), (cols,)))
    ours = emulate("sqa_self", q, k, v, None, None, 3, 9, 4, 2)
    w = torch.tensor(1 / cols).to(torch.bfloat16).float()
    mean = v.to(torch.bfloat16).float().sum(dim=-1) * w
    np.testing.assert_allclose(ours.numpy(), mean.numpy(), atol=1e-5)
    np.testing.assert_allclose(ss.sqa_self_reference(q, k, v, 3, 9).numpy(), mean.numpy(),
                               atol=1e-5)
