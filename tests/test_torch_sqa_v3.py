"""Port K2 (`ops/sqa_v3.py`, int8 x int8 cross-attention decode) against the
JAX package's, on the CPU, where the wrapper runs its plain version.

The same K/V and queries, made with numpy, go through JAX's
`sqa_cross_int8` (the Pallas kernel in interpret mode) and the port's
`sqa_cross_int8`; both A.V modes must agree within 1e-4, and both must
hold JAX's own tolerances against the inline-dequant oracle. Also: the
query's row quantisation equals JAX's, poisoned lane padding leaves the
output bit-identical, the int8 A.V sum is exact where float32 would round
it, and the kernel wrappers' launch counts add up across threads."""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu.ops import sqa_v3 as jsv3
from openai_whisper_coreml_tpu.ops.sqa_int8 import quantize_kv_column as jax_quantize
from openai_whisper_coreml_tpu_torch.ops import _build
from openai_whisper_coreml_tpu_torch.ops import sqa_v3 as tsv3

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    """JAX's test geometry (B, H, D, S) = (2, 8, 64, 256), quantised by JAX;
    numpy arrays."""
    rng = np.random.default_rng(0)
    b, h, d, s = 2, 8, 64, 256
    k8, ks = jax_quantize(jnp.asarray(rng.standard_normal((b, h, d, s)), jnp.float32))
    v8, vs = jax_quantize(jnp.asarray(rng.standard_normal((b, h, d, s)), jnp.float32))
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    return tuple(np.asarray(x) for x in (q, k8, ks, v8, vs))


def _torch(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def test_quantize_q_rows_equals_jax():
    rng = np.random.default_rng(1)
    # ties: 127 / max times multiples of 0.5 land halfway between integers
    q = np.concatenate([rng.standard_normal((3, 4, 64)) * 5,
                        np.tile(np.arange(-32, 32)[None, None] * 0.5, (1, 4, 1))]
                       ).astype(np.float32)
    j8, js = jsv3.quantize_q_rows(jnp.asarray(q))
    t8, ts = tsv3.quantize_q_rows(torch.from_numpy(q))
    assert t8.dtype == torch.int8 and tuple(ts.shape) == (4, 4, 1)
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("av_int8", [True, False])
@pytest.mark.parametrize("s_len", [None, 199])
def test_plain_version_matches_jax_interpret(data, av_int8, s_len):
    q, k8, ks, v8, vs = data
    ref = np.asarray(jsv3.sqa_cross_int8(*(jnp.asarray(x) for x in data), s_len=s_len,
                                         av_int8=av_int8, interpret=True))
    out = tsv3.sqa_cross_int8(*_torch(q, k8, ks, v8, vs), s_len=s_len, av_int8=av_int8)
    assert out.dtype == torch.float32 and tuple(out.shape) == q.shape
    assert np.abs(out.numpy() - ref).max() <= 1e-4


@pytest.mark.parametrize("av_int8", [True, False])
def test_matches_inline_dequant_oracle(data, av_int8):
    """JAX's tolerances: the int8 query adds <= 0.4% relative error, int8
    weights ~1% on near-uniform random attention."""
    t = _torch(*data)
    ref = tsv3.sqa_cross_reference(*t)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(jsv3.sqa_cross_reference(*(jnp.asarray(x) for x in data))),
        atol=1e-6)
    out = tsv3.sqa_cross_int8(*t, av_int8=av_int8)
    tol = 0.012 if av_int8 else 0.004
    err = (out - ref).abs()
    assert err.max().item() < tol and err.square().mean().sqrt().item() < tol / 3


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_lane_padding_poison_leaves_output_unchanged(data, qdtype):
    """Padded columns (1500 -> 1536 style) never reach the softmax: poisoned
    with 127 and 1e6 scales, the output is bit-identical."""
    q, k8, ks, v8, vs = _torch(*data)
    q = q.to(qdtype)
    s_real = 199
    for av_int8 in (True, False):
        out = tsv3.sqa_cross_int8(q, k8, ks, v8, vs, s_len=s_real, av_int8=av_int8)
        assert out.dtype == qdtype and torch.isfinite(out).all()
        k8p, v8p, ksp, vsp = (x.clone() for x in (k8, v8, ks, vs))
        for x, val in ((k8p, 127), (v8p, 127), (ksp, 1e6), (vsp, 1e6)):
            x[..., s_real:] = val
        poisoned = tsv3.sqa_cross_int8(q, k8p, ksp, v8p, vsp, s_len=s_real,
                                       av_int8=av_int8)
        assert torch.equal(out, poisoned)


def test_int8_av_sum_is_exact_where_float32_rounds():
    """S = 1500 columns of equal weight (k8 = 0: uniform logits, w8 = 127
    on every column) against v8 = 127 but one 126: the int8 A.V sum is
    127 * (127 * 1499 + 126) = 24,193,373, odd and past 2^24, so float32
    cannot hold it, and a float32 running sum drifts further. The kernel
    sums in int32 and rounds once to float32; the plain version must give
    exactly that value."""
    b, h, d, s = 1, 1, 64, 1500
    q = torch.zeros(b, h, d)
    q[..., 0] = 1.0
    k8 = torch.zeros(b, h, d, s, dtype=torch.int8)
    v8 = torch.full((b, h, d, s), 127, dtype=torch.int8)
    v8[..., 0] = 126
    ones = torch.ones(b, h, 1, s)
    exact = 127 * (127 * 1499 + 126)
    assert exact > 2 ** 24 and exact % 2
    terms = np.full(s, 127 * 127, np.float32)
    terms[0] = 127 * 126
    assert np.cumsum(terms, dtype=np.float32)[-1] != np.float32(exact)
    want = np.float32(np.float32(exact) * np.float32(np.float32(1.0) / np.float32(127.0)))
    want = np.float32(want / np.float32(s))
    out = tsv3.sqa_cross_int8_reference(q, k8, ones, v8, ones, av_int8=True)
    assert (out == torch.tensor(want)).all()


def test_wrapper_raises_off_cpu_and_cuda(data):
    q, k8, ks, v8, vs = _torch(*data)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tsv3.sqa_cross_int8(q.to("meta"), k8, ks, v8, vs)


def test_launch_counts_add_up_across_threads():
    """count_launch from many threads with a short switch interval: no
    increment is lost (a bare `count += 1` on a module global can lose
    them between threads)."""
    threads, per_thread = 8, 5000
    mod = sys.modules[tsv3.__name__]
    before = mod.launches
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [_build.count_launch(tsv3.__name__)
                                                    for _ in range(per_thread)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(w.is_alive() for w in workers)
    assert mod.launches == before + threads * per_thread
    mod.launches = before
