"""The plain versions of the decode kernels K3 (`ops/sqa_self.py`) and K6
(`ops/sqa_int8.py`) against the JAX Pallas kernels in interpret mode, on
the cases of tests/test_sqa_self.py and tests/test_sqa_int8.py; per-row
bounds row by row against JAX's scalar calls; poisoned masked columns.

Both plain versions are held to 1e-5 of JAX in fp32: K6's computes in fp32
throughout; K3's rounds q, K, V and the probabilities to bf16 where the TPU
kernel does, so the two differ only by fp32 summation order (~1e-7 on
these inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu.ops.sqa_int8 import quantize_kv_column as jax_qkv
from openai_whisper_coreml_tpu.ops.sqa_int8 import sqa_int8 as jax_sqa_int8
from openai_whisper_coreml_tpu.ops.sqa_self import sqa_self as jax_sqa_self
from openai_whisper_coreml_tpu_torch.models.decoder import quantize_kv_column
from openai_whisper_coreml_tpu_torch.ops import sqa_int8 as si
from openai_whisper_coreml_tpu_torch.ops import sqa_self as ss

torch.set_num_threads(1)

FP32_ABS = 1e-5


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _k3_close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=FP32_ABS)


@pytest.mark.parametrize("pos,valid", [(7, 0), (31, 4)])
def test_sqa_self_plain_matches_jax(pos, valid):
    rng = np.random.default_rng(0)
    q, k, v = _normal(rng, 3, 8, 64), _normal(rng, 3, 8, 64, 32), _normal(rng, 3, 8, 64, 32)
    ref = jax_sqa_self(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.int32(pos), jnp.int32(valid))
    ours = ss.sqa_self(_t(q), _t(k), _t(v), pos, valid)
    assert ours.dtype == torch.float32 and ours.shape == (3, 8, 64)
    _k3_close(ours.numpy(), ref)
    # bf16 q gives bf16 out
    assert ss.sqa_self(_t(q).bfloat16(), _t(k), _t(v), pos, valid).dtype == torch.bfloat16


def test_sqa_self_per_row_bounds_row_by_row():
    """(B,) bounds equal JAX's scalar call on each row, and the vector call
    of the JAX kernel; columns outside a row's bounds have no influence."""
    rng = np.random.default_rng(1)
    q, k, v = _normal(rng, 4, 4, 64), _normal(rng, 4, 4, 64, 16), _normal(rng, 4, 4, 64, 16)
    pos = np.asarray([3, 7, 11, 15], np.int32)
    valid = np.asarray([0, 2, 4, 6], np.int32)
    ours = ss.sqa_self(_t(q), _t(k), _t(v), _t(pos), _t(valid)).numpy()
    _k3_close(ours, jax_sqa_self(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), jnp.asarray(valid)))
    for i in range(4):
        row = jax_sqa_self(jnp.asarray(q[i:i + 1]), jnp.asarray(k[i:i + 1]),
                           jnp.asarray(v[i:i + 1]), jnp.int32(pos[i]),
                           jnp.int32(valid[i]))
        _k3_close(ours[i:i + 1], row)
        alone = ss.sqa_self(_t(q[i:i + 1]), _t(k[i:i + 1]), _t(v[i:i + 1]),
                            int(pos[i]), int(valid[i]))
        np.testing.assert_array_equal(alone.numpy(), ours[i:i + 1])
    poisoned_k, poisoned_v = k.copy(), v.copy()
    for i in range(4):
        poisoned_k[i, ..., :valid[i]] = 1e3
        poisoned_k[i, ..., pos[i] + 1:] = np.nan
        poisoned_v[i, ..., :valid[i]] = -1e3
        poisoned_v[i, ..., pos[i] + 1:] = 1e4  # finite: 0 * inf is nan
    again = ss.sqa_self(_t(q), _t(poisoned_k), _t(poisoned_v), _t(pos), _t(valid))
    np.testing.assert_array_equal(again.numpy(), ours)


def test_sqa_self_pos_past_the_cache_is_the_last_column():
    """A finished continuous-batching row sits at pos == C: all columns."""
    rng = np.random.default_rng(2)
    q, k, v = _normal(rng, 2, 2, 64), _normal(rng, 2, 2, 64, 8), _normal(rng, 2, 2, 64, 8)
    np.testing.assert_array_equal(
        ss.sqa_self(_t(q), _t(k), _t(v), torch.tensor([8, 9]), 0).numpy(),
        ss.sqa_self(_t(q), _t(k), _t(v), 7, 0).numpy())


def _quant(x):
    return quantize_kv_column(_t(x))


@pytest.mark.parametrize("pos,valid", [(0, 0), (100, 0), (250, 2)])
def test_sqa_int8_plain_matches_jax(pos, valid):
    rng = np.random.default_rng(3)
    q, k, v = _normal(rng, 2, 4, 64), _normal(rng, 2, 4, 64, 256), _normal(rng, 2, 4, 64, 256)
    # the same int8 values on both sides: JAX's quantiser
    k8, ks = (np.asarray(a) for a in jax_qkv(jnp.asarray(k)))
    v8, vs = (np.asarray(a) for a in jax_qkv(jnp.asarray(v)))
    ref = np.asarray(jax_sqa_int8(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(ks),
                                  jnp.asarray(v8), jnp.asarray(vs),
                                  jnp.int32(pos), jnp.int32(valid)))
    ours = si.sqa_int8(_t(q), _t(k8), _t(ks), _t(v8), _t(vs), pos, valid)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=FP32_ABS)


def test_sqa_int8_per_row_bounds_row_by_row():
    rng = np.random.default_rng(4)
    b = 3
    q = _normal(rng, b, 2, 64)
    k8, ks = _quant(_normal(rng, b, 2, 64, 64))
    v8, vs = _quant(_normal(rng, b, 2, 64, 64))
    pos = np.asarray([5, 40, 63], np.int32)
    valid = np.asarray([0, 9, 30], np.int32)
    ours = si.sqa_int8(_t(q), k8, ks, v8, vs, _t(pos), _t(valid)).numpy()
    for i in range(b):
        row = jax_sqa_int8(jnp.asarray(q[i:i + 1]), jnp.asarray(k8[i:i + 1].numpy()),
                           jnp.asarray(ks[i:i + 1].numpy()),
                           jnp.asarray(v8[i:i + 1].numpy()),
                           jnp.asarray(vs[i:i + 1].numpy()), jnp.int32(pos[i]),
                           jnp.int32(valid[i]))
        np.testing.assert_allclose(ours[i:i + 1], np.asarray(row), atol=FP32_ABS)


def test_sqa_int8_poisoned_masked_columns_ignored():
    """As tests/test_sqa_int8.py: K/V beyond pos set to +-1e3 change
    nothing, in JAX and in the port, and the two agree."""
    rng = np.random.default_rng(5)
    q = _normal(rng, 1, 2, 64)
    k, v = _normal(rng, 1, 2, 64, 128), _normal(rng, 1, 2, 64, 128)
    k2, v2 = k.copy(), v.copy()
    k2[..., 60:] = 1e3
    v2[..., 60:] = -1e3
    outs = []
    for kk, vv in ((k, v), (k2, v2)):
        k8, ks = _quant(kk)
        v8, vs = _quant(vv)
        ours = si.sqa_int8(_t(q), k8, ks, v8, vs, 59, 0).numpy()
        ref = np.asarray(jax_sqa_int8(
            jnp.asarray(q), jnp.asarray(k8.numpy()), jnp.asarray(ks.numpy()),
            jnp.asarray(v8.numpy()), jnp.asarray(vs.numpy()), jnp.int32(59),
            jnp.int32(0)))
        np.testing.assert_allclose(ours, ref, atol=FP32_ABS)
        outs.append(ours)
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)


def test_sqa_int8_bf16_query_and_device_scalar_bounds():
    rng = np.random.default_rng(6)
    q = _t(_normal(rng, 2, 2, 64))
    k8, ks = _quant(_normal(rng, 2, 2, 64, 32))
    v8, vs = _quant(_normal(rng, 2, 2, 64, 32))
    out = si.sqa_int8(q.bfloat16(), k8, ks, v8, vs, torch.tensor(20), torch.tensor(3))
    assert out.dtype == torch.bfloat16
    ref = si.sqa_int8_reference(q.bfloat16().float(), k8, ks, v8, vs, 20, 3)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=1e-2)


def test_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors the wrappers run the plain versions and launch nothing."""
    rng = np.random.default_rng(7)
    q, k, v = (_t(x) for x in (_normal(rng, 2, 2, 64), _normal(rng, 2, 2, 64, 16),
                               _normal(rng, 2, 2, 64, 16)))
    k8, ks = quantize_kv_column(k)
    v8, vs = quantize_kv_column(v)
    before = ss.launches, si.launches
    torch.testing.assert_close(ss.sqa_self(q, k, v, 9, 1),
                               ss.sqa_self_reference(q, k, v, 9, 1), rtol=0, atol=0)
    torch.testing.assert_close(si.sqa_int8(q, k8, ks, v8, vs, 9, 1),
                               si.sqa_int8_reference(q, k8, ks, v8, vs, 9, 1),
                               rtol=0, atol=0)
    assert (ss.launches, si.launches) == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        ss.sqa_self(q.to("meta"), k.to("meta"), v.to("meta"), 9, 1)


@pytest.mark.parametrize("kernel", ["sqa_self", "sqa_int8"])
def test_step_entries_take_the_plain_version_per_layer_on_the_cpu(kernel):
    """decode_step's per-step entries over stacked (L, B, H, D, S) tensors:
    attend(q (B, 1, H, D), l) is the wrapper on layer l, (B, 1, H, D)."""
    rng = np.random.default_rng(8)
    q = _t(_normal(rng, 2, 1, 3, 64))
    k, v = _t(_normal(rng, 4, 2, 3, 64, 24)), _t(_normal(rng, 4, 2, 3, 64, 24))
    pos, valid = torch.tensor([20, 23]), torch.tensor([1, 0])
    if kernel == "sqa_self":
        stacked, wrapper = (k, v), ss.sqa_self
        attend = ss.sqa_self_layers(k, v, pos, valid)
    else:
        stacked, wrapper = (*quantize_kv_column(k), *quantize_kv_column(v)), si.sqa_int8
        attend = si.sqa_int8_layers(*stacked, pos, valid)
    before = ss.launches, si.launches
    for l in range(4):
        out = attend(q, l)
        assert out.shape == q.shape
        torch.testing.assert_close(
            out, wrapper(q[:, 0], *(t[l] for t in stacked), pos, valid)[:, None],
            rtol=0, atol=0)
    assert (ss.launches, si.launches) == before
