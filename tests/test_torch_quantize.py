"""Port int8 weight quantisation against the JAX package's."""

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import quantize as jq
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.models.layers import linear as jax_linear
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu_torch import quantize as tq
from openai_whisper_coreml_tpu_torch.models.layers import Linear
from openai_whisper_coreml_tpu_torch.params import tree_from_numpy

# tiny tensors: one torch thread per test worker keeps parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(256, 512), (2, 96, 384)])
def test_quantize_linear_matches_jax(rng, shape):
    w = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    w[..., 0, 3] = 0.0  # exercise a half-way tie and a zero row entry
    ref = jq.quantize_linear(jax.numpy.asarray(w))
    ours = tq.quantize_linear(torch.from_numpy(w))
    assert ours["w_q"].dtype == torch.int8
    np.testing.assert_array_equal(ours["w_q"].numpy(), np.asarray(ref["w_q"]))
    np.testing.assert_allclose(ours["scale"].numpy(), np.asarray(ref["scale"]),
                               rtol=1e-7)


@pytest.mark.parametrize("min_size", [0, jq.MIN_QUANT_SIZE, 1 << 14])
def test_quantize_params_tree_matches_jax(min_size):
    cfg = jax_tiny(n_state=64, n_head=2, n_layer=2, n_audio_ctx=64)
    params = jax_init(cfg, jax.random.PRNGKey(0))
    ref = jax.tree.map(np.asarray, jq.quantize_params(params, min_size=min_size))
    ours = tq.quantize_params(tree_from_numpy(jax.tree.map(np.asarray, params)),
                              min_size=min_size)
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    ours_flat = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), ours, is_leaf=torch.is_tensor))[0])
    assert len(ref_leaves) == len(ours_flat)
    for path, leaf in ref_leaves:
        got = ours_flat[path]
        assert got.dtype == leaf.dtype, path
        if leaf.dtype == np.int8:
            np.testing.assert_array_equal(got, leaf)
        else:
            np.testing.assert_allclose(got, leaf, rtol=1e-7)


def test_quantize_params_keeps_lora_adapters_as_jax():
    """Adapters on a quantized linear ride along in float, as in JAX (the
    port dropped them before)."""
    from openai_whisper_coreml_tpu.lora import add_lora as jax_add_lora

    cfg = jax_tiny(n_state=128, n_head=2, n_layer=2, n_audio_ctx=64)
    params = jax.tree.map(np.asarray, jax_add_lora(
        jax_init(cfg, jax.random.PRNGKey(0)), rank=4, targets=r"mlp/fc1$"))
    ref = jq.quantize_params(params)["decoder"]["blocks"]["mlp"]["fc1"]
    ours = tq.quantize_params(tree_from_numpy(params))["decoder"]["blocks"]["mlp"]["fc1"]
    assert set(ours) == set(ref) == {"w_q", "scale", "b", "lora_a", "lora_b"}
    for k in ("lora_a", "lora_b"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


def test_int8_linear_matches_jax(rng):
    w = (0.05 * rng.standard_normal((128, 256))).astype(np.float32)
    b = (0.01 * rng.standard_normal(256)).astype(np.float32)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    qp = jq.quantize_linear(jax.numpy.asarray(w))
    ref = jax_linear(x, {**qp, "b": b})
    mod = Linear({k: torch.tensor(np.asarray(v)) for k, v in
                  {**qp, "b": b}.items()})
    np.testing.assert_allclose(mod(torch.from_numpy(x)).numpy(),
                               np.asarray(ref), atol=1e-5)
    with pytest.raises(ValueError, match="exactly one"):
        Linear({"b": torch.from_numpy(b)})


@pytest.mark.parametrize("divisor", [127.0, 6.0, 3.0])
def test_ieee_div_equals_tensor_division(rng, divisor):
    """The helper divides tensor by tensor, once, with either side a Python
    number: bit-equal to torch.div of two tensors, and to numpy's fp32
    division."""
    x = (rng.standard_normal((64, 257)) * 3).astype(np.float32)
    xt = torch.from_numpy(x)
    full = torch.full_like(xt, divisor)
    for got, want, ref in ((tq.ieee_div(xt, divisor), torch.div(xt, full),
                            x / np.float32(divisor)),
                           (tq.ieee_div(divisor, xt), torch.div(full, xt),
                            np.float32(divisor) / x)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(got.numpy(), ref)
