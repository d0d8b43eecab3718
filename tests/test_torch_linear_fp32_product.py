"""The port's linear and tied-embedding logits take their products in fp32,
as JAX's `dot(..., preferred_element_type=float32)` does, and round once
at the end (`models.layers.fp32_product`).

The bias is chosen to cancel most of each product (b ~ -(x @ w)(1 - 2^-6)),
so the result is a small difference of two large terms: a product rounded
to bf16 before the bias moves it by many bf16 spacings of the result,
while another fp32 summation order moves it by less than one. fp32 models
keep their bits."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu.models.decoder import final_logits as jax_final_logits
from openai_whisper_coreml_tpu.models.layers import linear as jax_linear
from openai_whisper_coreml_tpu_torch.models.decoder import final_logits
from openai_whisper_coreml_tpu_torch.models.layers import LayerNorm, Linear, linear

torch.set_num_threads(1)

N_IN, N_OUT, RANK = 64, 48, 8


def _bf16(a: np.ndarray) -> np.ndarray:
    """Values that bf16 holds, as fp32."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _leaves(kind: str, seed: int) -> tuple:
    """(x, leaves) as fp32 numpy arrays of bf16 values (int8 codes and fp32
    scales for the int8 leaf), with a bias that cancels most of each
    output."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((4, 3, N_IN)))
    p = {}
    if kind == "int8":
        p["w_q"] = rng.integers(-127, 128, (N_IN, N_OUT)).astype(np.int8)
        p["scale"] = (0.01 * (1 + rng.random(N_OUT))).astype(np.float32)
        y = (x.astype(np.float64) @ p["w_q"].astype(np.float64)) * p["scale"]
    else:
        p["w"] = _bf16(rng.standard_normal((N_IN, N_OUT)))
        y = x.astype(np.float64) @ p["w"].astype(np.float64)
    if kind == "lora":
        p["lora_a"] = _bf16(rng.standard_normal((N_IN, RANK)))
        p["lora_b"] = _bf16(0.5 * rng.standard_normal((RANK, N_OUT)))
        xa = _bf16(x.astype(np.float64) @ p["lora_a"].astype(np.float64))
        y = y + xa.astype(np.float64) @ p["lora_b"].astype(np.float64)
    # one bias per output column: the negative of the first row's output
    p["b"] = _bf16(-(1 - 2.0 ** -6) * y[0, 0])
    return x, p


def _bf16_spacing(v: np.ndarray) -> np.ndarray:
    """The gap between a bf16 value and the next one away from zero."""
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _port_leaf(name: str, v: np.ndarray, dtype) -> torch.Tensor:
    t = torch.from_numpy(v)
    return t if name in ("w_q", "scale") else t.to(dtype)


@pytest.mark.parametrize("kind", ["float", "int8", "lora"])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_linear_rounds_once_as_jax(kind, seed):
    """bf16 in, bf16 out: the port's linear equals JAX's, or sits within
    one bf16 spacing where the fp32 sums run in another order."""
    x, p = _leaves(kind, seed)
    want = np.asarray(jax_linear(
        jnp.asarray(x, jnp.bfloat16),
        {k: jnp.asarray(v) if k in ("w_q", "scale") else jnp.asarray(v, jnp.bfloat16)
         for k, v in p.items()}).astype(jnp.float32))
    got = linear(torch.from_numpy(x).bfloat16(),
                 Linear({k: _port_leaf(k, v, torch.bfloat16) for k, v in p.items()}))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= _bf16_spacing(want)).all(), float(diff.max())
    # most outputs are equal: another summation order seldom crosses a
    # rounding boundary of the small result
    assert (diff == 0).mean() > 0.9


def _logits_inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((2, 5, N_IN)))
    emb = _bf16(rng.standard_normal((50, N_IN)))
    ln = {"scale": _bf16(1 + 0.1 * rng.standard_normal(N_IN)),
          "bias": _bf16(0.1 * rng.standard_normal(N_IN))}
    return x, emb, ln


def _port_decoder(emb, ln, dtype):
    return types.SimpleNamespace(
        ln=LayerNorm({k: torch.from_numpy(v).to(dtype) for k, v in ln.items()}),
        token_embedding=torch.from_numpy(emb).to(dtype))


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_final_logits_unrounded_as_jax(seed):
    """The tied-embedding logits of a bf16 model are JAX's fp32 product,
    not a bf16 product upcast after the fact."""
    x, emb, ln = _logits_inputs(seed)
    want = np.asarray(jax_final_logits(
        {"decoder": {"token_embedding": jnp.asarray(emb, jnp.bfloat16),
                     "ln": {k: jnp.asarray(v, jnp.bfloat16) for k, v in ln.items()}}},
        jnp.asarray(x, jnp.bfloat16)))
    got = final_logits(_port_decoder(emb, ln, torch.bfloat16),
                       torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.float32
    # fp32 summation order only: far below the 2^-9 of a bf16 rounding
    assert float(np.abs(got.numpy() - want).max()) <= 2.0 ** -16 * float(np.abs(want).max())


@pytest.mark.parametrize("kind", ["float", "int8", "lora"])
def test_fp32_linear_and_logits_keep_their_bits(kind):
    """fp32 models are unchanged: the linear is bit-equal to the plain
    fp32 expression, and so are the logits."""
    x, p = _leaves(kind, 2)
    t = {k: _port_leaf(k, v, torch.float32) for k, v in p.items()}
    xt = torch.from_numpy(x)
    y = xt @ (t["w"] if "w" in t else t["w_q"].float())
    if "w_q" in t:
        y = y * t["scale"]
    if "lora_a" in t:
        y = y + (xt @ t["lora_a"]) @ t["lora_b"]
    want = y + t["b"]
    assert torch.equal(linear(xt, Linear(t)), want)

    x, emb, ln = _logits_inputs(3)
    dec = _port_decoder(emb, ln, torch.float32)
    from openai_whisper_coreml_tpu_torch.models.layers import layer_norm

    xt = torch.from_numpy(x)
    assert torch.equal(final_logits(dec, xt),
                       layer_norm(xt, dec.ln) @ dec.token_embedding.T)
