"""LoRA in the port (lora.py and the adapters in `layers.linear`) against
the JAX package: JAX's adapters carried across give JAX's logits and greedy
tokens; `add_lora` is the identity at init; `merge_lora` equals the
run-time adapter; int8 bases take adapters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import lora as jlora
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.decoding import DecodingOptions as JOptions
from openai_whisper_coreml_tpu.decoding import decode as jdecode
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JModel
from openai_whisper_coreml_tpu.params import init_params
from openai_whisper_coreml_tpu.quantize import quantize_params as jquantize
from openai_whisper_coreml_tpu_torch import lora as tlora
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.decoding import DecodingOptions, decode
from openai_whisper_coreml_tpu_torch.models.whisper import WhisperModel
from openai_whisper_coreml_tpu_torch.params import (from_jax_params,
                                                    params_tree, to_jax_params)
from openai_whisper_coreml_tpu_torch.quantize import quantize_params

torch.set_num_threads(1)

SIZE = dict(n_state=64, n_head=2, n_layer=2, n_audio_ctx=32, n_text_ctx=32)


@pytest.fixture(scope="module")
def cfgs():
    return jax_tiny(**SIZE), tiny_test_config(**SIZE)


@pytest.fixture(scope="module")
def base(cfgs):
    return jax.tree.map(np.asarray, init_params(cfgs[0], jax.random.PRNGKey(0)))


def _randomize_b(tree, seed, scale):
    """JAX tree with every lora_b drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: ((rng.standard_normal(x.shape) * scale).astype(np.float32)
                      if str(getattr(p[-1], "key", "")) == "lora_b" else np.asarray(x)),
        tree)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    feats = (rng.standard_normal((1, cfg.n_audio_ctx, cfg.n_audio_state))
             * 0.1).astype(np.float32)
    return feats, np.array([[cfg.sot_token, 3, 5]], np.int32)


def _port_logits(model, feats, toks):
    with torch.no_grad():
        return model.logits(toks, torch.from_numpy(feats)).numpy()


@pytest.mark.parametrize("int8", [False, True])
def test_jax_adapters_carried_across_give_jax_logits(cfgs, base, int8):
    jcfg, tcfg = cfgs
    tree = jax.tree.map(np.asarray, jquantize(base, min_size=0)) if int8 else base
    adapted = _randomize_b(jlora.add_lora(tree, rank=4, seed=1), 5, 0.02)
    feats, toks = _inputs(jcfg)
    want = np.asarray(JModel(cfg=jcfg, params=adapted).logits(toks, feats))
    model = from_jax_params(adapted, tcfg)
    q = model.decoder.blocks[0].attn.q
    assert q.lora_a is not None and (q.w_q is not None) == int8
    np.testing.assert_allclose(_port_logits(model, feats, toks), want, atol=1e-4)
    assert tlora.count_lora_params(model) == jlora.count_lora_params(adapted)


def test_add_lora_is_identity_at_init(cfgs, base):
    """B = 0: the adapted model's logits equal the base's bit for bit."""
    _, tcfg = cfgs
    model = from_jax_params(base, tcfg)
    tree = params_tree(model)
    adapted = tlora.add_lora(tree, rank=4, seed=1)
    q = adapted["decoder"]["blocks"]["attn"]["q"]
    assert tuple(q["lora_a"].shape) == (tcfg.n_text_layer, tcfg.n_text_state, 4)
    assert tuple(q["lora_b"].shape) == (tcfg.n_text_layer, 4, tcfg.n_text_state)
    assert q["lora_a"].dtype == torch.float32 and not q["lora_b"].any()
    assert "lora_a" not in adapted["decoder"]["blocks"]["attn"]["k"]
    assert "lora_a" not in adapted["decoder"]["blocks"]["mlp"]["fc1"]
    assert "lora_a" in adapted["encoder"]["blocks"]["attn"]["v"]
    assert "lora_a" in adapted["decoder"]["blocks"]["cross_attn"]["q"]
    feats, toks = _inputs(tcfg)
    np.testing.assert_array_equal(
        _port_logits(WhisperModel(tcfg, adapted), feats, toks),
        _port_logits(model, feats, toks))
    jcount = jlora.count_lora_params(jlora.add_lora(base, rank=4))
    assert tlora.count_lora_params(adapted) == jcount


def test_merge_lora_matches_runtime_adapter(cfgs, base):
    _, tcfg = cfgs
    adapted = _randomize_b(jlora.add_lora(base, rank=4, seed=2), 7, 0.02)
    model = from_jax_params(adapted, tcfg)
    merged = tlora.merge_lora(model)
    assert tlora.count_lora_params(merged) == 0
    feats, toks = _inputs(tcfg, 1)
    np.testing.assert_allclose(
        _port_logits(WhisperModel(tcfg, merged), feats, toks),
        _port_logits(model, feats, toks), atol=1e-4)
    # the merged weights are JAX's merge of the same adapters
    want = jax.tree.map(np.asarray, jlora.merge_lora(adapted))
    got = to_jax_params(WhisperModel(tcfg, merged))
    np.testing.assert_allclose(got["decoder"]["blocks"]["attn"]["q"]["w"],
                               want["decoder"]["blocks"]["attn"]["q"]["w"],
                               atol=1e-6)


def test_lora_on_int8_base_and_validation(cfgs, base):
    _, tcfg = cfgs
    tree = quantize_params(params_tree(from_jax_params(base, tcfg)), min_size=0)
    adapted = tlora.add_lora(tree, rank=2)
    assert "w_q" in adapted["decoder"]["blocks"]["attn"]["q"]
    assert "lora_a" in adapted["decoder"]["blocks"]["attn"]["q"]
    with pytest.raises(ValueError, match="quantized base"):
        tlora.merge_lora(adapted)
    with pytest.raises(ValueError, match="matched no"):
        tlora.add_lora(tree, targets="nonexistent$")
    with pytest.raises(ValueError, match="rank"):
        tlora.add_lora(tree, rank=0)
    with pytest.raises(ValueError, match="unknown linear leaves"):
        WhisperModel(tcfg, {**tree, "decoder": {
            **tree["decoder"], "blocks": {**tree["decoder"]["blocks"], "attn": {
                **tree["decoder"]["blocks"]["attn"],
                "q": {**tree["decoder"]["blocks"]["attn"]["q"],
                      "lora_c": torch.zeros(tcfg.n_text_layer, 1)}}}}})


def test_lora_greedy_decode_uses_adapters(cfgs, base):
    """The KV-cache decode loop applies adapters: the port's adapted greedy
    tokens equal JAX's and its merged-weights tokens, and differ from the
    base's."""
    jcfg, tcfg = cfgs
    adapted = _randomize_b(jlora.add_lora(base, rank=4, seed=8), 3, 0.05)
    feats, _ = _inputs(jcfg, 2)
    want = jdecode(JModel(cfg=jcfg, params=adapted), jnp.asarray(feats),
                   JOptions(language="en", sample_len=8),
                   from_features=True)[0].tokens
    opts = DecodingOptions(language="en", sample_len=8)

    def toks(model):
        with torch.no_grad():
            return decode(model, torch.from_numpy(feats), opts,
                          from_features=True)[0].tokens

    model = from_jax_params(adapted, tcfg)
    got = toks(model)
    assert got == list(want)
    assert got == toks(WhisperModel(tcfg, tlora.merge_lora(model)))
    assert got != toks(from_jax_params(base, tcfg))
