"""Checkpoints in the port against the JAX package: the hand-written
safetensors files round-trip both ways with JAX's `save_params` /
`load_params` (float, int8 and LoRA trees); `to_jax_params` inverts
`from_jax_params`; `load_model(checkpoint=...)` and the CLI read them; the
train state round-trips bit for bit."""

import os

import jax
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.lora import add_lora as jax_add_lora
from openai_whisper_coreml_tpu.params import init_params
from openai_whisper_coreml_tpu.quantize import quantize_params as jquantize
from openai_whisper_coreml_tpu.utils import checkpoint as jckpt
from openai_whisper_coreml_tpu_torch import cli as tcli
from openai_whisper_coreml_tpu_torch import config as tconfig
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.models.whisper import WhisperModel, load_model
from openai_whisper_coreml_tpu_torch.params import (assign_params, from_jax_params,
                                                    params_tree, to_jax_params)
from openai_whisper_coreml_tpu_torch.train import TrainConfig, make_train_step
from openai_whisper_coreml_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

SIZE = dict(n_state=128, n_head=2, n_layer=2, n_audio_ctx=32, n_text_ctx=32)


@pytest.fixture(scope="module")
def trees():
    cfg = jax_tiny(**SIZE)
    base = init_params(cfg, jax.random.PRNGKey(0))
    out = {"float": base, "int8": jquantize(base, min_size=0),
           "lora": jax_add_lora(base, rank=2, seed=3)}
    return {k: jax.tree.map(np.asarray, v) for k, v in out.items()}


def _assert_trees_equal(a, b):
    fa, fb = tckpt.flatten_params(a), tckpt.flatten_params(b)
    assert set(fa) == set(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("kind", ["float", "int8", "lora"])
def test_to_jax_params_inverts_from_jax_params(trees, kind):
    """Layers restacked, conv weights back in (kernel, C_in, C_out), int8
    kept, adapters carried both ways."""
    tree = trees[kind]
    _assert_trees_equal(to_jax_params(from_jax_params(tree, tiny_test_config(**SIZE))),
                        tree)


@pytest.mark.parametrize("kind", ["float", "int8", "lora"])
def test_jax_reads_the_ports_files(trees, kind, tmp_path):
    path = str(tmp_path / "port.safetensors")
    model = from_jax_params(trees[kind], tiny_test_config(**SIZE))
    tckpt.save_params(model, path, model_name="test", extra_meta={"k": "v"})
    loaded = jax.tree.map(np.asarray, jckpt.load_params(path))
    _assert_trees_equal(loaded, trees[kind])
    meta = jckpt.read_metadata(path)
    assert meta["format"] == "whisper-tpu-v1" and meta["model"] == "test"
    assert meta["k"] == "v" and (meta.get("quantized") == "int8") == (kind == "int8")


@pytest.mark.parametrize("kind", ["float", "int8", "lora"])
def test_port_reads_jaxs_files(trees, kind, tmp_path):
    path = str(tmp_path / "jax.safetensors")
    jckpt.save_params(trees[kind], path, model_name="test")
    loaded = tckpt.load_params(path, cfg=tiny_test_config(**SIZE))
    _assert_trees_equal(tckpt.unflatten_params(
        {k: v.numpy() for k, v in tckpt.flatten_params(loaded).items()}), trees[kind])
    assert tckpt.read_metadata(path) == jckpt.read_metadata(path)
    if kind == "int8":
        q = loaded["decoder"]["blocks"]["attn"]["q"]
        assert q["w_q"].dtype == torch.int8 and q["scale"].dtype == torch.float32
    bf = tckpt.load_params(path, dtype=torch.bfloat16)
    assert bf["decoder"]["ln"]["scale"].dtype == torch.bfloat16


def test_bf16_is_stored_as_fp32_and_shapes_are_validated(trees, tmp_path):
    cfg = tiny_test_config(**SIZE)
    model = from_jax_params(trees["float"], cfg).to(torch.bfloat16)
    path = str(tmp_path / "bf16.safetensors")
    tckpt.save_params(params_tree(model), path)
    raw, _ = tckpt.read_safetensors(path)
    assert {a.dtype for a in raw.values()} == {np.dtype(np.float32)}
    back = tckpt.flatten_params(tckpt.load_params(path, dtype=torch.bfloat16))
    for k, a in tckpt.flatten_params(params_tree(model)).items():
        assert torch.equal(a, back[k]), k
    with pytest.raises(ValueError, match="decoder layers"):
        tckpt.load_params(path, cfg=tiny_test_config(**{**SIZE, "n_layer": 3}))


def test_load_model_reads_safetensors(trees, tmp_path, monkeypatch):
    cfg = tiny_test_config(**SIZE)
    monkeypatch.setitem(tconfig.CONFIGS, "ckpt-test", cfg)
    for kind in ("float", "int8"):
        path = str(tmp_path / f"{kind}.safetensors")
        jckpt.save_params(trees[kind], path, model_name="ckpt-test")
        model = load_model("ckpt-test", checkpoint=path, device="cpu")
        _assert_trees_equal(to_jax_params(model), trees[kind])
    # a pre-quantized checkpoint satisfies quantize="int8" and refuses others
    load_model("ckpt-test", checkpoint=path, quantize="int8", device="cpu")
    with pytest.raises(ValueError, match="unsupported quantization"):
        load_model("ckpt-test", checkpoint=path, quantize="int4", device="cpu")
    float_path = str(tmp_path / "float.safetensors")
    q = load_model("ckpt-test", checkpoint=float_path, quantize="int8", device="cpu")
    # the stacked (L, 128, 512) fc1 is above the quantizer's size floor
    assert q.decoder.blocks[0].mlp.fc1.w_q is not None
    with pytest.raises(ValueError, match="orbax"):
        load_model("ckpt-test", checkpoint=str(tmp_path), device="cpu")


def test_cli_checkpoint_flag_loads_the_file(monkeypatch, tmp_path):
    seen = {}

    def fake_load_model(name, **kw):
        seen.update(kw, name=name)
        raise SystemExit(0)

    monkeypatch.setattr("openai_whisper_coreml_tpu_torch.load_model", fake_load_model)
    with pytest.raises(SystemExit):
        tcli.main([str(tmp_path / "a.wav"), "--checkpoint", "m.safetensors"])
    assert seen["checkpoint"] == "m.safetensors"


def test_train_state_round_trip_is_bit_exact(trees, tmp_path):
    cfg = tiny_test_config(**SIZE)
    model = from_jax_params(trees["lora"], cfg)
    init_fn, step_fn = make_train_step(cfg, TrainConfig(
        learning_rate=1e-2, trainable="lora_", accum_steps=2, remat=False))
    model, state = init_fn(model)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, cfg.n_mels, 64)).astype(np.float32)
    tokens = rng.integers(0, 1000, (2, 6)).astype(np.int32)
    mask = np.ones((2, 6), np.float32)
    for _ in range(3):
        step_fn(model, state, mel, tokens, mask)
    tckpt.save_train_state(str(tmp_path / "st"), model, opt_state=state, step=3)
    assert os.listdir(tmp_path / "st") == [tckpt.STATE_FILE]
    back = tckpt.restore_train_state(str(tmp_path / "st"))
    assert back["step"] == 3
    assert {k: back["opt_state"][k] for k in ("count", "mini_step", "gradient_step")} \
        == {"count": 1, "mini_step": 1, "gradient_step": 1}
    for key in ("mu", "nu", "acc"):
        for name, t in state[key].items():
            assert torch.equal(back["opt_state"][key][name], t), (key, name)
    fresh = WhisperModel(cfg, tckpt.unflatten_params(
        {k: torch.zeros_like(v) for k, v in tckpt.flatten_params(back["params"]).items()}))
    assign_params(fresh, back["params"])
    for (n, a), (_, b) in zip(model.named_parameters(), fresh.named_parameters()):
        assert torch.equal(a, b), n
