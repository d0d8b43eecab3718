"""Training in the port against the JAX package's `train.py`: the loss and
every gradient leaf, the optimizer's arithmetic (optax's clip, AdamW,
schedules and MultiSteps), and parameters after several updates of the
full train step on a one-device CPU mesh. Tiny config, fp32, inputs from
a numpy seed, JAX's weights carried across."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openai_whisper_coreml_tpu import train as jtrain
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.lora import add_lora as jax_add_lora
from openai_whisper_coreml_tpu.params import init_params
from openai_whisper_coreml_tpu.parallel import make_mesh
from openai_whisper_coreml_tpu.quantize import quantize_params
from openai_whisper_coreml_tpu.tokenizer import get_tokenizer
from openai_whisper_coreml_tpu.utils.checkpoint import flatten_params
from openai_whisper_coreml_tpu_torch import train as ttrain
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.params import (from_jax_params, jax_path,
                                                    to_jax_params)

torch.set_num_threads(1)

SIZE = dict(n_state=128, n_head=2, n_layer=2, n_audio_ctx=32, n_text_ctx=32)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jax_tiny(**SIZE), tiny_test_config(**SIZE)
    tok = get_tokenizer(jcfg)
    rng = np.random.default_rng(0)
    batches = []
    for s in range(6):
        mel = rng.standard_normal((2, jcfg.n_mels, 64)).astype(np.float32)
        batches.append(jtrain.make_batch(jcfg, tok, mel,
                                         [f"a {s} b", f"c d {s} e"], max_len=12))
    return jcfg, tcfg, batches


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(jcfg, lora=False, int8=False):
    p = init_params(jcfg, jax.random.PRNGKey(0))
    if int8:
        p = quantize_params(p)
    if lora:
        p = jax_add_lora(p, rank=4, seed=1)
    return _np_tree(p)


def _dequantized(tree):
    """An int8 tree's float twin, w = w_q * scale: JAX's train step cannot
    take int8 leaves (jax.grad refuses integer inputs), so it trains LoRA
    on this base, which computes the same function to fp32 rounding."""
    if not isinstance(tree, dict):
        return tree
    if "w_q" in tree:
        out = {k: v for k, v in tree.items() if k not in ("w_q", "scale")}
        out["w"] = tree["w_q"].astype(np.float32) * tree["scale"]
        return out
    return {k: _dequantized(v) for k, v in tree.items()}


def _grads_flat(model, grads):
    """Port gradients by JAX path, layers restacked, conv in JAX order."""
    groups = {}
    for (name, _), g in zip(model.named_parameters(), grads):
        groups.setdefault(jax_path(name), []).append(g)
    out = {}
    for path, ts in groups.items():
        t = torch.stack(ts) if "/blocks/" in path else ts[0]
        if path in ("encoder/conv1/w", "encoder/conv2/w"):
            t = t.permute(2, 1, 0)
        out[path] = t.detach().numpy()
    return out


@pytest.mark.parametrize("flash", [False, True])
def test_loss_and_gradients_match_jax(setup, flash):
    """loss_fn's loss, accuracy and every gradient leaf against
    jax.value_and_grad of JAX's loss_fn (remat on in both; with flash the
    port also runs the decoder's causal attention through the flash
    wrapper)."""
    jcfg, tcfg, batches = setup
    mel, tokens, mask = batches[0]
    params = _jax_params(jcfg)
    (loss, aux), grads = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(mel),
        jnp.asarray(tokens), jnp.asarray(mask), remat=True, flash=flash)
    model = from_jax_params(params, tcfg)
    for p in model.parameters():
        p.requires_grad_(True)
    tloss, taux = ttrain.loss_fn(model, torch.from_numpy(mel),
                                 torch.from_numpy(tokens).long(),
                                 torch.from_numpy(mask), remat=True, flash=flash)
    tgrads = torch.autograd.grad(tloss, list(model.parameters()))
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(taux["accuracy"]), float(aux["accuracy"]),
                               rtol=1e-5)
    assert float(taux["tokens"]) == float(aux["tokens"])
    want = flatten_params(_np_tree(grads))
    got = _grads_flat(model, tgrads)
    assert set(got) == set(want)
    for path, g in want.items():
        scale = np.abs(g).max()
        assert np.abs(got[path] - g).max() <= 1e-4 * scale, path


CASES = {
    "cosine-warmup-accum": (dict(schedule="cosine", warmup_steps=1,
                                 total_steps=3, accum_steps=2), {}, 6),
    "decoder": (dict(trainable="^decoder"), {}, 3),
    "ln-bias-no-clip": (dict(trainable="ln|bias", max_grad_norm=1e3), {}, 3),
    "lora-int8-flash": (dict(trainable="lora_", flash=True),
                        dict(lora=True, int8=True), 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_params_after_updates_match_jax_train_step(setup, case):
    """Params after 3 optimizer updates of the port's train step against
    JAX make_train_step on a 1-device CPU mesh: trained leaves within
    1e-2 * lr, frozen leaves bit-exact in both."""
    jcfg, tcfg, batches = setup
    tc_kw, p_kw, micro = CASES[case]
    lr = 1e-2
    params = _jax_params(jcfg, **p_kw)
    mesh = make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    init_fn, step_fn = jtrain.make_train_step(
        jcfg, mesh, jtrain.TrainConfig(learning_rate=lr, **tc_kw))
    jp, jstate = init_fn(jax.tree.map(jnp.asarray, _dequantized(params)))
    tinit, tstep = ttrain.make_train_step(
        tcfg, ttrain.TrainConfig(learning_rate=lr, **tc_kw))
    model, tstate = tinit(from_jax_params(params, tcfg))
    for mel, tokens, mask in batches[:micro]:
        jp, jstate, jm = step_fn(jp, jstate, *map(jnp.asarray, (mel, tokens, mask)))
        model, tstate, tm = tstep(model, tstate, mel, tokens, mask)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    assert tstate["count"] == 3
    before = flatten_params(params)
    want = flatten_params(_np_tree(jp))
    got = flatten_params(to_jax_params(model))
    jbefore = flatten_params(_dequantized(params))
    trained = {jax_path(n) for n, p in model.named_parameters() if p.requires_grad}
    assert trained and set(got) == set(before) and set(want) == set(jbefore)
    for path in trained:
        assert np.abs(got[path] - want[path]).max() <= 1e-2 * lr, path
        assert not np.array_equal(got[path], before[path]), path
    for path in set(got) - trained:
        np.testing.assert_array_equal(got[path], before[path], err_msg=path)
    for path in set(want) - trained:
        np.testing.assert_array_equal(want[path], jbefore[path], err_msg=path)


@pytest.mark.parametrize("pattern", ["ln|bias", "^decoder", "lora_",
                                     "^decoder/blocks/attn/", "cross_attn/q"])
def test_trainable_pattern_selects_jax_paths(setup, pattern):
    """The regex is matched against JAX paths: the port trains exactly the
    leaves JAX labels "train" ("ln|bias" is layer norms only, since a
    linear's bias is `b`)."""
    jcfg, tcfg, _ = setup
    params = _jax_params(jcfg, lora=True)
    labels = jtrain._param_path_labels(params, pattern)
    want = {k for k, v in flatten_params(labels).items() if v == "train"}
    model = from_jax_params(params, tcfg)
    got = {jax_path(n) for n, t in ttrain.trainable_labels(model, pattern).items()
           if t}
    assert got == want
    if pattern == "ln|bias":
        assert all(p.rsplit("/", 2)[-2].endswith("ln") or "/ln" in p for p in got)


def test_trainable_pattern_matching_nothing_raises(setup):
    jcfg, tcfg, _ = setup
    model = from_jax_params(_jax_params(jcfg), tcfg)
    # "3" would match torch names such as decoder.blocks.3...; no JAX path
    # holds a layer index
    for pattern in ("3", "nonexistent_leaf_zz"):
        with pytest.raises(ValueError, match="matches no parameters"):
            ttrain.trainable_labels(model, pattern)


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
def test_schedules_match_optax(kind):
    tc = ttrain.TrainConfig(learning_rate=3e-3, schedule=kind, warmup_steps=3,
                            total_steps=None if kind == "constant" else 11)
    jtc = jtrain.TrainConfig(**{f: getattr(tc, f) for f in (
        "learning_rate", "schedule", "warmup_steps", "total_steps")})
    ours, ref = ttrain.learning_rate_schedule(tc), jtrain.learning_rate_schedule(jtc)
    for count in range(15):
        np.testing.assert_allclose(float(ours(count)), float(ref(count)),
                                   rtol=1e-6, atol=1e-12)
    assert float(ours(0)) == 0.0  # the first update of a warmup runs at lr 0
    assert ttrain.learning_rate_schedule(ttrain.TrainConfig()) == 1e-5


def test_schedule_validation():
    with pytest.raises(ValueError, match="total_steps"):
        ttrain.learning_rate_schedule(ttrain.TrainConfig(schedule="cosine"))
    with pytest.raises(ValueError, match="unknown schedule"):
        ttrain.learning_rate_schedule(ttrain.TrainConfig(schedule="exponential"))
    with pytest.raises(ValueError, match="accum_steps"):
        ttrain.Optimizer(ttrain.TrainConfig(accum_steps=0), {"w": True})


@pytest.mark.parametrize("kw", [
    dict(max_grad_norm=1.0),                    # clipped: norm > max
    dict(max_grad_norm=50.0),                   # below max: g as it is
    dict(schedule="cosine", warmup_steps=1, total_steps=3, accum_steps=2),
    dict(weight_decay=0.5, b2=0.9),
])
def test_optimizer_matches_optax(kw):
    """The port's Optimizer against optax's chain (make_optimizer) on a toy
    tree: clip without epsilon, AdamW with bias correction and decoupled
    decay, schedule from update 0, MultiSteps' running mean."""
    rng = np.random.default_rng(1)
    shapes = {"w": (4, 5), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tc = ttrain.TrainConfig(learning_rate=1e-2, **kw)
    jopt = jtrain.make_optimizer(jtrain.TrainConfig(learning_rate=1e-2, **kw))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    opt = ttrain.Optimizer(tc, {k: True for k in shapes})
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(tp)
    for i in range(6):
        grads = {k: (3.0 * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update({k: torch.from_numpy(g) for k, g in grads.items()}, state, tp)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)


def test_bf16_params_keep_bf16_moments():
    opt = ttrain.Optimizer(ttrain.TrainConfig(accum_steps=2), {"w": True})
    state = opt.init({"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert {state[k]["w"].dtype for k in ("mu", "nu", "acc")} == {torch.bfloat16}
