"""The port's DP x TP mesh (`parallel/`) against JAX's (`test_sharding.py`
and `dryrun_multichip`), on gloo ranks spawned on the CPU.

JAX runs the mesh in one process on 8 virtual devices; the port runs one
process per rank. Each mesh is spawned once (`torch_parallel_worker`),
runs every check on every rank, and the tests below hold the ranks'
results against JAX's unsharded model on the same weights: the spec tree
and every rank's local leaves (float and int8) against JAX's shards,
fp32 logits within 1e-3, greedy, beam, padded-batch, language-ID,
speculative and continuous-scheduler tokens exactly, and a sampled decode
under DP seed-exact against the port's one-process sampler. A model
without a mesh stays the one-card model: no process group, plain linears."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import serve as jserve
from openai_whisper_coreml_tpu.config import tiny_test_config as jax_tiny
from openai_whisper_coreml_tpu.decoding import DecodingOptions as JaxOptions
from openai_whisper_coreml_tpu.decoding import decode as jax_decode
from openai_whisper_coreml_tpu.decoding import detect_language as jax_detect
from openai_whisper_coreml_tpu.models.layers import linear as jax_linear
from openai_whisper_coreml_tpu.models.whisper import WhisperModel as JaxModel
from openai_whisper_coreml_tpu.parallel import make_mesh as jax_make_mesh
from openai_whisper_coreml_tpu.parallel import param_pspecs as jax_pspecs
from openai_whisper_coreml_tpu.parallel import shard_params as jax_shard
from openai_whisper_coreml_tpu.params import init_params as jax_init
from openai_whisper_coreml_tpu.quantize import quantize_params as jax_quantize
from openai_whisper_coreml_tpu_torch.config import tiny_test_config
from openai_whisper_coreml_tpu_torch.decoding import DecodingOptions, decode
from openai_whisper_coreml_tpu_torch.parallel import param_pspecs
from openai_whisper_coreml_tpu_torch.params import from_jax_params, tree_from_numpy
from openai_whisper_coreml_tpu_torch.quantize import quantize_params
from openai_whisper_coreml_tpu_torch.utils.checkpoint import (flatten_params,
                                                              save_params)

from . import torch_parallel_worker as worker

torch.set_num_threads(1)

MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
IDS = [f"{d}x{m}" for d, m in MESHES]
SR = 16_000


def _with_random_vectors(tree, seed):
    """init_params zeroes biases and sets norms to 1: draw them, so a bias
    or a norm added on the wrong side of an all-reduce shows."""
    rng = np.random.default_rng(seed)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key in ("b", "scale", "bias") and node.ndim <= 2:
            return (node + 0.1 * rng.standard_normal(node.shape)).astype(node.dtype)
        return node

    return walk(tree)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX weights and inputs, written for the ranks, and JAX's unsharded
    results."""
    d = tmp_path_factory.mktemp("parallel")
    cfg = jax_tiny(**worker.SIZE)
    params = _with_random_vectors(
        jax.tree.map(np.asarray, jax_init(cfg, jax.random.PRNGKey(0))), 0)
    np.savez(d / "params.npz", **flatten_params(params))
    save_params(quantize_params(tree_from_numpy(params)), str(d / "int8.safetensors"))
    scfg = jax_tiny(**worker.SERVE_SIZE)
    sparams = _with_random_vectors(
        jax.tree.map(np.asarray, jax_init(scfg, jax.random.PRNGKey(1))), 1)
    np.savez(d / "serve_params.npz", **flatten_params(sparams))

    rng = np.random.default_rng(3)
    mel = rng.standard_normal((4, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    tokens = rng.integers(0, cfg.n_vocab, (4, 5)).astype(np.int64)
    audios = [(0.2 * np.sin(2 * np.pi * (200 + 40 * i) * np.arange(int(SR * s)) / SR)
               + 0.02 * rng.standard_normal(int(SR * s))).astype(np.float32)
              for i, s in enumerate([0.9, 1.2, 0.8, 1.1, 0.7])]
    # a row-parallel linear with LoRA in bf16: values that bf16 holds
    lin = {"x": (4, 3, 128), "w": (128, 96), "b": (96,), "lora_a": (128, 8),
           "lora_b": (8, 96)}
    lin = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
           .bfloat16().float().numpy() for k, shape in lin.items()}
    np.savez(d / "inputs.npz", mel=mel, tokens=tokens,
             **{f"a{i}": a for i, a in enumerate(audios)},
             **{f"lin_{k}": v for k, v in lin.items()})

    jm = JaxModel(cfg=cfg, params=jax.tree.map(np.asarray, params))
    want = {"logits": np.asarray(jm.logits(tokens.astype(np.int32), jm.encode(mel)))}
    for key, x, opts in [
            ("greedy", mel, JaxOptions(language="en", sample_len=12)),
            ("beam", mel[:2], JaxOptions(language="en", sample_len=8, beam_size=2)),
            ("odd", mel[:3], JaxOptions(language="en", sample_len=6))]:
        want[key] = [r.tokens for r in jax_decode(jm, x, opts)]
    want["lang"] = jax_detect(jm, mel[:2])
    want["row_bf16"] = np.asarray(jax_linear(
        jnp.asarray(lin["x"], jnp.bfloat16),
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in lin.items() if k != "x"}
    ).astype(jnp.float32))
    sm = JaxModel(cfg=scfg, params=sparams)
    res = jserve.transcribe_batch(sm, audios, jserve.ServeOptions(
        scheduler="static", batch_size=4, language="en", temperature=(0.0,),
        sample_len=8, no_speech_threshold=None, logprob_threshold=None,
        compression_ratio_threshold=None))
    want["cb"] = [[t for seg in r["segments"] for t in seg["tokens"]] for r in res]
    port = from_jax_params(params, tiny_test_config(**worker.SIZE))
    want["sampled"] = [r.tokens for r in decode(port, mel[:3], DecodingOptions(
        language="en", sample_len=12, temperature=0.9), seed=5)]
    want["best_of"] = [r.tokens for r in decode(port, mel[:3], DecodingOptions(
        language="en", sample_len=8, temperature=0.7, best_of=2), seed=2)]
    sport = from_jax_params(sparams, tiny_test_config(**worker.SERVE_SIZE))
    want["transcribe"] = [s["tokens"] for s in sport.transcribe(
        audios[1], **worker.TRANSCRIBE_KW)["segments"]]
    return {"dir": str(d), "cfg": cfg, "params": params, "want": want}


@pytest.fixture(scope="module", params=MESHES, ids=IDS)
def ranks(request, setup):
    """Every rank's results for one mesh (one spawn per mesh)."""
    n_data, n_model = request.param
    return (n_data, n_model), worker.spawn(n_data * n_model, worker.infer_checks,
                                           n_data, n_model, setup["dir"])


def test_spec_tree_matches_jax():
    cfg = jax_tiny(**worker.SIZE)
    ours = flatten_params(param_pspecs(cfg))
    want = _flat(jax_pspecs(cfg))
    assert set(ours) == set(want)
    for path, spec in want.items():
        assert tuple(ours[path]) == tuple(spec), path


def _jax_shards(setup, mesh_shape, int8):
    n_data, n_model = mesh_shape
    mesh = jax_make_mesh(n_data, n_model, devices=jax.devices()[:n_data * n_model])
    tree = jax_shard(jax.tree.map(np.asarray, setup["params"]), setup["cfg"], mesh)
    if int8:
        tree = jax_quantize(tree)
    return mesh, _flat(tree)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_local_leaves_equal_jax_shards(ranks, setup, int8):
    """Rank (d, m)'s leaves are JAX's addressable shards on device (d, m):
    q/k/v/fc1 and the conv stem cut by output columns, out/fc2 by input
    rows, the int8 scales following their weights."""
    mesh_shape, results = ranks
    mesh, leaves = _jax_shards(setup, mesh_shape, int8)
    for r, res in enumerate(results):
        device = mesh.devices[r // mesh_shape[1], r % mesh_shape[1]]
        got = res["leaves_int8" if int8 else "leaves"]
        assert set(got) == {k for k in leaves if not k.endswith("_embedding")}
        for path, got_leaf in got.items():
            (shard,) = [s for s in leaves[path].addressable_shards
                        if s.device == device]
            np.testing.assert_array_equal(got_leaf, np.asarray(shard.data),
                                          err_msg=path)


def test_model_axis_of_one_keeps_the_plain_model(ranks):
    """A data-parallel mesh (model axis of one rank) builds the plain
    linears and convs, and no mesh issues a collective over one rank."""
    (_, n_model), results = ranks
    for res in results:
        if n_model == 1:
            assert res["layout"] == {"parallel_linears": 0, "sharded_convs": 0}
        else:
            assert res["layout"]["parallel_linears"] > 0
            assert res["layout"]["sharded_convs"] == 2
        assert res["one_rank_reduces"] == 0


def test_row_parallel_bf16_sums_fp32_partials_as_jax(ranks, setup):
    """A bf16 row-parallel linear with LoRA equals JAX's `linear` on the
    whole weight: the partial products and LoRA's partial bottleneck are
    summed in fp32 and rounded once, as GSPMD sums JAX's fp32 partials
    (bf16 partials would round each rank's share first)."""
    (_, n_model), results = ranks
    for res in results:
        if n_model == 1:  # the plain Linear: no partials
            assert "row_bf16" not in res
        else:
            np.testing.assert_array_equal(res["row_bf16"], setup["want"]["row_bf16"])


def test_logits_match_jax_unsharded(ranks, setup):
    for res in ranks[1]:
        np.testing.assert_allclose(res["logits"], setup["want"]["logits"], atol=1e-3)


@pytest.mark.parametrize("key", ["greedy", "beam", "odd"])
def test_decode_token_exact_against_jax(ranks, setup, key):
    """Greedy, beam 2, and a batch of 3 padded to the data axis."""
    for res in ranks[1]:
        assert res[key] == setup["want"][key]


def test_language_detection_matches_jax(ranks, setup):
    codes, probs = setup["want"]["lang"]
    for res in ranks[1]:
        assert res["lang"][0] == codes
        for pr, ps in zip(probs, res["lang"][1]):
            top = max(pr, key=pr.get)
            np.testing.assert_allclose(ps[top], pr[top], atol=1e-3)


@pytest.mark.parametrize("key", ["sampled", "best_of"])
def test_sampled_decode_seed_exact_against_one_process(ranks, setup, key):
    """The sampler keys noise by the row's place in the whole batch, so a
    sampled decode split over data ranks draws the one-process draws."""
    for res in ranks[1]:
        assert res[key] == setup["want"][key]


def test_speculative_greedy_equals_plain(ranks):
    """Self-drafted greedy speculative tokens equal the plain loop's under
    the mesh; a draft off the target's mesh is refused."""
    for res in ranks[1]:
        assert res["spec"] == res["greedy"]
        assert "mesh" in res["errors"]["draft_off_mesh"]


def test_mesh_refusals(ranks):
    """Heads the model axis does not divide, and a pre-quantized checkpoint
    with a mesh, raise (JAX's checks). Word timestamps, the two stream
    classes and the HTTP server run under a mesh
    (test_torch_parallel_{words,stream,serve_http}.py)."""
    (_, n_model), results = ranks
    for res in results:
        errors = res["errors"]
        assert "pre-quantized" in errors["prequantized"]
        if n_model > 1:
            assert "must divide attention heads" in errors["heads"]
        else:
            assert "heads" not in errors


def test_long_form_transcribe_equals_one_process(ranks, setup):
    """transcribe() under the mesh (a batch of one window, padded to the
    data axis) gives the one-process port's segments."""
    for res in ranks[1]:
        assert res["transcribe"] == setup["want"]["transcribe"]


def test_continuous_batching_matches_jax_static(ranks, setup):
    """transcribe_batch under the continuous scheduler on the mesh (requests
    split over the data groups) equals JAX's unsharded static scheduler."""
    for res in ranks[1]:
        assert res["cb"] == setup["want"]["cb"]


def test_unsharded_model_has_no_process_group_and_plain_linears(monkeypatch):
    """mesh=None is the one-card model: no process group is made, every
    linear is the plain Linear, and a decode issues no collective."""
    import torch.distributed as dist

    from openai_whisper_coreml_tpu_torch.models.layers import Linear
    from openai_whisper_coreml_tpu_torch.models.whisper import build_model

    def refuse(*a, **k):
        raise AssertionError("a collective without a mesh")

    monkeypatch.setattr(dist, "all_reduce", refuse)
    monkeypatch.setattr(dist, "all_gather_object", refuse)
    model = build_model(tiny_test_config(**worker.SIZE), device="cpu")
    assert model.mesh is None and model.decoder.axis is None
    assert not dist.is_initialized()
    linears = [m for m in model.modules() if isinstance(m, Linear)]
    assert linears and all(type(m) is Linear for m in linears)
    assert all(m.axis is None for m in (model.encoder.conv1, model.encoder.conv2))
    mel = torch.randn(2, 80, 128)
    res = decode(model, mel, DecodingOptions(language="en", sample_len=4))
    assert len(res) == 2 and not dist.is_initialized()


_LAUNCH_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
               "MASTER_PORT", "NUM_PROCESSES", "PROCESS_ID", "COORDINATOR_ADDRESS")


def test_one_process_needs_no_process_group(monkeypatch):
    """Outside a launch, initialize_distributed is a no-op, the data slice
    is the whole batch, and make_mesh refuses to run without the group."""
    import torch.distributed as dist

    from openai_whisper_coreml_tpu_torch.parallel import (initialize_distributed,
                                                           local_batch_slice,
                                                           make_mesh)
    from openai_whisper_coreml_tpu_torch.parallel.distributed import launched_ranks

    for name in _LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    initialize_distributed()
    assert not dist.is_initialized() and launched_ranks() == 1
    assert local_batch_slice(6) == slice(0, 6)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh(n_model=2)


def test_initialize_distributed_refuses_a_launch_without_rank_or_rendezvous(monkeypatch):
    from openai_whisper_coreml_tpu_torch.parallel import initialize_distributed

    for name in _LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="no rank"):
        initialize_distributed()
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="no rendezvous"):
        initialize_distributed()


@pytest.mark.parametrize("cards,local,want", [(0, 2, "gloo"), (1, 1, "nccl"),
                                               (1, 2, "gloo"), (4, 4, "nccl"),
                                               (4, 8, "gloo")])
def test_backend_follows_the_topology(monkeypatch, cards, local, want):
    """NCCL only when each local rank has a card of its own: ranks sharing
    a card (NCCL refuses them) and the CPU take gloo."""
    from openai_whisper_coreml_tpu_torch.parallel.distributed import choose_backend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert choose_backend(local) == want
