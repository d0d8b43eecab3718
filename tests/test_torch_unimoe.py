"""The audio language model (`models/audio_lm.py`, `models/moe.py`,
`lm_decoding.py`) on the CPU at a tiny size, against the plain reference
(`tests/unimoe_reference.py`, a copy of `portbench/reference/unimoe.py`):
the top-p router, the MoE layer in fp32 and at int8 and split over the
experts it holds, `answer` on clips of unequal lengths, prefill and cached
steps, the counters, the spans, and the weights made and quantized one
layer at a time."""

import ast
import dataclasses
import gc
import glob
import json
import os
import weakref
from pathlib import Path

import pytest
import torch

from openai_whisper_coreml_tpu_torch.config import UNIMOE_CONFIGS, tiny_unimoe_config
from openai_whisper_coreml_tpu_torch.lm_decoding import answer, generate
from openai_whisper_coreml_tpu_torch.models import moe as moe_mod
from openai_whisper_coreml_tpu_torch.models.audio_lm import (DecoderLayer, init_params,
                                                             model_from_params, quantize_layer)
from openai_whisper_coreml_tpu_torch.models.layers import RMSNorm, rms_norm
from openai_whisper_coreml_tpu_torch.utils import profiling

from . import unimoe_reference as ref

torch.set_num_threads(1)

CFG = tiny_unimoe_config()
C = dataclasses.asdict(CFG)
SPANS = ("connector", "rms_norm", "attention", "moe", "moe.router", "moe.permute",
         "moe.experts", "moe.shared", "moe.combine", "lm_head")
# clips of unequal text lengths around the 20 audio tokens
PROMPTS = [([5, 6, 7], [8, 9]), ([11], [12, 13, 14, 15, 16, 17, 18]), ([21, 22], [23])]
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=3)


@pytest.fixture(scope="module")
def mel():
    return torch.randn(len(PROMPTS), CFG.n_mels, 3000, generator=torch.Generator().manual_seed(1))


@pytest.fixture(scope="module")
def model(params):
    return model_from_params(CFG, params)


@pytest.fixture(scope="module")
def model8(params):
    return model_from_params(CFG, params, quantize="int8", min_quant_size=1)


# -- the router ------------------------------------------------------------------------

def _route(rows):
    return moe_mod.route(torch.tensor(rows), CFG.top_p, CFG.top_k, CFG.n_experts)


@pytest.mark.parametrize("top, expert", [(0.7, 1), (0.9, 3), (0.71, 0)])
def test_one_expert_when_the_top_reaches_top_p(top, expert):
    p = [(1 - top) / 4] * 5
    p[expert] = top
    ids, w, null = _route([p])
    assert ids.tolist() == [[expert, -1]] and w[0, 0] == top and not null.any()


def test_at_most_top_k_experts():
    ids, w, _ = _route([[0.3, 0.25, 0.2, 0.15, 0.1]])
    assert ids.tolist() == [[0, 1]]
    assert torch.equal(w, torch.tensor([[0.3, 0.25]]))


@pytest.mark.parametrize("probs, want_ids, want_null", [
    ([0.1, 0.05, 0.02, 0.03, 0.8], [-1, -1], [True, False]),  # null alone
    ([0.4, 0.05, 0.05, 0.1, 0.4], [0, -1], [False, True]),  # expert then null (stable ties)
    ([0.05, 0.3, 0.05, 0.05, 0.55], [-1, 1], [True, False]),  # null then expert
])
def test_a_null_pick_takes_a_slot_and_adds_nothing(probs, want_ids, want_null):
    ids, w, null = _route([probs])
    assert ids.tolist() == [want_ids] and null.tolist() == [want_null]
    assert torch.all(w[ids < 0] == 0)


def test_a_null_pick_adds_nothing_to_the_layer(params):
    """Rows that pick only the null expert get the shared experts' sum."""
    lp = params["layers"][0]
    layer = moe_mod.MoE(lp, CFG, torch.float32)
    with torch.no_grad():
        layer.router.zero_()
        layer.router[:, CFG.n_experts] = 50.0  # every row to the null expert
        x = torch.randn(6, CFG.hidden).abs() + 0.1
        y, routes = layer(x)
        shared = sum(s(x) for s in layer.shared)
    assert (routes == -1).all()
    torch.testing.assert_close(y, shared, rtol=0, atol=0)


# -- the MoE layer ---------------------------------------------------------------------

def _moe_inputs(params, i=1, n=40):
    gen = torch.Generator().manual_seed(7 + i)
    return params["layers"][i], torch.randn(n, CFG.hidden, generator=gen)


@pytest.mark.parametrize("bits", [None, 8])
def test_moe_layer_agrees_with_the_reference(params, bits):
    lp, x = _moe_inputs(params)
    tree = lp if bits is None else quantize_layer(lp, min_size=1)
    if bits is not None:
        assert tree["experts"]["gate_up"]["w_q"].dtype == torch.int8
        assert tree["router"]["w"].dtype == torch.float32
    layer = moe_mod.MoE(tree, CFG, torch.float32)
    with torch.no_grad():
        y, routes = layer(x)
    want = ref.moe(x, ref.cast(lp, 8, 1 if bits else 1 << 62), C)
    assert torch.equal(ref.route_mask(routes), want["pick"])
    torch.testing.assert_close(y, want["y"], rtol=1e-5, atol=1e-5)


def test_routes_given_to_the_reference_replace_its_pick(params):
    lp, x = _moe_inputs(params)
    cast = ref.cast(lp, 8, 1 << 62)
    forced = torch.full((x.shape[0], CFG.top_k), -1, dtype=torch.int8)
    forced[:, 0] = 2
    got = ref.moe(x, cast, C, forced)
    probs = torch.softmax(x @ cast["router"]["w"], dim=-1)
    shared = ref.moe(x, cast, C, torch.full_like(forced, -1))["y"]
    e = cast["experts"]
    want = shared + probs[:, 2:3] * ref._swiglu(x, e["gate_up"]["w"][2], e["down"]["w"][2])
    torch.testing.assert_close(got["y"], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("split", [((0, 1), (2, 3)), ((0,), (1, 2, 3)), ((3,), (0, 2), (1,))])
def test_held_experts_add_up_to_the_whole_layer(params, split):
    """Layers that each hold some of the experts route over all of them;
    their parts, with the shared experts counted once, add up to the
    layer that holds every expert."""
    lp, x = _moe_inputs(params)
    with torch.no_grad():
        whole, routes = moe_mod.MoE(lp, CFG, torch.float32)(x)
        shared = sum(s(x) for s in moe_mod.MoE(lp, CFG, torch.float32).shared)
        parts = []
        for held in split:
            y, r = moe_mod.MoE(lp, CFG, torch.float32, held=held)(x)
            assert torch.equal(r, routes)
            parts.append(y - shared)
    torch.testing.assert_close(sum(parts) + shared, whole, rtol=1e-5, atol=1e-5)


# -- answer ----------------------------------------------------------------------------

def _reference(params, mel, prompts, routes=None, tail=1, bits=8, min_size=1 << 62):
    r = ref.Reference(params, C, weight_bits=bits, min_quant_size=min_size)
    return r.forward(list(mel), prompts, routes=routes, tail=tail)


def test_answer_agrees_with_the_reference_in_fp32(model, params, mel):
    lp, routes = answer(model, mel, PROMPTS, routes=True)
    assert lp.shape == (len(PROMPTS), CFG.n_vocab) and lp.dtype == torch.float32
    want = _reference(params, mel, PROMPTS, routes)
    for b in range(len(PROMPTS)):
        torch.testing.assert_close(lp[b], want["logprobs"][b][0], rtol=0, atol=2e-5)
    bad, seen, widest = ref.route_mismatch(routes, want["pick"], want["margin"], 1e-4)
    assert bad == 0 and seen > 0.9 * CFG.n_layer * sum(r.shape[1] for r in routes)
    assert widest <= 1e-4


def test_answer_at_int8_agrees_with_the_reference_and_not_the_control(model8, params, mel):
    lp, routes = answer(model8, mel, PROMPTS, routes=True)
    want = _reference(params, mel, PROMPTS, routes, min_size=1)
    ctl = _reference(params, mel, PROMPTS, routes, bits=4, min_size=1)
    for b in range(len(PROMPTS)):
        assert (lp[b] - want["logprobs"][b][0]).abs().max() < 2e-5
        assert (ctl["logprobs"][b][0] - want["logprobs"][b][0]).abs().max() > 1e-2


@pytest.mark.parametrize("b", range(len(PROMPTS)))
def test_each_clip_of_a_call_equals_its_own_unpadded_call(model, mel, b):
    together, routes = answer(model, mel, PROMPTS, routes=True)
    alone, own = answer(model, mel[b:b + 1], PROMPTS[b:b + 1], routes=True)
    torch.testing.assert_close(together[b], alone[0], rtol=0, atol=2e-5)
    assert routes[b].shape == (CFG.n_layer, 25 if b == 0 else sum(map(len, PROMPTS[b])) + 20,
                               CFG.top_k)
    assert torch.equal(routes[b], own[0])


def test_answer_refuses_a_prompt_count_that_is_not_the_batch(model, mel):
    with pytest.raises(ValueError, match="prompts"):
        answer(model, mel, PROMPTS[:2])


# -- generate --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def generated(model, mel):
    return generate(model, mel, PROMPTS, 9, logprobs=True, routes=True)


def test_cached_steps_agree_with_the_references_full_forward(generated, params, mel):
    """Prefill and 8 cached steps: each pick's log-probabilities against the
    reference's one teacher-forced forward over the grown sequence, under
    the program's routes."""
    g = generated
    grown = [(a, list(b) + g.tokens[i, :-1].tolist()) for i, (a, b) in enumerate(PROMPTS)]
    want = _reference(params, mel, grown, g.routes, tail=9)
    for b in range(len(PROMPTS)):
        torch.testing.assert_close(g.logprobs[:, b], want["logprobs"][b], rtol=0, atol=2e-5)
        assert torch.equal(g.tokens[b], g.logprobs[:, b].argmax(dim=-1))


@pytest.mark.parametrize("step", [1, 4, 8])
def test_cached_step_equals_answer_over_the_grown_prompt(generated, model, mel, step):
    g = generated
    grown = [(a, list(b) + g.tokens[i, :step].tolist()) for i, (a, b) in enumerate(PROMPTS)]
    lp, routes = answer(model, mel, grown, routes=True)
    torch.testing.assert_close(g.logprobs[step], lp, rtol=0, atol=2e-5)
    for b in range(len(PROMPTS)):
        assert torch.equal(g.routes[b][:, :routes[b].shape[1]], routes[b])


# -- counters and spans ----------------------------------------------------------------

def test_counters_count_what_the_reference_picks(model, params, mel):
    moe_mod.reset_counters()
    lp, routes = answer(model, mel, PROMPTS, routes=True)
    got = moe_mod.read_counters()
    want = _reference(params, mel, PROMPTS, routes)
    picks = torch.cat(want["pick"], dim=1)  # (n_layer, all tokens)
    n = sum(r.shape[1] for r in routes)
    per_expert = torch.stack([(picks >> e) & 1 for e in range(CFG.n_experts)]).sum(dim=2)
    assert got["tokens"] == CFG.n_layer * n
    assert got["rows_routed"] == int(per_expert.sum())
    assert got["null_picks"] == int(torch.cat(want["nulls"], dim=1).sum())
    assert got["max_expert_rows"] == int(per_expert.max())
    assert got["unfused_rows"] == got["rows_routed"]  # the CPU takes no fused kernel
    assert got["unfused_tokens"] == got["tokens"]
    assert sum(int((r >= 0).sum()) for r in routes) == got["rows_routed"]


def _span_names(logdir):
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        return {e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"}


def test_spans_name_each_part_of_a_call(model8, mel, tmp_path):
    with profiling.device_trace(str(tmp_path)):
        answer(model8, mel[:2], PROMPTS[:2])
    names = _span_names(str(tmp_path))
    assert set(SPANS) <= names
    assert {"encoder", "linear.epilogue", "layer_norm"} <= names


def test_spans_off_leave_the_result_unchanged(model8, mel):
    off = answer(model8, mel[:1], PROMPTS[:1])
    with profiling.spans_on():
        on = answer(model8, mel[:1], PROMPTS[:1])
    assert torch.equal(off, on)


# -- weights ---------------------------------------------------------------------------

class _Watched:
    """A layer sequence that records, at each read, how many of the float
    layer trees it handed out before are still alive."""

    def __init__(self, layers):
        self.layers, self.refs, self.alive_at_read = layers, [], []

    def __len__(self):
        return len(self.layers)

    def __getitem__(self, i):
        gc.collect()
        self.alive_at_read.append(sum(r() is not None for r in self.refs))
        p = self.layers[i]
        self.refs.append(weakref.ref(p["experts"]["gate_up"]["w"]))
        return p


def test_layers_are_made_and_quantized_one_at_a_time(params):
    watched = _Watched(params["layers"])
    model = model_from_params(CFG, dict(params, layers=watched), quantize="int8",
                              min_quant_size=1)
    assert watched.alive_at_read == [0] * CFG.n_layer
    blk = model.blocks[0]
    assert blk.moe.experts[0].gate_up.w_q.dtype == torch.int8
    assert blk.moe.router.dtype == torch.float32
    assert model.head.w_q.dtype == torch.int8 and model.connector.w_q.dtype == torch.int8


def test_seeded_layers_are_made_again_alike(params):
    a, b = params["layers"][1], params["layers"][1]
    assert torch.equal(a["experts"]["down"]["w"], b["experts"]["down"]["w"])
    assert not torch.equal(params["layers"][0]["attn"]["q"]["w"], a["attn"]["q"]["w"])


def test_rms_norm_against_the_reference():
    x = torch.randn(5, CFG.hidden)
    p = {"scale": torch.randn(CFG.hidden)}
    got = rms_norm(x, RMSNorm(p, 1e-6))
    torch.testing.assert_close(got, ref._rms(x, p, 1e-6), rtol=1e-6, atol=1e-6)


def test_a_decoder_layer_is_built_from_one_layer_tree(params):
    layer = DecoderLayer(params["layers"][0], CFG, torch.float32)
    width = (CFG.n_head + 2 * CFG.n_kv_head) * CFG.head_dim
    assert layer.attn.qkv.w.shape == (CFG.hidden, width) and layer.attn.qkv.b.shape == (width,)
    assert len(layer.moe.experts) == CFG.n_experts and len(layer.moe.shared) == CFG.n_shared


def test_the_published_configuration():
    cfg = UNIMOE_CONFIGS["uni-moe-2.0-omni"]
    cfg.validate()
    assert (cfg.hidden, cfg.n_layer, cfg.n_head, cfg.n_kv_head, cfg.head_dim) == \
        (3584, 28, 28, 4, 128)
    assert (cfg.n_experts, cfg.n_null_experts, cfg.expert_ffn, cfg.n_shared,
            cfg.shared_ffn) == (4, 1, 18944, 2, 2368)
    assert cfg.encoder_config.n_audio_state == 1280 and cfg.n_mels == 128


# -- the reference ---------------------------------------------------------------------

def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0] if node.level == 0 else ".")
    return names


@pytest.mark.parametrize("path", [ROOT / "tests" / "unimoe_reference.py",
                                  ROOT / "portbench" / "reference" / "unimoe.py"],
                         ids=["tests", "portbench"])
def test_the_reference_imports_plain_torch_only(path):
    assert _imports(path) <= {"__future__", "math", "typing", "torch"}


def test_the_two_copies_of_the_reference_are_one():
    assert ((ROOT / "tests" / "unimoe_reference.py").read_text()
            == (ROOT / "portbench" / "reference" / "unimoe.py").read_text())
