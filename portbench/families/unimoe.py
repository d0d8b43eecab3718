"""The Uni-MoE family: an audio language model on the Whisper encoder with
a MoE decoder (the port's `models/audio_lm.AudioLM` through
`lm_decoding.answer`), its seeded weights, and the judge over the plain
reference (`reference/unimoe.py`).

Weights: one checkpoint for every run, made from the configuration's
`weights_seed`, not from `--seed` (which draws the inputs): the router
sets the work, and random weights route nearly all of a layer's tokens
alike, so a checkpoint drawn per run made each run's work its own (six
seeds read 1.19-1.45 routed experts a token and `langid_rtfx` spread 5.2
%). One `torch.randn` over a flat buffer on the card for each part (the
encoder, the connector, the embedding, the final norm and head, and each
decoder layer), each from its own generator seeded from `weights_seed`
and the part, so any part is made alone and again. `make_params` makes the
encoder, connector, embedding, norm and head at once and hands the
decoder's layers as a sequence that makes each layer when it is read: the
port builds and quantizes one layer before it reads the next, and the
reference casts one layer at a time, so neither holds the bf16 tree. The
kinds and scales follow `lib/weights.py` (fan-in scaled weights, biases at
0.02, norm scales at 1 + 0.02 x), with the router at twice fan-in scale
(the configuration's `assumed.router_scale`).

The judge reads "answers" (`traffic/audio_prompt_batches.py`): the clips
drawn from the seed, each with its audio, prompt, the program's
log-probabilities at its last position and its routes. The reference runs
each clip under the program's routes and gives `answer_gap`, the largest
absolute difference of the log-probabilities over the whole vocabulary,
and `route_mismatch`, the share of (layer, token) decisions, among those
whose margin in the reference is above `check.margin`, at which the
program's routed set differs from the reference's own pick. `missing`
is the clips without an answer. With `control`, `control_gap`: the 4-bit
reference's gap from the 8-bit one under the same routes."""

from __future__ import annotations

import math
import sys
from collections import abc
from typing import Dict, List

import torch

from portbench.lib.weights import Leaf

# (configuration key, dims name)
SIZES = (("whisper_num_mel_bins", "n_mels"), ("whisper_max_source_positions", "n_audio_ctx"),
         ("whisper_hidden_size", "n_audio_state"),
         ("whisper_encoder_attention_heads", "n_audio_head"),
         ("whisper_encoder_layers", "n_audio_layer"), ("whisper_encoder_ffn_dim", "n_ffn"),
         ("whisper_query_tokens_size", "audio_tokens"), ("hidden_size", "hidden"),
         ("num_hidden_layers", "n_layer"), ("num_attention_heads", "n_head"),
         ("num_key_value_heads", "n_kv_head"), ("vocab_size", "n_vocab"),
         ("mlp_dynamic_expert_num", "n_experts"), ("mlp_dynamic_null_expert_num", "n_null_experts"),
         ("dynamic_intermediate_size", "expert_ffn"), ("mlp_dynamic_top_p", "top_p"),
         ("mlp_dynamic_top_k", "top_k"), ("mlp_fixed_expert_num", "n_shared"),
         ("shared_intermediate_size", "shared_ffn"), ("rms_norm_eps", "rms_eps"),
         ("rope_theta", "rope_theta"))


def dims(config: dict) -> Dict[str, float]:
    """The sizes of a configuration file, under `config.UniMoEConfig`'s
    names (the reference's too), with the encoder's MLP width."""
    if config["mlp_dynamic_top_k"] < 1 or config["use_sliding_window"]:
        raise ValueError("the port's audio LM routes to at least one expert, over full "
                         "causal attention")
    return dict({name: config[key] for key, name in SIZES}, weights_seed=config["weights_seed"])


def program_config(config: dict, d: dict):
    from openai_whisper_coreml_tpu_torch.config import UniMoEConfig

    if d["n_ffn"] != 4 * d["n_audio_state"]:
        raise ValueError("the port's encoder MLP is 4 x its width")
    return UniMoEConfig(name=config["name"],
                        **{k: v for k, v in d.items() if k not in ("n_ffn", "weights_seed")})


def _encoder_leaves(d) -> List[Leaf]:
    from portbench.lib.weights import _attn, _ln, _mlp

    n, la = d["n_audio_state"], d["n_audio_layer"]
    enc, eb = ("encoder",), ("encoder", "blocks")
    return [(enc + ("conv1", "w"), (3, d["n_mels"], n), "w", 3 * d["n_mels"]),
            (enc + ("conv1", "b"), (n,), "b", 0),
            (enc + ("conv2", "w"), (3, n, n), "w", 3 * n), (enc + ("conv2", "b"), (n,), "b", 0),
            *_attn(eb + ("attn",), la, n), *_ln(eb + ("attn_ln",), la, n),
            *_mlp(eb + ("mlp",), la, n, d["n_ffn"]), *_ln(eb + ("mlp_ln",), la, n),
            *_ln(enc + ("ln_post",), n)]


def _top_leaves(d) -> List[Leaf]:
    h, v = d["hidden"], d["n_vocab"]
    return [(("connector", "w"), (d["n_audio_state"], h), "w", d["n_audio_state"]),
            (("connector", "b"), (h,), "b", 0), (("embed",), (v, h), "w", h),
            (("norm", "scale"), (h,), "s", 0), (("head", "w"), (h, v), "w", h)]


def _layer_leaves(d) -> List[Leaf]:
    h, nq = d["hidden"], d["n_head"] * (d["hidden"] // d["n_head"])
    nk = d["n_kv_head"] * (d["hidden"] // d["n_head"])

    def swiglu(prefix, n, f):
        return [((prefix, "gate_up", "w"), (n, h, 2 * f), "w", h),
                ((prefix, "down", "w"), (n, f, h), "w", f)]

    return [(("attn_norm", "scale"), (h,), "s", 0),
            (("attn", "q", "w"), (h, nq), "w", h), (("attn", "q", "b"), (nq,), "b", 0),
            (("attn", "k", "w"), (h, nk), "w", h), (("attn", "k", "b"), (nk,), "b", 0),
            (("attn", "v", "w"), (h, nk), "w", h), (("attn", "v", "b"), (nk,), "b", 0),
            (("attn", "o", "w"), (nq, h), "w", nq), (("moe_norm", "scale"), (h,), "s", 0),
            (("router", "w"), (h, d["n_experts"] + d["n_null_experts"]), "r", h),
            *swiglu("experts", d["n_experts"], d["expert_ffn"]),
            *swiglu("shared", d["n_shared"], d["shared_ffn"])]


def _make(spec: List[Leaf], seed: int, part: int, device, dtype) -> dict:
    """The tree of `spec` from the generator of (seed, part)."""
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    gen = torch.Generator(device=device).manual_seed((seed * 1031 + 7 * part + 1) % (1 << 63))
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    tree: dict = {}
    off = 0
    for path, shape, kind, fan_in in spec:
        x = flat[off:off + math.prod(shape)].view(shape)
        off += x.numel()
        if kind in ("w", "r"):
            x = x * ((2.0 if kind == "r" else 1.0) / math.sqrt(fan_in))
        elif kind == "b":
            x = x * 0.02
        elif kind == "s":
            x = x * 0.02 + 1.0
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x
    return tree


class Layers(abc.Sequence):
    """The decoder's layers, each made from the seed when it is read."""

    def __init__(self, d, seed, device, dtype):
        self.d, self.seed, self.device, self.dtype = d, seed, device, dtype

    def __len__(self) -> int:
        return self.d["n_layer"]

    def __getitem__(self, i: int) -> dict:
        if not 0 <= i < len(self):
            raise IndexError(i)
        return _make(_layer_leaves(self.d), self.seed, 2 + i, self.device, self.dtype)


def make_params(d: dict, seed: int, device, dtype) -> dict:
    """The checkpoint of `d["weights_seed"]`, whatever the run's `seed`."""
    seed = d["weights_seed"]
    tree = _make(_encoder_leaves(d), seed, 0, device, dtype)
    tree.update(_make(_top_leaves(d), seed, 1, device, dtype))
    tree["layers"] = Layers(d, seed, device, dtype)
    return tree


def program(config: dict, d: dict, params: dict):
    """The port's audio LM of those weights, quantized by the port as the
    configuration's `dtypes.weights` says, one layer at a time."""
    from openai_whisper_coreml_tpu_torch.models.audio_lm import model_from_params

    model = model_from_params(program_config(config, d), params,
                              quantize=config["dtypes"]["weights"])
    if model.device.type == "cuda":
        print(f"[{config['name']}] weights made and quantized layer by layer: device memory "
              f"peak {torch.cuda.max_memory_allocated(model.device)} bytes, held "
              f"{torch.cuda.memory_allocated(model.device)}", file=sys.stderr, flush=True)
    return model


def clip_gaps(ref, answers: List[dict], d: dict, device, margin: float,
              control=None) -> Dict[str, float]:
    """`answer_gap`, the route comparison and (with a control) `control_gap`
    over the drawn clips, each clip's log-mel made from its own audio."""
    from portbench.reference import model as refm
    from portbench.reference import unimoe as refu

    out = {"answer_gap": 0.0, "mismatched": 0, "decisions": 0, "widest": 0.0}
    if control is not None:
        out["control_gap"] = 0.0
    for a in answers:
        mel = refm.log_mel(torch.as_tensor(a["audio"], device=device), d["n_mels"])
        routes = [torch.as_tensor(a["routes"])]
        got = ref.forward([mel], [a["prompt"]], routes=routes)
        want = got["logprobs"][0][0]
        program_lp = torch.as_tensor(a["logprobs"], device=device).float()
        out["answer_gap"] = max(out["answer_gap"], float((program_lp - want).abs().max()))
        bad, seen, widest = refu.route_mismatch(routes, got["pick"], got["margin"], margin)
        out["mismatched"] += bad
        out["decisions"] += seen
        out["widest"] = max(out["widest"], widest)
        if control is not None:
            c = control.forward([mel], [a["prompt"]], routes=routes)["logprobs"][0][0]
            out["control_gap"] = max(out["control_gap"], float((c - want).abs().max()))
    return out


def judge(ctx, out, dtype, control: bool = False) -> dict:
    """The numbers compared, each {"value", "limit"}, after the program is
    freed: the reference reads the same seeded weights, made again."""
    from portbench.reference import unimoe as refu

    d, cell = ctx.dims, ctx.cell
    refu.exact_float32()
    params = make_params(d, ctx.seed, ctx.device, dtype)
    ref = refu.Reference(params, d, weight_bits=8)
    ctl = refu.Reference(params, d, weight_bits=4) if control else None
    with torch.no_grad():
        gaps = clip_gaps(ref, out.answers, d, ctx.device, cell["check"]["margin"], ctl)
    ctx.log(f"compared {len(out.answers)} clips: {gaps['mismatched']} of "
            f"{gaps['decisions']} sure routing decisions differ; the widest margin of a "
            f"decision that differs: {gaps['widest']:.6f} (check.margin "
            f"{cell['check']['margin']})")
    numbers = {"missing": out.failed, "answer_gap": gaps["answer_gap"],
               "route_mismatch": gaps["mismatched"] / max(1, gaps["decisions"])}
    checks = {k: {"value": numbers[k], "limit": v} for k, v in cell["check"]["limits"].items()}
    if control:
        checks["control_gap"] = {"value": gaps["control_gap"], "limit": None}
    return checks
