"""Parameter trees: random initialisation, conversion from the public
checkpoint layouts, the JAX pytree both ways, and JAX paths for the
model's parameters.

The port keeps the JAX package's parameter layout as its interchange format
(`openai_whisper_coreml_tpu/params.py`): a nested dict whose per-layer
weights are stacked on axis 0, linear weights stored (in, out), conv
weights (kernel, C_in, C_out). `models.whisper.WhisperModel` turns such a
tree into `nn.Module`s (one per layer; conv weights become PyTorch's
(C_out, C_in, kernel) there), so a tree made here, quantised by
`quantize.quantize_params`, given LoRA adapters by `lora.add_lora`, loaded
from a checkpoint or converted from the JAX package, all load the same
way. `params_tree` / `to_jax_params` go back: they restack the layers and
give the conv weights back in JAX's order, so checkpoints, `merge_lora`
and the tests read what the optimizer wrote into the modules.

Every module parameter has a JAX path (`jax_path`): the parameter's name
with the layer index dropped and "/" for ".", e.g.
`decoder.blocks.3.attn.q.w` -> `decoder/blocks/attn/q/w`. Training matches
its `trainable` pattern against these paths, as JAX does.

`params_from_openai_state_dict` and `params_from_hf_state_dict` turn an
openai/whisper `.pt` state dict (`encoder.blocks.0.attn.query.weight`) or
a HuggingFace `WhisperForConditionalGeneration` one
(`model.encoder.layers.0.self_attn.q_proj.weight`) into that tree, as the
JAX package's converters do (`convert.py` runs them).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .config import WhisperConfig

Params = Dict[str, Any]


def init_params(cfg: WhisperConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str | None = None) -> Params:
    """Random-normal init with fan-in scaling, on `device`.

    Same tree, shapes and scaling as the JAX `init_params` (the numbers
    differ: torch and JAX draw different streams from one seed). The
    generator must live on `device`.
    """
    n = cfg.n_audio_state
    nt = cfg.n_text_state
    kw = dict(dtype=dtype, device=device)

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device)

    def dense(fan_in, shape):
        return (normal(shape) / math.sqrt(fan_in)).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, **kw)

    def attn_block(nl, width):
        return {
            "q": {"w": dense(width, (nl, width, width)), "b": zeros(nl, width)},
            "k": {"w": dense(width, (nl, width, width))},  # no bias (openai)
            "v": {"w": dense(width, (nl, width, width)), "b": zeros(nl, width)},
            "out": {"w": dense(width, (nl, width, width)), "b": zeros(nl, width)},
        }

    def ln(*shape):
        return {"scale": torch.ones(shape, **kw), "bias": zeros(*shape)}

    def mlp_block(nl, width):
        return {
            "fc1": {"w": dense(width, (nl, width, 4 * width)),
                    "b": zeros(nl, 4 * width)},
            "fc2": {"w": dense(4 * width, (nl, 4 * width, width)),
                    "b": zeros(nl, width)},
        }

    la, lt = cfg.n_audio_layer, cfg.n_text_layer
    return {
        "encoder": {
            "conv1": {"w": dense(3 * cfg.n_mels, (3, cfg.n_mels, n)),
                      "b": zeros(n)},
            "conv2": {"w": dense(3 * n, (3, n, n)), "b": zeros(n)},
            "blocks": {"attn": attn_block(la, n), "attn_ln": ln(la, n),
                       "mlp": mlp_block(la, n), "mlp_ln": ln(la, n)},
            "ln_post": ln(n),
        },
        "decoder": {
            "token_embedding": dense(nt, (cfg.n_vocab, nt)),
            "positional_embedding": (0.01 * normal((cfg.n_text_ctx, nt))).to(dtype),
            "blocks": {"attn": attn_block(lt, nt), "attn_ln": ln(lt, nt),
                       "cross_attn": attn_block(lt, nt),
                       "cross_attn_ln": ln(lt, nt),
                       "mlp": mlp_block(lt, nt), "mlp_ln": ln(lt, nt)},
            "ln": ln(nt),
        },
    }


def _t(x) -> torch.Tensor:
    """A state-dict value (tensor or numpy, any float type) as fp32 on the
    CPU."""
    return torch.as_tensor(x).detach().cpu().float()


def _linear(sd: Mapping[str, Any], prefix: str, bias: bool = True) -> Params:
    out = {"w": _t(sd[f"{prefix}.weight"]).T}  # torch stores (out, in)
    if bias:
        out["b"] = _t(sd[f"{prefix}.bias"])
    return out


def _ln(sd: Mapping[str, Any], prefix: str) -> Params:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _conv(sd: Mapping[str, Any], prefix: str) -> Params:
    # (out, in, kernel) in both public layouts -> (kernel, in, out)
    return {"w": _t(sd[f"{prefix}.weight"]).permute(2, 1, 0),
            "b": _t(sd[f"{prefix}.bias"])}


def _stack_layers(layers: list) -> Params:
    """Per-layer trees -> one tree with a leading layer axis."""
    return {k: (_stack_layers([layer[k] for layer in layers])
                if isinstance(layers[0][k], Mapping)
                else torch.stack([layer[k] for layer in layers]))
            for k in layers[0]}


def _cast(tree: Mapping[str, Any], dtype: torch.dtype) -> Params:
    return {k: (_cast(v, dtype) if isinstance(v, Mapping)
                else v.to(dtype).contiguous())
            for k, v in tree.items()}


def params_from_openai_state_dict(cfg: WhisperConfig, sd: Mapping[str, Any],
                                  dtype: torch.dtype = torch.float32) -> Params:
    """An openai/whisper checkpoint's "model_state_dict" -> the JAX-layout
    tree of CPU tensors in `dtype`."""
    def attn(prefix):
        return {"q": _linear(sd, f"{prefix}.query"),
                "k": _linear(sd, f"{prefix}.key", bias=False),
                "v": _linear(sd, f"{prefix}.value"),
                "out": _linear(sd, f"{prefix}.out")}

    def mlp(prefix):
        return {"fc1": _linear(sd, f"{prefix}.0"), "fc2": _linear(sd, f"{prefix}.2")}

    enc_layers = [{"attn": attn(f"encoder.blocks.{i}.attn"),
                   "attn_ln": _ln(sd, f"encoder.blocks.{i}.attn_ln"),
                   "mlp": mlp(f"encoder.blocks.{i}.mlp"),
                   "mlp_ln": _ln(sd, f"encoder.blocks.{i}.mlp_ln")}
                  for i in range(cfg.n_audio_layer)]
    dec_layers = [{"attn": attn(f"decoder.blocks.{i}.attn"),
                   "attn_ln": _ln(sd, f"decoder.blocks.{i}.attn_ln"),
                   "cross_attn": attn(f"decoder.blocks.{i}.cross_attn"),
                   "cross_attn_ln": _ln(sd, f"decoder.blocks.{i}.cross_attn_ln"),
                   "mlp": mlp(f"decoder.blocks.{i}.mlp"),
                   "mlp_ln": _ln(sd, f"decoder.blocks.{i}.mlp_ln")}
                  for i in range(cfg.n_text_layer)]
    return _cast({
        "encoder": {"conv1": _conv(sd, "encoder.conv1"),
                    "conv2": _conv(sd, "encoder.conv2"),
                    "blocks": _stack_layers(enc_layers),
                    "ln_post": _ln(sd, "encoder.ln_post")},
        "decoder": {"token_embedding": _t(sd["decoder.token_embedding.weight"]),
                    "positional_embedding": _t(sd["decoder.positional_embedding"]),
                    "blocks": _stack_layers(dec_layers),
                    "ln": _ln(sd, "decoder.ln")},
    }, dtype)


_HF_PREFIX = re.compile(r"^(model\.|proj_out\.)")

# HuggingFace names (after _HF_PREFIX) -> openai/whisper's, applied in order
_HF_TO_OPENAI = [
    (r"^(encoder|decoder)\.layers\.", r"\1.blocks."),
    (r"\.self_attn_layer_norm\.", ".attn_ln."),
    (r"\.encoder_attn_layer_norm\.", ".cross_attn_ln."),
    (r"\.final_layer_norm\.", ".mlp_ln."),
    (r"\.self_attn\.", ".attn."), (r"\.encoder_attn\.", ".cross_attn."),
    (r"\.q_proj\.", ".query."), (r"\.k_proj\.", ".key."),
    (r"\.v_proj\.", ".value."), (r"\.out_proj\.", ".out."),
    (r"\.fc1\.", ".mlp.0."), (r"\.fc2\.", ".mlp.2."),
    (r"^encoder\.layer_norm\.", "encoder.ln_post."),
    (r"^decoder\.layer_norm\.", "decoder.ln."),
    (r"^decoder\.embed_tokens\.", "decoder.token_embedding."),
    (r"^decoder\.embed_positions\.weight$", "decoder.positional_embedding"),
]


def params_from_hf_state_dict(cfg: WhisperConfig, sd: Mapping[str, Any],
                              dtype: torch.dtype = torch.float32) -> Params:
    """A HuggingFace WhisperForConditionalGeneration / WhisperModel state
    dict -> the JAX-layout tree of CPU tensors in `dtype`. HF's weights are
    openai's under other names: they are renamed and converted as openai's
    (keys HF has and openai has not, such as `proj_out.weight`, the tied
    output projection, are not read)."""
    renamed = {}
    for key, val in sd.items():
        key = _HF_PREFIX.sub("", key)
        for pattern, repl in _HF_TO_OPENAI:
            key = re.sub(pattern, repl, key)
        renamed[key] = val
    return params_from_openai_state_dict(cfg, renamed, dtype)


def _to_tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.int8:  # quantised weights keep their type
        return torch.from_numpy(a.copy())
    # numpy has no bf16: float leaves (bf16 included) become fp32
    return torch.from_numpy(np.array(a, np.float32))


def tree_from_numpy(tree: Mapping[str, Any]) -> Params:
    """Nested dict of numpy arrays -> the same tree of CPU tensors (int8
    leaves stay int8, float leaves become fp32)."""
    return {k: (tree_from_numpy(v) if isinstance(v, Mapping) else _to_tensor(v))
            for k, v in tree.items()}


def from_jax_params(tree: Mapping[str, Any], cfg: WhisperConfig):
    """Load a JAX parameter pytree (as numpy, e.g. via `jax.device_get`),
    float or int8-quantised, with or without LoRA adapters, into the port's
    modules: an fp32 WhisperModel on the CPU (`.to(device, dtype)` moves
    it; int8 weights keep their type)."""
    from .models.whisper import WhisperModel

    return WhisperModel(cfg, tree_from_numpy(tree))


_CONV_PATHS = ("encoder/conv1/w", "encoder/conv2/w")  # (C_out, C_in, k) in torch


def jax_path(name: str) -> str:
    """A module parameter's name -> its path in the JAX tree."""
    parts = name.split(".")
    if len(parts) > 2 and parts[1] == "blocks":
        del parts[2]  # the layer index: JAX stacks layers on axis 0
    return "/".join(parts)


def params_tree(model: torch.nn.Module,
                tensors: Optional[Mapping[str, torch.Tensor]] = None) -> Params:
    """The model's parameters as a JAX-layout tree of tensors on the
    model's device and in its dtypes: layers restacked (copies), conv
    weights back to (kernel, C_in, C_out); other leaves are the parameters'
    detached tensors. `tensors` (parameter name -> tensor) stands in for
    the parameters' values (`parallel.sharding.gather_params`)."""
    from .utils.checkpoint import unflatten_params

    groups: Dict[str, list] = {}
    for name, p in model.named_parameters():
        t = p.detach() if tensors is None else tensors[name]
        groups.setdefault(jax_path(name), []).append(t)
    flat = {}
    for path, ts in groups.items():
        t = torch.stack(ts) if "/blocks/" in path else ts[0]
        if path in _CONV_PATHS:
            t = t.permute(2, 1, 0).contiguous()
        flat[path] = t
    return unflatten_params(flat)


def to_jax_params(model: torch.nn.Module) -> Params:
    """The model's parameters as the JAX package's nested numpy tree (float
    leaves as fp32, bf16 included; int8 stays int8)."""
    from .utils.checkpoint import _to_numpy, flatten_params, unflatten_params

    flat = flatten_params(params_tree(model))
    return unflatten_params({k: _to_numpy(v) for k, v in flat.items()})


@torch.no_grad()
def assign_params(model: torch.nn.Module, tree: Mapping[str, Any]) -> None:
    """Copy a JAX-layout tree (tensors, or numpy) into the model's
    parameters in place; the tree must hold exactly the model's leaves."""
    from .utils.checkpoint import flatten_params

    flat = flatten_params(tree)
    named = dict(model.named_parameters())
    missing = {jax_path(n) for n in named} ^ set(flat)
    if missing:
        raise ValueError(f"tree and model leaves differ: {sorted(missing)}")
    for name, p in named.items():
        path = jax_path(name)
        leaf = torch.as_tensor(flat[path])
        if path in _CONV_PATHS:
            leaf = leaf.permute(2, 1, 0)
        if "/blocks/" in path:
            leaf = leaf[int(name.split(".")[2])]
        if tuple(leaf.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(leaf.shape)} != "
                             f"{tuple(p.shape)}")
        p.copy_(leaf)


def count_params(module: torch.nn.Module) -> int:
    """Number of parameter elements of a module."""
    return sum(p.numel() for p in module.parameters())
