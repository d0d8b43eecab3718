"""Megatron-style sharding rules for Whisper parameter trees (port of
`parallel/sharding.py`).

The spec tree is JAX's, leaf for leaf:

  * attention q/k/v and mlp fc1: COLUMN-parallel (out-features on
    "model"), so each rank owns a contiguous block of heads / hidden units;
  * attention out and mlp fc2: ROW-parallel (in-features on "model"),
    closing the pair with one all-reduce per block (`models.layers`);
  * conv1 / conv2: output channels on "model" (gathered after each conv);
  * token embedding (the tied logit table), positions, layer norms and the
    row-parallel biases: replicated.

`shard_params` returns this rank's local slice of every leaf: the leaf cut
along the dimension its spec puts on "model", at the model rank's index;
data ranks hold full copies. A quantized leaf follows its float weight:
`w_q` is cut like `w`, and a column-parallel `scale` (per output channel)
like the output columns, while a row-parallel `scale` stays whole. Scales
are computed over the whole weight, as JAX computes them, so a tree is
quantized before it is cut (`models.whisper.build_model`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from ..config import WhisperConfig
from .mesh import AXIS_MODEL, P, PartitionSpec, model_axis

Params = Dict[str, Any]

def _attn_specs(stacked: bool) -> Params:
    L = (None,) if stacked else ()
    col_w = P(*L, None, AXIS_MODEL)
    col_b = P(*L, AXIS_MODEL)
    row_w = P(*L, AXIS_MODEL, None)
    rep_b = P(*L, None)
    return {
        "q": {"w": col_w, "b": col_b},
        "k": {"w": col_w},
        "v": {"w": col_w, "b": col_b},
        "out": {"w": row_w, "b": rep_b},
    }


def _mlp_specs(stacked: bool) -> Params:
    L = (None,) if stacked else ()
    return {
        "fc1": {"w": P(*L, None, AXIS_MODEL), "b": P(*L, AXIS_MODEL)},
        "fc2": {"w": P(*L, AXIS_MODEL, None), "b": P(*L, None)},
    }


def _ln_specs(stacked: bool) -> Params:
    L = (None,) if stacked else ()
    return {"scale": P(*L, None), "bias": P(*L, None)}


def param_pspecs(cfg: WhisperConfig) -> Params:
    """PartitionSpec tree with the structure of a float parameter tree."""
    return {
        "encoder": {
            "conv1": {"w": P(None, None, AXIS_MODEL), "b": P(AXIS_MODEL)},
            "conv2": {"w": P(None, None, AXIS_MODEL), "b": P(AXIS_MODEL)},
            "blocks": {
                "attn": _attn_specs(True),
                "attn_ln": _ln_specs(True),
                "mlp": _mlp_specs(True),
                "mlp_ln": _ln_specs(True),
            },
            "ln_post": _ln_specs(False),
        },
        "decoder": {
            # replicated: the 51865/51866 vocab does not divide the model
            # axis, and the table is small (<= 133 MB at large-v3)
            "token_embedding": P(None, None),
            "positional_embedding": P(None, None),
            "blocks": {
                "attn": _attn_specs(True),
                "attn_ln": _ln_specs(True),
                "cross_attn": _attn_specs(True),
                "cross_attn_ln": _ln_specs(True),
                "mlp": _mlp_specs(True),
                "mlp_ln": _ln_specs(True),
            },
            "ln": _ln_specs(False),
        },
    }


def _replicate(tree) -> Any:
    if isinstance(tree, Mapping):
        return {k: _replicate(v) for k, v in tree.items()}
    return P()


def align_pspecs(pspecs: Params, params: Params) -> Params:
    """Mirror `params`' structure: keys the spec tree does not know (LoRA
    adapters) get replicated specs. Quantized leaves follow their float
    weight, where JAX's shardings land them by computation (it quantizes
    sharded weights): `w_q` takes `w`'s spec, and `scale` (per output
    channel, reduced over the contraction axis -2) takes it with that axis
    unsharded."""
    if not isinstance(params, Mapping):
        return pspecs
    out: Params = {}
    for k, v in params.items():
        w = pspecs.get("w") if isinstance(pspecs, Mapping) and "w_q" in params else None
        if k == "w_q" and w is not None:
            out[k] = w
        elif k == "scale" and w is not None:
            out[k] = P(*tuple(w)[:-2], None, *tuple(w)[-1:])
        elif isinstance(pspecs, Mapping) and k in pspecs:
            out[k] = align_pspecs(pspecs[k], v)
        else:
            out[k] = _replicate(v)
    return out


def model_dim(spec: PartitionSpec) -> Optional[int]:
    """The dimension a spec puts on "model", or None (replicated)."""
    spec = tuple(spec)
    return spec.index(AXIS_MODEL) if AXIS_MODEL in spec else None


def _cut(t: torch.Tensor, dim: Optional[int], rank: int, size: int) -> torch.Tensor:
    if dim is None or size == 1:
        return t
    if t.shape[dim] % size:
        raise ValueError(f"dimension {dim} of a {tuple(t.shape)} leaf does "
                         f"not divide the model axis ({size})")
    return t.chunk(size, dim=dim)[rank].contiguous().clone()


def shard_params(params: Params, cfg: WhisperConfig, mesh) -> Params:
    """This rank's local slice of every leaf of a full parameter tree
    (JAX layout): cut along the spec's "model" dimension at the model
    rank's index (copies, so the full leaves can be freed). On a model
    axis of one rank every leaf is whole: the tree itself."""
    axis = model_axis(mesh)
    if axis is None:
        return params

    def walk(node, specs):
        if isinstance(node, Mapping):
            return {k: walk(v, specs[k]) for k, v in node.items()}
        return _cut(node, model_dim(specs), axis.rank, axis.size)

    return walk(params, align_pspecs(param_pspecs(cfg), params))


def module_shard_dims(model) -> Dict[str, Optional[int]]:
    """Module parameter name -> the dimension of the module's tensor that
    is cut over "model" (None: replicated). Stacked layers lose their
    leading axis in the modules, and conv weights are stored (C_out, C_in,
    k), the reverse of the tree's (k, C_in, C_out)."""
    from ..params import _CONV_PATHS, jax_path
    from ..utils.checkpoint import flatten_params, unflatten_params

    names = [n for n, _ in model.named_parameters()]
    skeleton = unflatten_params({jax_path(n): None for n in names})
    flat = flatten_params(align_pspecs(param_pspecs(model.cfg), skeleton))
    dims = {}
    for name in names:
        path = jax_path(name)
        spec = tuple(flat[path])
        if "/blocks/" in path:
            spec = spec[1:]
        if path in _CONV_PATHS:
            spec = spec[::-1]
        dims[name] = model_dim(spec)
    return dims


def gather_named(model, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Full tensors from this rank's shards, keyed by module parameter name
    (the parameters themselves, optimizer moments): the shards of a model
    group gathered along each name's cut dimension. Every rank of the
    group must call it."""
    from ..models.layers import gather_model

    axis = model.decoder.axis
    if axis is None:
        return dict(tensors)
    dims = module_shard_dims(model)
    return {n: (t if dims[n] is None else gather_model(t.detach(), dims[n], axis))
            for n, t in tensors.items()}


def shard_named(model, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of `gather_named`: this rank's slice of full tensors
    keyed by module parameter name."""
    axis = model.decoder.axis
    if axis is None:
        return dict(tensors)
    dims = module_shard_dims(model)
    return {n: _cut(t, dims[n], axis.rank, axis.size) for n, t in tensors.items()}


def gather_params(model) -> Params:
    """The model's full parameter tree (JAX layout, `params.params_tree`)
    from every rank's shards; every rank of the model group must call it.
    The tree a checkpoint is saved from, and the one tests hold against
    the one-process model."""
    from ..params import params_tree

    if model.decoder.axis is None:
        return params_tree(model)
    full = gather_named(model, dict(model.named_parameters()))
    return params_tree(model, tensors=full)
