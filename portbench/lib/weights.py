"""Seeded weights for a configuration, made on the device in the type they
are served in, from one draw.

The tree has the port's parameter layout (`params.init_params`): per-layer
leaves stacked on axis 0, linear weights stored (in, out), conv weights
(kernel, C_in, C_out). Every value comes from one `torch.randn` call over a
flat buffer on a generator seeded with `--seed`: weights scaled by their
fan-in (logits then lie near N(0, 1)), biases and layer-norm offsets at
0.02, layer-norm scales at 1 + 0.02 x, learned positions at 0.01. The same
seed on the same device gives the same tensors, so the reference can make
them again after the program has been freed."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (path, shape, kind, fan_in); kind: "w" fan-in scaled, "b" bias,
# "s" layer-norm scale, "p" learned positions
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, int]


def _attn(prefix, nl, n) -> List[Leaf]:
    return [(prefix + ("q", "w"), (nl, n, n), "w", n), (prefix + ("q", "b"), (nl, n), "b", 0),
            (prefix + ("k", "w"), (nl, n, n), "w", n),
            (prefix + ("v", "w"), (nl, n, n), "w", n), (prefix + ("v", "b"), (nl, n), "b", 0),
            (prefix + ("out", "w"), (nl, n, n), "w", n), (prefix + ("out", "b"), (nl, n), "b", 0)]


def _ln(prefix, *shape) -> List[Leaf]:
    return [(prefix + ("scale",), shape, "s", 0), (prefix + ("bias",), shape, "b", 0)]


def _mlp(prefix, nl, n, f) -> List[Leaf]:
    return [(prefix + ("fc1", "w"), (nl, n, f), "w", n), (prefix + ("fc1", "b"), (nl, f), "b", 0),
            (prefix + ("fc2", "w"), (nl, f, n), "w", f), (prefix + ("fc2", "b"), (nl, n), "b", 0)]


def leaves(d: Dict[str, int]) -> List[Leaf]:
    n, nt, f = d["n_audio_state"], d["n_text_state"], d["n_ffn"]
    la, lt = d["n_audio_layer"], d["n_text_layer"]
    enc, dec = ("encoder",), ("decoder",)
    eb, db = enc + ("blocks",), dec + ("blocks",)
    return [
        (enc + ("conv1", "w"), (3, d["n_mels"], n), "w", 3 * d["n_mels"]),
        (enc + ("conv1", "b"), (n,), "b", 0),
        (enc + ("conv2", "w"), (3, n, n), "w", 3 * n),
        (enc + ("conv2", "b"), (n,), "b", 0),
        *_attn(eb + ("attn",), la, n), *_ln(eb + ("attn_ln",), la, n),
        *_mlp(eb + ("mlp",), la, n, f), *_ln(eb + ("mlp_ln",), la, n),
        *_ln(enc + ("ln_post",), n),
        (dec + ("token_embedding",), (d["n_vocab"], nt), "w", nt),
        (dec + ("positional_embedding",), (d["n_text_ctx"], nt), "p", 0),
        *_attn(db + ("attn",), lt, nt), *_ln(db + ("attn_ln",), lt, nt),
        *_attn(db + ("cross_attn",), lt, nt), *_ln(db + ("cross_attn_ln",), lt, nt),
        *_mlp(db + ("mlp",), lt, nt, f), *_ln(db + ("mlp_ln",), lt, nt),
        *_ln(dec + ("ln",), nt),
    ]


def make_params(d: Dict[str, int], seed: int, device: torch.device,
                dtype: torch.dtype) -> dict:
    """The parameter tree of sizes `d` from `seed`, on `device` in `dtype`."""
    spec = leaves(d)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    tree: dict = {}
    off = 0
    for path, shape, kind, fan_in in spec:
        x = flat[off:off + math.prod(shape)].view(shape)
        off += x.numel()
        if kind == "w":
            x = x * (1.0 / math.sqrt(fan_in))
        elif kind == "b":
            x = x * 0.02
        elif kind == "s":
            x = x * 0.02 + 1.0
        else:
            x = x * 0.01
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x
    return tree

