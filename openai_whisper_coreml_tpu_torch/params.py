"""Parameter trees: random initialisation and loading the JAX pytree.

The port keeps the JAX package's parameter layout as its interchange format
(`openai_whisper_coreml_tpu/params.py`): a nested dict whose per-layer
weights are stacked on axis 0, linear weights stored (in, out), conv
weights (kernel, C_in, C_out). `models.whisper.WhisperModel` turns such a
tree into `nn.Module`s (conv weights become PyTorch's (C_out, C_in, kernel)
there), so a tree made here, quantised by `quantize.quantize_params`, or
converted from the JAX package, all load the same way.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

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
    float or int8-quantised, into the port's modules: an fp32 WhisperModel
    on the CPU (`.to(device, dtype)` moves it; int8 weights keep their type)."""
    from .models.whisper import WhisperModel

    return WhisperModel(cfg, tree_from_numpy(tree))


def count_params(module: torch.nn.Module) -> int:
    """Number of parameter elements of a module."""
    return sum(p.numel() for p in module.parameters())
