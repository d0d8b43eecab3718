"""Whisper audio encoder: conv stem + pre-LN transformer stack (port of
`models/encoder.py`). The 1500-position self-attention of every block runs
the Hopper flash kernel on the card (`layers.self_attention`); training
may ask for the plain attention instead (`flash=False`, JAX's default) and
for rematerialised blocks (`remat=True`, JAX's `jax.checkpoint`).

Under a model axis (`parallel/`) each conv holds its output channels'
slice and gathers its output to full channels before the next op, and
each block runs K1 on the rank's n_audio_head / n_model heads."""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import WhisperConfig
from ..utils.profiling import spanned
from .layers import (MLP, Attention, LayerNorm, copy_to_model, frozen,
                     gather_model, gelu, layer_norm, layer_slice,
                     self_attention, sinusoids)


class Conv1d(nn.Module):
    """k=3 'same' conv; the tree's (kernel, C_in, C_out) weight is stored in
    PyTorch's (C_out, C_in, kernel) layout."""

    def __init__(self, p: Mapping[str, torch.Tensor], stride: int, axis=None):
        super().__init__()
        self.stride = stride
        self.axis = axis  # a model axis: w and b hold this rank's C_out slice
        self.w = frozen(p["w"].permute(2, 1, 0).contiguous())
        self.b = frozen(p["b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.axis is not None:
            x = copy_to_model(x, self.axis)
        y = F.conv1d(x, self.w.to(x.dtype), stride=self.stride, padding=1)
        y = (y.float() + self.b.float()[None, :, None]).to(x.dtype)
        if self.axis is not None:
            y = gather_model(y, 1, self.axis)
        return y


class EncoderBlock(nn.Module):
    def __init__(self, p: Mapping[str, Any], n_head: int, axis=None):
        super().__init__()
        self.attn = Attention(p["attn"], n_head, axis)
        self.attn_ln = LayerNorm(p["attn_ln"])
        self.mlp = MLP(p["mlp"], axis)
        self.mlp_ln = LayerNorm(p["mlp_ln"])

    def forward(self, x: torch.Tensor, flash: bool = True) -> torch.Tensor:
        x = x + self_attention(layer_norm(x, self.attn_ln), self.attn,
                               flash=flash)
        return x + self.mlp(layer_norm(x, self.mlp_ln))


class AudioEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, p: Mapping[str, Any], axis=None):
        super().__init__()
        self.cfg = cfg
        self.conv1 = Conv1d(p["conv1"], stride=1, axis=axis)
        self.conv2 = Conv1d(p["conv2"], stride=2, axis=axis)
        self.blocks = nn.ModuleList(
            EncoderBlock(layer_slice(p["blocks"], l), cfg.n_audio_head, axis)
            for l in range(cfg.n_audio_layer))
        self.ln_post = LayerNorm(p["ln_post"])

    @spanned("encoder")
    def forward(self, mel: torch.Tensor, *, flash: bool = True,
                remat: bool = False) -> torch.Tensor:
        """mel (B, n_mels, 3000) -> audio features (B, 1500, n_audio_state),
        in the weights' dtype. `remat` recomputes each block in the
        backward pass (activation memory flat in depth; the recompute runs
        the block's kernels again)."""
        cfg = self.cfg
        x = mel.to(self.conv1.w.dtype)
        x = gelu(self.conv1(x))
        x = gelu(self.conv2(x))  # (B, n_state, 1500)
        x = x.transpose(1, 2)
        if x.shape[1] != cfg.n_audio_ctx:
            raise ValueError(
                f"audio context {x.shape[1]} != configured {cfg.n_audio_ctx}; "
                "mel input must cover exactly one 30s chunk (3000 frames)")
        x = x + sinusoids(cfg.n_audio_ctx, cfg.n_audio_state,
                          device=x.device).to(x.dtype)
        for block in self.blocks:
            if remat:
                x = checkpoint(block, x, flash, use_reentrant=False)
            else:
                x = block(x, flash)
        return layer_norm(x, self.ln_post)
