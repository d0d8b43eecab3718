"""Top-level Whisper model and `load_model` (port of `models/whisper.py`).

With a (data, model) mesh (`parallel.make_mesh`, one process per rank)
the model holds this rank's shard of the weights (`parallel.sharding`):
its linears are tensor-parallel over the model group, and its entry
points split a batch over the data groups (`decoding.decode`,
`detect_language`, `encode`, `serve.transcribe_batch`) and return the
whole batch's results on every rank."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .. import audio as audio_mod
from ..config import WhisperConfig, get_config
from ..params import count_params, init_params
from . import decoder as dec_mod
from .encoder import AudioEncoder


class WhisperModel(nn.Module):
    """Encoder + decoder weights with the JAX package's entry points:
    log_mel, encode, logits, detect_language, decode and transcribe.
    `alignment_heads`: the (n_text_layer, n_text_head) bool mask of the
    heads word timestamps align with, from a checkpoint's metadata; None
    takes `timing.default_alignment_heads`.

    `draft`: an optional paired draft model sharing the tokenizer (e.g.
    large-v3-turbo for large-v3, `speculative.check_pair`); with one,
    batched serving's greedy and sampled rungs run speculative decoding.
    It is not a submodule (its weights are not this model's), and setting
    it drops the serving acceptance governor (`serve.spec_governor`): a new
    pairing is new evidence.

    `mesh`: the (data, model) DeviceMesh whose model group shares this
    model's weights; `params` is then this rank's shard of the tree
    (`parallel.shard_params`). None (the default) is the one-card model."""

    def __init__(self, cfg: WhisperConfig, params: Mapping[str, Any],
                 alignment_heads: Optional[np.ndarray] = None,
                 draft: Optional["WhisperModel"] = None, mesh=None):
        super().__init__()
        from ..parallel.mesh import model_axis

        self.cfg = cfg
        self.mesh = mesh
        axis = model_axis(mesh)
        self.encoder = AudioEncoder(cfg, params["encoder"], axis)
        self.decoder = dec_mod.TextDecoder(cfg, params["decoder"], axis)
        self.alignment_heads = alignment_heads
        self.draft = draft

    def __setattr__(self, name: str, value) -> None:
        if name == "draft":
            self.__dict__.pop("_spec_governor", None)
            object.__setattr__(self, name, value)
            return
        super().__setattr__(name, value)

    @property
    def device(self) -> torch.device:
        return self.decoder.token_embedding.device

    def log_mel(self, audio_wave) -> torch.Tensor:
        """(n_samples,) or (B, n_samples) at 16 kHz -> log-mel on the model's
        device, fp32."""
        return audio_mod.log_mel_spectrogram(
            torch.as_tensor(audio_wave, device=self.device), n_mels=self.cfg.n_mels)

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This data rank's rows of a batch (the port's `shard_batch`): the
        batch padded to the data axis by repeating its last row, then cut
        into equal shares. The whole batch without a mesh or inside
        `parallel.mesh.data_local()`."""
        from ..parallel.mesh import AXIS_DATA, axis_rank, data_ways

        d = data_ways(self.mesh)
        if d == 1:
            return x
        per = -(-x.shape[0] // d)
        r = axis_rank(self.mesh, AXIS_DATA)
        pad = per * d - x.shape[0]
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        return x[r * per:(r + 1) * per]

    def encode(self, mel) -> torch.Tensor:
        """(B, n_mels, 3000) or (n_mels, 3000) -> (B, 1500, n_state). Under
        a mesh each data group encodes its rows (`local_rows`) and the
        features of the whole batch are gathered onto every rank."""
        mel = torch.as_tensor(mel, device=self.device)
        if mel.ndim == 2:
            return self._encode(mel[None])[0]
        return self._encode(mel)

    def _encode(self, mel: torch.Tensor) -> torch.Tensor:
        from ..parallel.mesh import AXIS_DATA, axis_group, axis_rank, data_ways

        d = data_ways(self.mesh)
        if d == 1:
            return self.encoder(mel)
        from .layers import gather_dim

        feats = self.encoder(self.local_rows(mel))
        return gather_dim(feats, 0, axis_group(self.mesh, AXIS_DATA),
                          axis_rank(self.mesh, AXIS_DATA), d)[:mel.shape[0]]

    def logits(self, tokens, audio_features: torch.Tensor) -> torch.Tensor:
        """Teacher-forcing logits (B, T, vocab), fp32."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return dec_mod.decoder_forward(self.decoder, tokens, audio_features)

    def detect_language(self, mel_or_features, *, from_features: bool = False):
        from ..decoding import detect_language

        return detect_language(self, mel_or_features, from_features=from_features)

    def transcribe(self, audio, **kwargs):
        """Long-form transcription of a path or mono float audio (see
        `transcribe.transcribe`)."""
        from ..transcribe import transcribe

        return transcribe(self, audio, **kwargs)

    def decode(self, mel, options=None, **kwargs):
        """Decode one batch of 30 s windows; a bare result for an unbatched
        mel (openai `model.decode` semantics)."""
        from ..decoding import DecodingOptions, decode

        if options is None:
            options = DecodingOptions(**kwargs)
        elif kwargs:
            options = dataclasses.replace(options, **kwargs)
        mel = torch.as_tensor(mel, device=self.device)
        unbatched = mel.ndim == 2
        results = decode(self, mel[None] if unbatched else mel, options)
        return results[0] if unbatched else results

    @property
    def num_params(self) -> int:
        return count_params(self)


def _device_and_dtype(device, dtype):
    """cuda by default (raising without a card), the CPU only on request;
    bf16 on cuda and fp32 on cpu unless dtype is given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on an NVIDIA GPU; pass "
                "device='cpu' to build the model on the CPU")
        device = "cuda"
    device = torch.device(device)
    if dtype is None:
        dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    return device, dtype


def _check_mesh_heads(cfg: WhisperConfig, mesh) -> None:
    from ..parallel.mesh import AXIS_MODEL, axis_size

    n_model = axis_size(mesh, AXIS_MODEL)
    if cfg.n_text_head % n_model or cfg.n_audio_head % n_model:
        raise ValueError(
            f"model axis ({n_model}) must divide attention heads "
            f"({cfg.n_audio_head} audio / {cfg.n_text_head} text)")


def model_from_params(cfg: WhisperConfig, params, *,
                      quantize: Optional[str] = None, mesh=None,
                      **kw) -> WhisperModel:
    """The model of a full parameter tree, as `load_model` builds it:
    quantized if asked, then cut to this rank's shard under a mesh. The
    int8 scales are computed over each whole weight, as JAX computes them
    when it quantizes after sharding, so a rank's `w_q` / `scale` are JAX's
    shard of them. kw: WhisperModel's other arguments."""
    if mesh is not None:
        _check_mesh_heads(cfg, mesh)
    if quantize == "int8":
        from ..quantize import quantize_params

        params = quantize_params(params)
    if mesh is not None:
        from ..parallel.sharding import shard_params

        params = shard_params(params, cfg, mesh)
    return WhisperModel(cfg, params, mesh=mesh, **kw)


def build_model(cfg: WhisperConfig, *, dtype: Optional[torch.dtype] = None,
                seed: int = 0, quantize: Optional[str] = None,
                device: torch.device | str | None = None,
                mesh=None) -> WhisperModel:
    """A WhisperModel of `cfg` with random weights made from `seed` on
    `device`: cuda by default (the rank's card under torchrun), the CPU
    only when the caller passes device="cpu". dtype defaults to bf16 on
    cuda and fp32 on cpu; quantize="int8" gives weights-only int8 linears.
    mesh: a (data, model) DeviceMesh (`parallel.make_mesh`); every rank
    makes the same full weights from `seed` and keeps its shard."""
    device, dtype = _device_and_dtype(device, dtype)
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantization {quantize!r}")
    generator = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, generator, dtype=dtype, device=device)
    return model_from_params(cfg, params, quantize=quantize, mesh=mesh)


def load_model(name: str, *, dtype: Optional[torch.dtype] = None, seed: int = 0,
               quantize: Optional[str] = None, checkpoint: Optional[str] = None,
               device: torch.device | str | None = None,
               mesh=None) -> WhisperModel:
    """A named Whisper size: random weights from `seed` (see build_model),
    or the weights of a `.safetensors` checkpoint written by either
    package's `save_params` (`python -m openai_whisper_coreml_tpu_torch.convert`,
    `tools/convert.py`, fine-tuning).

    An int8 checkpoint (`quantized: int8` in its metadata) loads as it is:
    quantize="int8" is then satisfied, and another quantize raises. The
    JAX package's orbax training-state directories cannot be read here
    (orbax does not run on the card): a directory raises. Alignment heads
    in the metadata (`alignment_heads`, any format
    `timing.load_alignment_heads` reads) become `model.alignment_heads`.

    mesh: shard the weights over a (data, model) DeviceMesh (see
    build_model), with JAX's checks in JAX's order: a pre-quantized
    checkpoint raises (its scales were made without the mesh; load the
    float checkpoint with quantize="int8"), then heads the model axis does
    not divide."""
    if checkpoint is None:
        return build_model(get_config(name), dtype=dtype, seed=seed,
                           quantize=quantize, device=device, mesh=mesh)
    from ..utils.checkpoint import load_params, read_metadata

    if os.path.isdir(checkpoint) or not checkpoint.endswith(".safetensors"):
        raise ValueError(
            f"{checkpoint!r}: the port loads .safetensors checkpoints only; "
            "convert openai .pt files and HF directories with python -m "
            "openai_whisper_coreml_tpu_torch.convert (JAX orbax train-state "
            "directories do not load into it)")
    cfg = get_config(name)
    device, dtype = _device_and_dtype(device, dtype)
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantization {quantize!r}")
    params = load_params(checkpoint, cfg=cfg, dtype=dtype)
    meta = read_metadata(checkpoint)
    alignment_heads = None
    if meta.get("alignment_heads"):
        from ..timing import load_alignment_heads

        alignment_heads = load_alignment_heads(meta["alignment_heads"], cfg)
    prequantized = meta.get("quantized")
    if prequantized:
        if quantize not in (None, prequantized):
            raise ValueError(f"checkpoint is pre-quantized ({prequantized}); "
                             f"quantize={quantize!r} cannot apply")
        if mesh is not None:
            raise ValueError(
                "pre-quantized checkpoints cannot be TP-sharded (the int8 "
                "scales were made on the whole weights without the mesh); "
                "load the float checkpoint with quantize='int8' instead")
        quantize = None
    params = _to_device(params, device)
    return model_from_params(cfg, params, quantize=quantize, mesh=mesh,
                             alignment_heads=alignment_heads)


def _to_device(tree: Mapping[str, Any], device: torch.device) -> dict:
    return {k: (_to_device(v, device) if isinstance(v, Mapping) else v.to(device))
            for k, v in tree.items()}
