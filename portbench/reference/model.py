"""A plain Whisper in float32: the log-mel, the encoder, the decoder's
teacher-forced forward and the language probabilities, written from the
published model (openai/whisper `model.py`, `audio.py`) in plain PyTorch.

It imports nothing of the program under test and takes none of its
derived state: it is handed the same seeded parameter tree (the benchmark
made it) and the same audio, and works out again what the program derives
from them. The program's int8 rules are the configuration's, so they are
applied here too, by this file's own copy of them: weight-only int8 with a
per-output-channel scale (the absolute maximum over the contraction axis
over 127, round half to even) on every linear weight of 65,536 elements or
more in its stacked (layers, in, out) tree, and int8 cross-attention K/V
with one scale per (head, position) over the head's 64 channels. Every
other step is float32 with TF32 off. `weight_bits=4` gives the control:
the same rules at 4 bits (levels -7..7), the step below the configuration's
int8."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
N_FRAMES = 3000  # one 30 s window of mel frames
MIN_QUANT_SIZE = 1 << 16


def exact_float32() -> None:
    """float32 products as float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# -- log-mel -------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    mel = f / (200.0 / 3.0)
    logstep = np.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / logstep, mel)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (np.maximum(m, 15.0) - 15.0)),
                    (200.0 / 3.0) * m)


def mel_filters(n_mels: int) -> np.ndarray:
    """librosa.filters.mel(sr=16000, n_fft=400, n_mels, htk=False,
    norm="slaney"), as openai/whisper's mel_filters.npz holds it."""
    fft_freqs = np.linspace(0.0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    ramps = hz[:, None] - fft_freqs[None, :]
    fdiff = np.diff(hz)
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                         ramps[2:] / fdiff[1:, None]))
    return (weights * (2.0 / (hz[2:] - hz[:-2]))[:, None]).astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """openai/whisper `log_mel_spectrogram` of one (N,) waveform: (n_mels,
    N // 160) float32 on the audio's device."""
    window = torch.hann_window(N_FFT, device=audio.device)
    stft = torch.stft(audio.float(), N_FFT, HOP_LENGTH, window=window, return_complex=True)
    power = stft[..., :-1].abs() ** 2
    filters = torch.from_numpy(mel_filters(n_mels)).to(audio.device)
    log_spec = torch.clamp(filters @ power, min=1e-10).log10()
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def recording_mel(audio: torch.Tensor, n_mels: int) -> Tuple[torch.Tensor, int]:
    """openai `transcribe`'s mel of a whole recording: the audio padded to a
    hop multiple, then with 30 s of zeros; returns (mel, content frames)."""
    n = audio.shape[-1]
    n_ceil = -(-n // HOP_LENGTH) * HOP_LENGTH
    padded = torch.zeros(n_ceil + N_FRAMES * HOP_LENGTH, device=audio.device)
    padded[:n] = audio
    return log_mel(padded, n_mels), -(-n // HOP_LENGTH)


def window_mel(mel: torch.Tensor, seek: int, content_frames: int) -> torch.Tensor:
    """The 30 s window at frame `seek`: the content, zero-padded to 3000."""
    size = max(0, min(N_FRAMES, content_frames - seek))
    return F.pad(mel[:, seek:seek + size], (0, N_FRAMES - size))


# -- quantization (the configuration's rules) --------------------------------------

def quantize(x: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    """x rounded to `bits`-bit levels with one scale per slice along `dim`
    (the absolute maximum over `dim` over 2**(bits-1) - 1), as float32."""
    x32 = x.float()
    qmax = float(2 ** (bits - 1) - 1)
    amax = x32.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(torch.div(amax, torch.full_like(amax, qmax)), min=1e-12)
    return torch.clamp(torch.round(torch.div(x32, scale)), -qmax, qmax) * scale


def _linear_weights(tree, bits: int, name: str = "") -> dict:
    """The tree with every linear weight that the int8 rule takes replaced
    by its `bits`-bit levels, and every leaf float32."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _linear_weights(val, bits, key)
        elif (key == "w" and name not in ("conv1", "conv2") and val.ndim in (2, 3)
              and val.numel() >= MIN_QUANT_SIZE):
            out[key] = quantize(val, bits, dim=-2)
        else:
            out[key] = val.float()
    return out


# -- the model ---------------------------------------------------------------------

def _ln(x, p, i=None):
    s, b = (p["scale"], p["bias"]) if i is None else (p["scale"][i], p["bias"][i])
    return F.layer_norm(x, x.shape[-1:], s, b, eps=1e-5)


def _lin(x, p, i):
    y = x @ p["w"][i]
    return y + p["b"][i] if "b" in p else y


def _heads(x, h):
    b, t, n = x.shape
    return x.view(b, t, h, n // h).transpose(1, 2)  # (B, H, T, D)


def _attend(q, k, v, causal: bool = False):
    d = q.shape[-1]
    w = (q @ k.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        t = q.shape[-2]
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        w = w.masked_fill(~mask, float("-inf"))
    out = torch.softmax(w, dim=-1) @ v
    b, h, t, dd = out.shape
    return out.transpose(1, 2).reshape(b, t, h * dd)


def sinusoids(length: int, channels: int, device) -> torch.Tensor:
    inc = math.log(10_000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64, device=device))
    t = torch.arange(length, dtype=torch.float64, device=device)[:, None] * inv[None]
    return torch.cat([t.sin(), t.cos()], dim=1).float()


class Reference:
    """Whisper of sizes `d` over the parameter tree `params`, in float32
    with the configuration's int8 rules (`weight_bits` = 8) or the
    control's 4-bit ones (`weight_bits` = 4; the cross K/V then take 4
    bits too)."""

    def __init__(self, params: dict, d: Dict[str, int], weight_bits: int = 8):
        self.d = d
        self.bits = weight_bits
        self.p = _linear_weights(params, weight_bits)

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, 3000) -> (B, 1500, n_state)."""
        e, h = self.p["encoder"], self.d["n_audio_head"]
        x = F.gelu(F.conv1d(mel.float(), e["conv1"]["w"].permute(2, 1, 0), e["conv1"]["b"],
                            padding=1))
        x = F.gelu(F.conv1d(x, e["conv2"]["w"].permute(2, 1, 0), e["conv2"]["b"], stride=2,
                            padding=1)).transpose(1, 2)
        x = x + sinusoids(x.shape[1], x.shape[2], x.device)
        blk = e["blocks"]
        for i in range(self.d["n_audio_layer"]):
            a = blk["attn"]
            y = _ln(x, blk["attn_ln"], i)
            x = x + _lin(_attend(_heads(_lin(y, a["q"], i), h), _heads(_lin(y, a["k"], i), h),
                                 _heads(_lin(y, a["v"], i), h)), a["out"], i)
            y = _ln(x, blk["mlp_ln"], i)
            x = x + _lin(F.gelu(_lin(y, blk["mlp"]["fc1"], i)), blk["mlp"]["fc2"], i)
        return _ln(x, e["ln_post"])

    def cross_kv(self, feats: torch.Tensor, quantized: bool) -> List[tuple]:
        """Each layer's cross-attention K, V (B, H, S, D); with `quantized`
        each (head, position) column of D channels takes the int8 rule (4
        bits for the control)."""
        dec, h = self.p["decoder"]["blocks"]["cross_attn"], self.d["n_text_head"]
        out = []
        for i in range(self.d["n_text_layer"]):
            k, v = _heads(_lin(feats, dec["k"], i), h), _heads(_lin(feats, dec["v"], i), h)
            if quantized:
                k, v = quantize(k, self.bits, dim=-1), quantize(v, self.bits, dim=-1)
            out.append((k, v))
        return out

    def logits(self, tokens: torch.Tensor, cross: List[tuple]) -> torch.Tensor:
        """Teacher-forced logits (B, T, vocab) of tokens (B, T) from
        position 0."""
        dec, h = self.p["decoder"], self.d["n_text_head"]
        t = tokens.shape[1]
        x = dec["token_embedding"][tokens] + dec["positional_embedding"][:t]
        blk = dec["blocks"]
        for i in range(self.d["n_text_layer"]):
            a, c = blk["attn"], blk["cross_attn"]
            y = _ln(x, blk["attn_ln"], i)
            x = x + _lin(_attend(_heads(_lin(y, a["q"], i), h), _heads(_lin(y, a["k"], i), h),
                                 _heads(_lin(y, a["v"], i), h), causal=True), a["out"], i)
            y = _ln(x, blk["cross_attn_ln"], i)
            k, v = cross[i]
            x = x + _lin(_attend(_heads(_lin(y, c["q"], i), h), k, v), c["out"], i)
            y = _ln(x, blk["mlp_ln"], i)
            x = x + _lin(F.gelu(_lin(y, blk["mlp"]["fc1"], i)), blk["mlp"]["fc2"], i)
        return _ln(x, dec["ln"]) @ dec["token_embedding"].T

    def language_logprobs(self, mel: torch.Tensor, sot: int, lang0: int) -> torch.Tensor:
        """(B, n_langs) log-probabilities over the language tokens at the
        start-of-transcript step (openai `detect_language`); the cross K/V
        unquantized, as the language step of the configuration has them."""
        feats = self.encode(mel)
        tokens = torch.full((mel.shape[0], 1), sot, dtype=torch.long, device=mel.device)
        logits = self.logits(tokens, self.cross_kv(feats, quantized=False))[:, 0]
        return torch.log_softmax(logits[:, lang0:lang0 + self.d["n_langs"]], dim=-1)


def window_logits(ref: Reference, mel: torch.Tensor, prompt: List[int],
                  served: List[int], quantized_kv: bool = True) -> torch.Tensor:
    """Logits (len(served) + 1, vocab) at the positions that chose each
    served token and the one after it, for one window."""
    feats = ref.encode(mel[None])
    cross = ref.cross_kv(feats, quantized=quantized_kv)
    tokens = torch.tensor([prompt + served], dtype=torch.long, device=mel.device)
    return ref.logits(tokens, cross)[0, len(prompt) - 1:]

