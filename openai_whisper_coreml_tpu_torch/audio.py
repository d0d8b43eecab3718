"""Whisper log-mel frontend in PyTorch, and audio file loading.

The counterpart of `openai_whisper_coreml_tpu/audio.py`: the slaney mel
filterbank, the periodic Hann window and the real-DFT matrices are the same
numpy code. `log_mel_spectrogram` computes, in fp32 on the input's device:

  reflect-pad 200 each side, Hann 400-point frames at hop 160 (the last
  frame dropped), |rfft|^2, mel product, log10(max(x, 1e-10)),
  then (max(x, per-sample max - 8) + 4) / 4.

The windowed DFT, the power and the mel product run in the fused K4 kernel
(`ops/mel_kernel.py`, `csrc/mel.cu`) on the card, and in its plain version
`log_mel_kernel_reference` (`torch.matmul`) on the CPU. On the card TF32
must be off for the 1e-3 fidelity gate if the plain version is run there
(`torch.backends.cuda.matmul.allow_tf32 = False`, the default).
"""

from __future__ import annotations

import functools
from typing import Union

import numpy as np
import torch

from .config import HOP_LENGTH, N_FFT, N_SAMPLES, SAMPLE_RATE

__all__ = [
    "mel_filters",
    "hann_window",
    "dft_matrices",
    "log_mel_spectrogram",
    "pad_or_trim",
    "load_audio",
]


def _hertz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3.0
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp  # 15.0
    logstep = np.log(6.4) / 27.0
    log_region = freq >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hertz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3.0
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region,
        min_log_hz * np.exp(logstep * (np.maximum(mels, min_log_mel) - min_log_mel)),
        freqs,
    )
    return freqs


@functools.lru_cache(maxsize=None)
def mel_filters(
    n_mels: int = 80,
    sample_rate: int = SAMPLE_RATE,
    n_fft: int = N_FFT,
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, n_fft//2 + 1), float32.

    Equivalent to librosa.filters.mel(sr, n_fft, n_mels, htk=False,
    norm="slaney").
    """
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs, dtype=np.float64)

    mel_min = _hertz_to_mel(0.0)
    mel_max = _hertz_to_mel(sample_rate / 2.0)
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hertz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalisation.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def hann_window(n: int = N_FFT) -> np.ndarray:
    """Periodic Hann window — (1 - cos(2 pi i / n)) / 2."""
    i = np.arange(n, dtype=np.float64)
    return ((1.0 - np.cos(2.0 * np.pi * i / n)) / 2.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def dft_matrices(n_fft: int = N_FFT) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT as two (n_fft, n_fft//2+1) matmul operands (cos, -sin):
    frames @ cos -> Re(rfft), frames @ sin -> Im(rfft)."""
    n_freqs = n_fft // 2 + 1
    k = np.arange(n_fft, dtype=np.float64)[:, None]
    f = np.arange(n_freqs, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * f / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def log_mel_spectrogram(audio: Union[np.ndarray, torch.Tensor],
                        n_mels: int = 80) -> torch.Tensor:
    """Whisper log-mel spectrogram.

    audio: float waveform (n_samples,) or (batch, n_samples) at 16 kHz, with
    n_samples a multiple of HOP_LENGTH (use `pad_or_trim` first). The
    result lies on the input tensor's device (cpu for numpy input).
    Returns (n_mels, n_frames) or (batch, n_mels, n_frames) float32.
    """
    x = torch.as_tensor(audio)
    if x.ndim not in (1, 2):
        raise ValueError(f"audio must be 1D or 2D, got shape {tuple(x.shape)}")
    n_samples = x.shape[-1]
    if n_samples % HOP_LENGTH != 0:
        raise ValueError(
            f"n_samples ({n_samples}) must be a multiple of {HOP_LENGTH}; "
            "use pad_or_trim first")
    from .ops.mel_kernel import log_mel

    return log_mel(x, n_mels)


def pad_or_trim(array, length: int = N_SAMPLES, *, axis: int = -1):
    """Zero-pad or truncate audio to `length` samples along `axis`.

    numpy in, numpy out (host side); a tensor stays a tensor on its device.
    """
    is_tensor = isinstance(array, torch.Tensor)
    if not is_tensor:
        array = np.asarray(array)
    n = array.shape[axis]
    if n > length:
        sl = [slice(None)] * array.ndim
        sl[axis] = slice(0, length)
        return array[tuple(sl)]
    if n < length:
        if is_tensor:
            shape = list(array.shape)
            shape[axis] = length - n
            return torch.cat([array, array.new_zeros(shape)], dim=axis)
        pad_widths = [(0, 0)] * array.ndim
        pad_widths[axis] = (0, length - n)
        return np.pad(array, pad_widths)
    return array


def load_audio(path: str, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Load an audio file as float32 mono at `sample_rate` (host side). WAV
    is decoded in Python; other formats need the optional native decoder
    (`native/libwhisper_audio.so`)."""
    from .utils import audio_io

    return audio_io.load_audio(path, sample_rate)
