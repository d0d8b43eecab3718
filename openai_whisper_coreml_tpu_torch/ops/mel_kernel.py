"""Log-mel frontend: the Hopper kernel, its wrapper and its plain version.

`log_mel(audio, n_mels)` is the port of the JAX package's
`ops/mel_kernel.py:log_mel_pallas`: it reflect-pads the audio, runs the
fused kernel (windowed real DFT -> power -> mel -> log10; the kernel
computes the DFT as a 400-point real FFT per frame) and applies the
per-sample epilogue max(x, max - 8), (x + 4) / 4, then the transpose to
(B, n_mels, T). The epilogue stays plain PyTorch, as it stays outside the
Pallas kernel in JAX. On a CUDA tensor `log_mel_kernel` launches the
hand-written kernel in `csrc/mel.cu` or raises; on a CPU tensor
`log_mel_kernel_reference` runs the same math in PyTorch. There is no
fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..audio import dft_matrices, hann_window, mel_filters
from ..config import HOP_LENGTH, N_FFT
from ._build import count_launch, load_library

N_BINS = N_FFT // 2 + 1  # 201
# The kernel's table (kTableFloats in csrc/mel.cu): 425 complex twiddles,
# then the Hann window. The wrapper passes the length it built, and the
# kernel refuses to launch on any other.
N_TWIDDLES = 425
TABLE_FLOATS = 2 * N_TWIDDLES + N_FFT

# Kernel launches made by `log_mel_kernel` (an int that callers reset;
# `count_launch` adds to it under a lock).
launches = 0


@functools.lru_cache(maxsize=None)
def windowed_dft_matrices() -> tuple[np.ndarray, np.ndarray]:
    """(400, 201) cos / -sin real-DFT matrices with the Hann window folded in."""
    w = hann_window(N_FFT)[:, None]
    cos_m, sin_m = dft_matrices(N_FFT)
    return (cos_m * w).astype(np.float32), (sin_m * w).astype(np.float32)


def twiddles(n: int, e) -> np.ndarray:
    """exp(-2 pi i e / n), complex128, with the parts that are exactly 0
    (cos and sin at multiples of pi / 2) set to 0, not left at fp64's
    rounding of pi."""
    w = np.exp(-2j * np.pi * (np.asarray(e) % n) / n)
    return np.where(np.abs(w.real) < 1e-12, 0, w.real) + 1j * np.where(
        np.abs(w.imag) < 1e-12, 0, w.imag)


@functools.lru_cache(maxsize=None)
def fft_table() -> np.ndarray:
    """The kernel's table, (TABLE_FLOATS,) fp32: the twiddles of its FFT's
    three stages as (re, im) pairs, computed in fp64 and rounded once,
    then the Hann window. Stage A's W200^(n2 k1) at 25 k1 + n2 (k1 < 8,
    n2 < 25), stage B's W25^e (e < 25), stage C's W400^k (k < 200)."""
    k1, n2 = np.meshgrid(np.arange(8), np.arange(25), indexing="ij")
    w = np.concatenate([twiddles(200, k1 * n2).ravel(), twiddles(25, np.arange(25)),
                        twiddles(400, np.arange(200))])
    assert w.size == N_TWIDDLES
    pairs = np.stack([w.real, w.imag], axis=1).astype(np.float32).ravel()
    return np.concatenate([pairs, hann_window(N_FFT)])


def filterbank_pack(n_mels: int) -> tuple[np.ndarray, np.ndarray]:
    """The filterbank as the kernel reads it: for each group of 4 filters
    the [lo, hi) bins where one is non-zero and the row where its weights
    start, (n_mels / 4, 3) int32; and those bins' 4 weights, (rows, 4)
    fp32, group after group."""
    groups = mel_filters(n_mels).reshape(n_mels // 4, 4, N_BINS)
    nonzero = groups.any(axis=1)
    lo = nonzero.argmax(axis=1)
    hi = N_BINS - nonzero[:, ::-1].argmax(axis=1)
    pack = np.concatenate([g[:, a:z].T for g, a, z in zip(groups, lo, hi)])
    start = np.concatenate([[0], np.cumsum(hi - lo)[:-1]])
    return (np.stack([lo, hi, start], axis=1).astype(np.int32),
            np.ascontiguousarray(pack, dtype=np.float32))


@functools.lru_cache(maxsize=None)
def _tables(n_mels: int, device: torch.device):
    """The kernel's constant operands on `device`: `fft_table()` and
    `filterbank_pack(n_mels)`'s weights and ranges."""
    ranges, pack = filterbank_pack(n_mels)
    return (torch.from_numpy(fft_table()).to(device), torch.from_numpy(pack).to(device),
            torch.from_numpy(ranges).to(device))


def log_mel_kernel_reference(audio_padded: torch.Tensor,
                             n_mels: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: reflect-padded audio (B, 160 T +
    400) fp32 -> unclamped log10(max(mel, 1e-10)), (B, T, n_mels) fp32."""
    n_frames = (audio_padded.shape[-1] - N_FFT) // HOP_LENGTH
    frames = audio_padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]
    cw, sw = (torch.from_numpy(m).to(audio_padded.device)
              for m in windowed_dft_matrices())
    re = frames @ cw
    im = frames @ sw
    fbt = torch.from_numpy(mel_filters(n_mels).T).to(audio_padded.device)
    mel = (re * re + im * im) @ fbt
    return torch.log10(torch.clamp(mel, min=1e-10))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C types of the kernel's entry point in `lib`."""
    fn = lib.whisper_log_mel_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p])
    return lib


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library; sets its C types."""
    return bind(load_library("mel", "mel.cu"))


def log_mel_kernel(audio_padded: torch.Tensor, n_mels: int) -> torch.Tensor:
    """Reflect-padded audio (B, 160 T + 400) fp32 -> (B, T, n_mels) unclamped
    log10 mel. CUDA tensors launch the Hopper kernel on the current stream
    or raise; CPU tensors take `log_mel_kernel_reference`."""
    if audio_padded.device.type == "cpu":
        return log_mel_kernel_reference(audio_padded, n_mels)
    if audio_padded.device.type != "cuda":
        raise ValueError(f"log_mel_kernel runs on cuda or cpu, not "
                         f"{audio_padded.device}")
    if audio_padded.dtype != torch.float32 or audio_padded.ndim != 2:
        raise TypeError(f"mel kernel takes (B, N) fp32 audio, got "
                        f"{tuple(audio_padded.shape)} {audio_padded.dtype}")
    b, n = audio_padded.shape
    if n < N_FFT or (n - N_FFT) % HOP_LENGTH or audio_padded.stride(1) != 1:
        raise ValueError(f"mel kernel needs contiguous rows of 160 T + 400 "
                         f"samples, got {n} (strides {audio_padded.stride()})")
    if n_mels % 4:
        raise ValueError(f"mel kernel needs n_mels % 4 == 0, got {n_mels}")
    n_frames = (n - N_FFT) // HOP_LENGTH
    table, fb_pack, fb_range = _tables(n_mels, audio_padded.device)
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32,
                      device=audio_padded.device)
    if n_frames == 0 or b == 0:
        return out
    fn = load_kernel().whisper_log_mel_f32
    with torch.cuda.device(audio_padded.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(audio_padded.data_ptr(), audio_padded.stride(0), n, b,
                 n_frames, table.data_ptr(), table.numel(), fb_pack.data_ptr(),
                 fb_range.data_ptr(), n_mels, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"log-mel kernel launch failed: CUDA error {err}")
    count_launch(__name__)
    return out


def epilogue(log_spec: torch.Tensor) -> torch.Tensor:
    """The per-sample epilogue outside the kernel: (B, T, n_mels) unclamped
    log10 mel -> max(x, max - 8), (x + 4) / 4, as (B, n_mels, T)."""
    log_max = log_spec.amax(dim=(1, 2), keepdim=True)
    return ((torch.maximum(log_spec, log_max - 8.0) + 4.0) / 4.0).transpose(1, 2)


def log_mel(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """Whisper log-mel of (B, N) or (N,) audio at 16 kHz, N % 160 == 0, on
    the audio's device: (B, n_mels, N / 160) or (n_mels, N / 160) fp32."""
    if audio.ndim == 1:
        return log_mel(audio[None], n_mels)[0]
    pad = N_FFT // 2
    padded = torch.nn.functional.pad(audio.float()[:, None], (pad, pad),
                                     mode="reflect")[:, 0]
    return epilogue(log_mel_kernel(padded, n_mels)).contiguous()
