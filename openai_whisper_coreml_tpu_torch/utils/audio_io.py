"""Host-side audio IO: WAV decode + resampling (port of `utils/audio_io.py`).

A copy of the JAX package's module: the port cannot import that one, whose
package `__init__` imports jax. Two tiers, as there:

  1. the optional native C++ decoder (native/audio_io.cpp ->
     libwhisper_audio.so, loaded via ctypes): WAV and FLAC, polyphase
     resampling;
  2. pure Python (stdlib `wave` + NumPy + scipy polyphase resample) with
     identical semantics for WAV.

This is the host's choice of file decoder; no device work happens here.
"""

from __future__ import annotations

import ctypes
import os
import wave
from typing import Optional

import numpy as np

_NATIVE_LIB_ENV = "WHISPER_TPU_AUDIO_LIB"
_native_lib: Optional[ctypes.CDLL] = None
_native_checked = False


def _find_native_lib() -> Optional[ctypes.CDLL]:
    global _native_lib, _native_checked
    if _native_checked:
        return _native_lib
    _native_checked = True
    candidates = []
    if os.environ.get(_NATIVE_LIB_ENV):
        candidates.append(os.environ[_NATIVE_LIB_ENV])
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates.append(os.path.join(here, "native", "libwhisper_audio.so"))
    for path in candidates:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.wa_load_wav.restype = ctypes.c_longlong
                lib.wa_load_wav.argtypes = [
                    ctypes.c_char_p,
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ]
                lib.wa_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
                lib.wa_resample.restype = ctypes.c_longlong
                lib.wa_resample.argtypes = [
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_longlong,
                    ctypes.c_int,
                    ctypes.c_int,
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ]
                if hasattr(lib, "wa_load_batch"):
                    lib.wa_load_batch.restype = ctypes.c_longlong
                    lib.wa_load_batch.argtypes = [
                        ctypes.POINTER(ctypes.c_char_p),
                        ctypes.c_longlong,
                        ctypes.c_int,
                        ctypes.c_int,
                        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                        ctypes.POINTER(ctypes.c_longlong),
                    ]
                _native_lib = lib
                return lib
            except OSError:
                continue
    return None


def _mulaw_to_linear(u8: np.ndarray) -> np.ndarray:
    """G.711 mu-law bytes -> int16-scale float32 (ITU-T G.711 table math)."""
    u = (~u8.astype(np.uint8)).astype(np.int32)
    t = ((u & 0x0F) << 3) + 0x84
    t = t << ((u >> 4) & 0x07)
    lin = np.where(u & 0x80, 0x84 - t, t - 0x84)
    return lin.astype(np.float32)


def _alaw_to_linear(a8: np.ndarray) -> np.ndarray:
    """G.711 A-law bytes -> int16-scale float32."""
    a = (a8.astype(np.uint8) ^ 0x55).astype(np.int32)
    seg = (a >> 4) & 0x07
    t = (a & 0x0F) << 4
    t = np.where(seg == 0, t + 8,
                 np.where(seg == 1, t + 0x108,
                          ((t + 0x108) << np.maximum(seg - 1, 0))))
    lin = np.where(a & 0x80, t, -t)
    return lin.astype(np.float32)


def _decode_g711_riff(raw: bytes) -> tuple[np.ndarray, int]:
    """Minimal RIFF walk for compressed WAVs the stdlib wave module refuses
    (format 6 = A-law, 7 = mu-law — telephony captures)."""
    if len(raw) < 12 or raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos, fmt = 12, None
    data = b""
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        clen = int.from_bytes(raw[pos + 4 : pos + 8], "little")
        body = raw[pos + 8 : pos + 8 + clen]
        if cid == b"fmt " and len(body) >= 16:
            code = int.from_bytes(body[0:2], "little")
            if code == 0xFFFE and len(body) >= 26:  # EXTENSIBLE
                code = int.from_bytes(body[24:26], "little")
            fmt = (code, int.from_bytes(body[2:4], "little"),
                   int.from_bytes(body[4:8], "little"))
        elif cid == b"data":
            data = body
        pos += 8 + clen + (clen & 1)
    if fmt is None or not data:
        raise ValueError("WAV missing fmt/data chunks")
    code, n_channels, rate = fmt
    if code == 7:
        lin = _mulaw_to_linear(np.frombuffer(data, np.uint8))
    elif code == 6:
        lin = _alaw_to_linear(np.frombuffer(data, np.uint8))
    else:
        raise ValueError(f"unsupported WAV format code {code}")
    out = lin / 32768.0
    if n_channels > 1:
        out = out[: len(out) - len(out) % n_channels]
        out = out.reshape(-1, n_channels).mean(axis=1)
    return out.astype(np.float32), rate


def _load_wav_python(path_or_file) -> tuple[np.ndarray, int]:
    """Decode a WAV (path or binary file-like) to float32 in [-1, 1],
    mono-averaged. Handles 8/16/24/32-bit integer PCM plus G.711
    mu-law/A-law (format codes 7/6 — telephony recordings)."""
    try:
        with wave.open(path_or_file, "rb") as wf:
            n_channels = wf.getnchannels()
            width = wf.getsampwidth()
            rate = wf.getframerate()
            n_frames = wf.getnframes()
            raw = wf.readframes(n_frames)
    except (wave.Error, EOFError):
        # wave.Error: compressed formats (retry as G.711);
        # EOFError: empty/truncated header (the RIFF walk raises ValueError)
        if isinstance(path_or_file, (str, bytes, os.PathLike)):
            with open(path_or_file, "rb") as f:
                blob = f.read()
        else:
            path_or_file.seek(0)
            blob = path_or_file.read()
        return _decode_g711_riff(blob)

    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.uint32)
        s = (b[:, 0] << 8) | (b[:, 1] << 16) | (b[:, 2] << 24)
        data = (s.astype(np.int32) >> 8).astype(np.float32) / 8388608.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, rate


def decode_wav_bytes(raw: bytes, sample_rate: int = 16_000) -> np.ndarray:
    """Decode in-memory WAV bytes to float32 mono at `sample_rate` (the HTTP
    upload path; the file loader's width dispatch)."""
    import io

    data, rate = _load_wav_python(io.BytesIO(raw))
    return resample(data, rate, sample_rate)


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling to target_sr (no-op when rates match)."""
    if orig_sr == target_sr:
        return audio.astype(np.float32, copy=False)
    lib = _find_native_lib()
    if lib is not None:
        src = np.ascontiguousarray(audio, dtype=np.float32)
        out_ptr = ctypes.POINTER(ctypes.c_float)()
        n = lib.wa_resample(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            src.size,
            int(orig_sr),
            int(target_sr),
            ctypes.byref(out_ptr),
        )
        if n >= 0:
            out = np.ctypeslib.as_array(out_ptr, shape=(n,)).copy()
            lib.wa_free(out_ptr)
            return out
    from scipy.signal import resample_poly
    from math import gcd

    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g).astype(np.float32)


_NATIVE_SUFFIXES = (".wav", ".flac")  # native lib dispatches by file magic


def load_audio(path: str, sample_rate: int = 16_000) -> np.ndarray:
    """Load audio as float32 mono at `sample_rate` (WAV, or FLAC through the
    native decoder — LibriSpeech/FLEURS ship FLAC)."""
    lib = _find_native_lib()
    native_tried = False
    if lib is not None and path.lower().endswith(_NATIVE_SUFFIXES):
        native_tried = True
        out_ptr = ctypes.POINTER(ctypes.c_float)()
        n = lib.wa_load_wav(path.encode(), int(sample_rate), ctypes.byref(out_ptr))
        if n >= 0:
            out = np.ctypeslib.as_array(out_ptr, shape=(n,)).copy()
            lib.wa_free(out_ptr)
            return out
        # fall through to Python on native decode failure (WAV only)
    if not path.lower().endswith(".wav"):
        if native_tried:
            raise ValueError(
                f"native FLAC decode failed for {path!r}: "
                "file may be corrupt or truncated"
            )
        raise ValueError(
            f"cannot decode {path!r}: non-WAV formats (FLAC) need the native "
            "decoder (build native/ via `make -C native`)"
        )
    data, rate = _load_wav_python(path)
    return resample(data, rate, sample_rate)


def native_batch_loader() -> bool:
    """Whether `load_audio_batch` can take the native threaded loader."""
    lib = _find_native_lib()
    return lib is not None and hasattr(lib, "wa_load_batch")


def load_audio_batch(paths, sample_rate: int = 16_000,
                     n_threads: int = 0) -> list:
    """Load many files in parallel through the native threaded loader.

    The eval harness walks thousands of utterances; serial loads leave the
    host CPU-bound while the card idles. Falls back to serial `load_audio`
    per file when the native library is unavailable (or for paths that are
    not WAV/FLAC). n_threads=0 uses the hardware concurrency. A file that
    fails in the batch is retried through `load_audio` (WAV falls back to
    the Python decoder; a FLAC the native decoder rejects raises, since
    there is no other decoder)."""
    paths = list(paths)
    if (not native_batch_loader()
            or not all(p.lower().endswith(_NATIVE_SUFFIXES) for p in paths)):
        return [load_audio(p, sample_rate) for p in paths]

    lib = _find_native_lib()
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    outs = (ctypes.POINTER(ctypes.c_float) * n)()
    lens = (ctypes.c_longlong * n)()
    lib.wa_load_batch(c_paths, n, int(sample_rate), int(n_threads), outs,
                      lens)
    result = []
    for i in range(n):
        if lens[i] >= 0:
            arr = np.ctypeslib.as_array(outs[i], shape=(lens[i],)).copy()
            lib.wa_free(outs[i])
            result.append(arr)
        else:
            result.append(load_audio(paths[i], sample_rate))
    return result


def save_wav(path: str, audio: np.ndarray, sample_rate: int = 16_000) -> None:
    """Write float32 mono audio to a 16-bit PCM WAV (test-fixture helper)."""
    pcm = np.clip(np.asarray(audio, dtype=np.float64), -1.0, 1.0)
    pcm = np.round(pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm.tobytes())
