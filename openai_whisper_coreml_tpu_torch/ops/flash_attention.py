"""Encoder flash attention: the Hopper kernel, its wrapper and its plain version.

`flash_attention(q, k, v)` is the port of the JAX package's
`ops/flash_attention.py:_fa_kernel_single` (non-causal attention whose keys
all fit one block; Whisper's encoder at T=1500). On a CUDA tensor it
launches the hand-written kernel in `csrc/flash_attention.cu` or raises; on
a CPU tensor it runs `flash_attention_reference`, the same math in PyTorch.
There is no fallback from the card to the plain version.

The kernel's causal mode and the online multi-block kernel (`_fa_kernel`)
with its recompute backward are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library

HEAD_DIM = 64  # the kernel is compiled for D = 64 (every Whisper size)

# Kernel launches made by `flash_attention` (a plain count; callers reset it).
launches = 0

_ENTRY = {torch.bfloat16: "whisper_fa_forward_bf16",
          torch.float32: "whisper_fa_forward_f32"}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math, (B,Tq,H,D) -> (B,Tq,H,D).

    q is upcast to fp32, scaled by D^-0.5 and rounded back to its type;
    S = qK^T in fp32; a plain fp32 softmax; P is rounded to V's type before
    P V (fp32 accumulation); then division by l with an l == 0 guard.
    """
    d = q.shape[-1]
    qs = (q.float() * d ** -0.5).to(k.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    o = o * torch.where(l == 0, 1.0, 1.0 / l)
    return o.transpose(1, 2).to(q.dtype)


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library; sets its C types."""
    lib = load_library("flash_attention", "flash_attention.cu")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
    return lib


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _ENTRY or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash kernel takes bf16 or fp32 q/k/v of one type, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,Tq,H,D) and k, v (B,Tk,H,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if d != HEAD_DIM or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"flash kernel needs D={HEAD_DIM} and matching "
                         f"B, H: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if k.shape[1] < 1:
        raise ValueError("flash kernel needs at least one key")
    vec = 16 // q.element_size()  # the kernel reads 16-byte vectors
    for name, x in (("q", q), ("k", k), ("v", v)):
        if (x.stride(3) != 1 or x.data_ptr() % 16
                or any(s % vec for s in x.stride()[:3])):
            raise ValueError(
                f"{name} must have a contiguous, 16-byte-aligned head dim "
                f"(strides {x.stride()}, data_ptr {x.data_ptr():#x})")


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention (B,Tq,H,D) x (B,Tk,H,D) -> (B,Tq,H,D), q's dtype.

    CUDA tensors launch the Hopper kernel (bf16 or fp32, D = 64) on the
    current stream or raise; CPU tensors take `flash_attention_reference`.
    """
    global launches
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check_cuda(q, k, v)
    fn = getattr(load_kernel(), _ENTRY[q.dtype])
    b, tq, h, d = q.shape
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, tq, k.shape[1], h, *strides, d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out
