"""Fused decode self-attention over the bf16 cache: the Hopper kernel, its
wrapper and its plain version.

`sqa_self(q, k, v, pos, valid_from)` is the port of the JAX package's
`ops/sqa_self.py:sqa_self` (TPU kernel `_sqa_self_kernel`): one query per
row and head against the layer's d-major cache slice (B, H, D, C), columns
valid_from <= c <= pos per row, in one launch instead of the plain
sublayer's string of small ops. `decode_step(self_kernel=True)` runs it on
single-token steps. Like the TPU kernel it computes in bf16 (q, K and V are
rounded to bf16; P is rounded to bf16 before P.V), so fp32 caches do not
take it on the card.

On a CUDA tensor the wrapper launches the kernel in `csrc/sqa.cu` (one
kernel with K6, `ops/sqa_int8.py`, over another K/V format) or raises; on
a CPU tensor it runs `sqa_self_reference`, the same math in PyTorch.
The kernel splits each row's columns across a thread-block cluster as
K6's does (`sqa_int8.split_count`, `splits` to force a size).
There is no fallback from the card to the plain version. `decode_step`
calls the kernel through `sqa_self_layers`, which checks one step's
stacked cache and builds the launch arguments once for all its layers.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import count_launch, load_library
from .sqa_int8 import (HEAD_DIM, MASK_VALUE, MAX_COLS, Bound, LayerAttend, SqaArgs,
                       bound_tensor, check_dmajor, column_mask, launch_args)

# Kernel launches made by `sqa_self` (an int that callers reset;
# `count_launch` adds to it under a lock).
launches = 0

_ENTRY = {torch.bfloat16: "whisper_sqa_self_bf16",
          torch.float32: "whisper_sqa_self_f32"}


def sqa_self_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos: Bound, valid_from: Bound) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math, (B,H,D) -> (B,H,D).

    q, k, v rounded to bf16; fp32 logits times D^-0.5; columns outside
    [valid_from, pos] set to -0.7 FLT_MAX; fp32 softmax; P rounded to bf16
    before P.V with fp32 accumulation; q's dtype.
    """
    d = q.shape[-1]
    qb, kb, vb = (x.to(torch.bfloat16).float() for x in (q, k, v))
    logits = torch.einsum("bhd,bhdc->bhc", qb, kb) * d ** -0.5
    keep = column_mask(k.shape[-1], pos, valid_from, q.device)
    logits = torch.where(keep, logits, MASK_VALUE)
    p = torch.softmax(logits, dim=-1).to(torch.bfloat16).float()
    return torch.einsum("bhc,bhdc->bhd", p, vb).to(q.dtype)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C types of K3's entry points in `lib`."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(SqaArgs)] + [ctypes.c_void_p] * 4
    return lib


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library; sets its C types."""
    return bind(load_library("sqa", "sqa.cu"))


def sqa_self(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: Bound,
             valid_from: Bound, splits: int = 0) -> torch.Tensor:
    """(B,H,D) queries against (B,H,D,C) k, v, attending columns
    valid_from <= c <= pos (ints, device scalars or (B,) per-row bounds);
    returns (B,H,D) in q's dtype.

    CUDA tensors launch the Hopper kernel (D = 64; q, k, v cast to bf16
    first, as the TPU wrapper does; bf16 or fp32 output) on the current
    stream, with `splits` CTAs a row (0: the rule), or raise; CPU tensors
    take `sqa_self_reference`.
    """
    if q.device.type == "cpu":
        return sqa_self_reference(q, k, v, pos, valid_from)
    if q.device.type != "cuda":
        raise ValueError(f"sqa_self runs on cuda or cpu, not {q.device}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"sqa_self returns bf16 or fp32, got a {q.dtype} query")
    b, h, d = q.shape
    c = k.shape[-1]
    if d != HEAD_DIM:
        raise ValueError(f"sqa_self needs D={HEAD_DIM}, got q {tuple(q.shape)}")
    if not 1 <= c <= MAX_COLS:
        raise ValueError(f"sqa_self takes 1..{MAX_COLS} columns, got {c}")
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    check_dmajor("q", qb, (b, h, d))
    for name, x in (("k", kb), ("v", vb)):
        check_dmajor(name, x, (b, h, d, c))
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
    pos = bound_tensor(pos, b, q.device)
    valid_from = bound_tensor(valid_from, b, q.device)
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    fn = getattr(load_kernel(), _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        args = launch_args(pos, valid_from, qb.stride()[:2], out.stride()[:2], kb, vb,
                           splits=splits)
        err = fn(args, qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr())
    if err != 0:
        raise RuntimeError(f"sqa_self kernel launch failed: CUDA error {err}")
    count_launch(__name__)
    return out


def sqa_self_layers(k: torch.Tensor, v: torch.Tensor, pos: Bound,
                    valid_from: Bound, splits: int = 0) -> LayerAttend:
    """`attend(q, l)`: `sqa_self` of one decode step's q (B, 1, H, D)
    against layer l of a stacked (L, B, H, D, C) cache; returns
    (B, 1, H, D) in q's dtype.

    The validated fast entry of a decode step for a bf16 cache: the cache
    and bounds are checked, and the launch arguments and stream fixed, once
    here; each call then checks q's shape, dtype and layout and launches
    with the layer's pointers. Anything else (a cache or q in another
    dtype, which `sqa_self` first casts to bf16) goes through `sqa_self`.
    CPU tensors take the plain version. `splits` as in `sqa_self`."""
    dev = k.device
    if (dev.type != "cuda" or dev.index != torch.cuda.current_device()
            or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16):
        return lambda q, l: sqa_self(q[:, 0], k[l], v[l], pos, valid_from,
                                     splits)[:, None]
    n_layers, batch, heads, d, c = k.shape
    if d != HEAD_DIM:
        raise ValueError(f"sqa_self needs D={HEAD_DIM}, got a cache {tuple(k.shape)}")
    if not 1 <= c <= MAX_COLS:
        raise ValueError(f"sqa_self takes 1..{MAX_COLS} columns, got {c}")
    check_dmajor("k", k, tuple(k.shape))
    check_dmajor("v", v, tuple(k.shape))
    if v.device != dev:
        raise ValueError(f"v on {v.device}, k on {dev}")
    pos_t = bound_tensor(pos, batch, dev)
    vf_t = bound_tensor(valid_from, batch, dev)
    q_shape = (batch, 1, heads, d)  # contiguous: row stride H * D, head stride D
    args = launch_args(pos_t, vf_t, (heads * d, d), (heads * d, d), k[0], v[0],
                       splits=splits)
    ref = ctypes.byref(args)
    fn = load_kernel().whisper_sqa_self_bf16
    tables = [(t.data_ptr(), t.stride(0) * t.element_size()) for t in (k, v)]

    def attend(q: torch.Tensor, l: int) -> torch.Tensor:
        if not 0 <= l < n_layers:
            raise IndexError(f"layer {l} of {n_layers}")
        if (q.dtype != torch.bfloat16 or q.shape != q_shape or not q.is_contiguous()
                or q.device != dev):
            return sqa_self(q[:, 0], k[l], v[l], pos_t, vf_t, splits)[:, None]
        out = torch.empty_like(q)
        err = fn(ref, q.data_ptr(), *(p + l * step for p, step in tables), out.data_ptr())
        if err != 0:
            raise RuntimeError(f"sqa_self kernel launch failed: CUDA error {err}")
        count_launch(__name__)
        return out

    return attend
