"""Single-query cross-attention with an int8 query over int8 K/V: the
Hopper kernel, its wrapper and its plain versions.

`sqa_cross_int8(q, k8, k_scale, v8, v_scale, s_len=..., av_int8=...)` is
the port of the JAX package's `ops/sqa_v3.py:sqa_cross_int8` (TPU kernel
`_sqa3_kernel`, K2): the query is row-quantised to int8, Q.K is an
int8 x int8 -> int32 dot with K's column scale and the query's row scale
folded into one multiplier, columns at or past `s_len` (the 1500 -> 1536
lane padding) are masked, and A.V runs either on int8 weights
(`av_int8=True`: V's column scale folded into the softmax weights, which
are then row-quantised) or on bf16 weights over int8 V.

As in JAX no decode path calls it: the decode step's int8 cross-attention
dequantises inline (K6, `ops/sqa_int8.py`, on the card), and K2's int8
query gives other numbers than that production math. Its one path is the
probe chain `tools/torch_sqa_v3_probe.py`.

On a CUDA tensor the wrapper launches the kernel in `csrc/sqa.cu`, where
the query's quantisation and the scale fold are fused in, or raises; on a
CPU tensor it runs `sqa_cross_int8_reference`, the kernel's math step by
step in PyTorch. `sqa_cross_reference` is JAX's inline-dequant oracle.
The kernel is K6's kernel body in a mode of its own: each row's columns
split across a thread-block cluster of `split_count(cols, batch * heads)`
CTAs (`ops/sqa_int8.py`; `splits` forces another size), combined over
distributed shared memory in the same launch, with one more exchange for
the row's largest weight when A.V runs on int8 weights.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..quantize import ieee_div
from ._build import count_launch
from .sqa_int8 import MASK_VALUE, SqaArgs, _check_int8_kv, launch_args
from .sqa_int8 import load_kernel as _load_sqa

# kV3MaxCols in csrc/sqa.cu: at 12288 columns the rule's clusters of 16
# CTAs stage 768 columns a CTA
MAX_COLS = 12288

# Kernel launches made by `sqa_cross_int8` (an int that callers reset;
# `count_launch` adds to it under a lock).
launches = 0

_ENTRY = {torch.bfloat16: "whisper_sqa_v3_bf16",
          torch.float32: "whisper_sqa_v3_f32"}


def quantize_q_rows(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, D) float -> (int8, (B, H, 1) fp32 row scales); rounds half to
    even, as jnp.round does."""
    q32 = q.float()
    scale = ieee_div(q32.abs().amax(dim=-1, keepdim=True), 127.0).clamp(min=1e-12)
    q8 = torch.clamp(torch.round(q32 / scale), -127, 127).to(torch.int8)
    return q8, scale


def sqa_cross_int8_reference(q: torch.Tensor, k8: torch.Tensor, k_scale: torch.Tensor,
                             v8: torch.Tensor, v_scale: torch.Tensor, *,
                             s_len: Optional[int] = None,
                             av_int8: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math, (B,H,D) -> (B,H,D) in
    q's dtype.

    Both integer products are exact: the Q.K dot (|sum| <= 64 * 127^2 <
    2^24) in fp32, the int8 A.V sum (up to 1500 * 127^2 > 2^24) in fp64,
    where fp32 would round it.
    """
    d = q.shape[-1]
    s = k8.shape[-1]
    s_len = s if s_len is None else s_len
    q8, qs = quantize_q_rows(q)
    ks = k_scale[:, :, 0, :] * qs  # the folded (B, H, S) multiplier
    dot = torch.einsum("bhd,bhds->bhs", q8.float(), k8.float())
    lg = dot * ks * d ** -0.5
    cols = torch.arange(s, device=q.device)
    lg = torch.where(cols < s_len, lg, MASK_VALUE)
    p = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    pv = p * v_scale[:, :, 0, :]
    if av_int8:
        wmax = pv.amax(dim=-1, keepdim=True).clamp(min=1e-20)
        w8 = torch.clamp(torch.round(pv * ieee_div(127.0, wmax)), -127, 127)
        acc = torch.einsum("bhs,bhds->bhd", w8.double(), v8.double()).float()
        out = acc * ieee_div(wmax, 127.0) / denom
    else:
        acc = torch.einsum("bhs,bhds->bhd", pv.bfloat16().float(), v8.float())
        out = acc / denom
    return out.to(q.dtype)


def sqa_cross_reference(q: torch.Tensor, k8: torch.Tensor, k_scale: torch.Tensor,
                        v8: torch.Tensor, v_scale: torch.Tensor,
                        s_len: Optional[int] = None) -> torch.Tensor:
    """JAX's inline-dequant oracle with the same masking: the float query
    against dequantised K/V, the production decode step's math."""
    s = k8.shape[-1]
    s_len = s if s_len is None else s_len
    d = q.shape[-1]
    kd = k8.float() * k_scale
    vd = v8.float() * v_scale
    lg = torch.einsum("bhd,bhds->bhs", q.float(), kd) * d ** -0.5
    if s_len != s:
        lg = torch.where(torch.arange(s, device=q.device) < s_len, lg, -1e30)
    w = torch.softmax(lg, dim=-1)
    return torch.einsum("bhs,bhds->bhd", w, vd).to(q.dtype)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C types of K2's entry points in `lib`."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(SqaArgs), ctypes.c_int] + [ctypes.c_void_p] * 6
    return lib


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load the library that holds K2 (with K3
    and K6, `csrc/sqa.cu`); sets K2's C types."""
    return bind(_load_sqa())


def sqa_cross_int8(q: torch.Tensor, k8: torch.Tensor, k_scale: torch.Tensor,
                   v8: torch.Tensor, v_scale: torch.Tensor, *,
                   s_len: Optional[int] = None, av_int8: bool = True,
                   splits: int = 0) -> torch.Tensor:
    """One cross-attention decode step: (B, H, D) queries (bf16 or fp32)
    against int8 (B, H, D, S) K/V with fp32 (B, H, 1, S) column scales, the
    first `s_len` columns real (default S); returns (B, H, D) in q's dtype.

    CUDA tensors launch the Hopper kernel (D = 64) on the current stream,
    with `splits` CTAs a row (0: the split rule), or raise (also when a
    forced split leaves a CTA more columns than its shared memory holds);
    CPU tensors take `sqa_cross_int8_reference`.
    """
    if q.device.type == "cpu":
        return sqa_cross_int8_reference(q, k8, k_scale, v8, v_scale, s_len=s_len,
                                        av_int8=av_int8)
    if q.device.type != "cuda":
        raise ValueError(f"sqa_cross_int8 runs on cuda or cpu, not {q.device}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"sqa_cross_int8 takes a bf16 or fp32 query, got {q.dtype}")
    b, h, d = q.shape
    s = k8.shape[-1]
    s_len = s if s_len is None else int(s_len)
    if not 1 <= s_len <= s:
        raise ValueError(f"s_len must be in 1..{s}, got {s_len}")
    _check_int8_kv(q.device, k8, k_scale, v8, v_scale, (b, h, d, s), MAX_COLS)
    if q.stride(-1) != 1:
        raise ValueError(f"sqa_cross_int8 needs a unit-stride q, got strides {q.stride()}")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    fn = getattr(load_kernel(), _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        # s_len as K6's bounds: columns 0 <= c <= s_len - 1
        args = launch_args(s_len - 1, 0, q.stride()[:2], out.stride()[:2], k8, v8,
                           k_scale, v_scale, splits)
        err = fn(args, int(av_int8), q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(),
                 v8.data_ptr(), v_scale.data_ptr(), out.data_ptr())
    if err != 0:
        raise RuntimeError(f"sqa_cross_int8 kernel launch failed: CUDA error {err}")
    count_launch(__name__)
    return out
