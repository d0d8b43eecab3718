"""The linear with its epilogue in the product: the Hopper kernel, its
wrapper and its plain version.

`fused_linear(x, w, scale, b)` computes `bf16(x @ w * scale + b)` for a
bf16 (M, K) x and a bf16 (K, N) w, as the JAX package's `linear` does:
the product in fp32, then the per-output-channel scale and the bias each
added in fp32, then one cast. On a CUDA tensor it launches the
hand-written kernel in `csrc/fused_linear.cu`, whose epilogue does the
scale, the bias and the cast on the accumulators in registers, so the
fp32 product never reaches device memory; or it raises. On a CPU tensor
`fused_linear_reference` runs the same math in PyTorch. There is no
fallback from the card to the plain version.

The kernel replaces no TPU kernel (XLA fuses the epilogue into the dot
there). At the encoder's shapes it is bound by the tensor cores: a 30 s
window's encoder and cross-attention K/V linears of large-v3 are about
2.2 TFLOP against 1.35 GB of bf16 output. `models.layers.linear` takes it
for large row counts (`layers.FUSED_MIN_ROWS`); PERF.md has its times.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ._build import count_launch, load_library

# Kernel launches made by `fused_linear` (an int that callers reset;
# `count_launch` adds to it under a lock).
launches = 0


def fused_linear_reference(x: torch.Tensor, w: torch.Tensor,
                           scale: Optional[torch.Tensor] = None,
                           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the unfused path's own product
    and epilogue, `models.layers.fp32_product` (on the card one GEMM with
    an fp32 output, elsewhere the operands upcast) and
    `models.layers.scale_bias_cast`, so one function owns the rounding."""
    # imported here: models.layers imports this module
    from ..models.layers import fp32_product, scale_bias_cast

    return scale_bias_cast(fp32_product(x, w), x.dtype, scale, b)


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = load_library("fused_linear", "fused_linear.cu")
    fn = lib.whisper_fused_linear_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def _check_cuda(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
                b: Optional[torch.Tensor]) -> None:
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"fused linear takes bf16 x and w, got {x.dtype}, {w.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"need x (M, K) and w (K, N); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if m < 1 or k % 8 or n % 8:
        # TMA's rule: rows of a multiple of 16 bytes
        raise ValueError(f"fused linear needs M >= 1 and K, N multiples of 8; "
                         f"got M={m}, K={k}, N={n}")
    for name, v in (("scale", scale), ("b", b)):
        if v is not None and (v.dtype != torch.float32 or tuple(v.shape) != (n,)):
            raise ValueError(f"{name} must be fp32 ({n},), got {v.dtype} "
                             f"{tuple(v.shape)}")
    for name, t in (("x", x), ("w", w), ("scale", scale), ("b", b)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                             f"(strides {t.stride()}, data_ptr {t.data_ptr():#x})")


def fused_linear(x: torch.Tensor, w: torch.Tensor,
                 scale: Optional[torch.Tensor] = None,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bf16(x @ w * scale + b): x (M, K), w (K, N), scale and b fp32 (N,)
    or None; (M, N) in x's dtype.

    CUDA tensors launch the Hopper kernel on the current stream (bf16 x
    and w, contiguous, K and N multiples of 8) or raise; CPU tensors take
    `fused_linear_reference`. No gradient: callers that need one take the
    plain path (`models.layers.linear`)."""
    if x.device.type == "cpu":
        return fused_linear_reference(x, w, scale, b)
    if x.device.type != "cuda":
        raise ValueError(f"fused_linear runs on cuda or cpu, not {x.device}")
    _check_cuda(x, w, scale, b)
    m, n = x.shape[0], w.shape[1]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = load_kernel().whisper_fused_linear_bf16(
            x.data_ptr(), w.data_ptr(), None if scale is None else scale.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(), m, n, x.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"fused linear kernel launch failed: CUDA error {err} "
                           f"(1: a tensor map did not encode)")
    count_launch(__name__)
    return out
