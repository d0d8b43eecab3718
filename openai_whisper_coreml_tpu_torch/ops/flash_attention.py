"""Flash attention: the Hopper kernel, its wrapper, its plain version and
its gradient.

`flash_attention(q, k, v, causal=...)` ports two TPU kernels of the JAX
package's `ops/flash_attention.py`: `_fa_kernel_single` (K1: all keys in
one <= 1536 block; non-causal for Whisper's encoder at T=1500, causal for
the decoder's teacher forcing) and `_fa_kernel` (K5: the online-softmax
kernel over several KV blocks, which JAX runs when Tk > 1536). One CUDA
kernel, `csrc/flash_attention.cu`, computes both: it walks key tiles with
the online recurrence whatever Tk is, and in causal mode skips the tiles
above the diagonal. In bf16 it is a warp-specialised Hopper kernel (TMA
loads into a ring of shared-memory stages, both products on `wgmma`); in
fp32 a plain SIMT kernel, kept for parity checks.

On a CUDA tensor the forward launches that kernel or raises; on a CPU
tensor it runs `flash_attention_reference`, the same math in PyTorch.
There is no fallback from the card to the plain version.

The gradient is the JAX package's `_flash_diff_bwd`: the backward
recomputes the plain `layers.attention_core` (with a lower-triangular mask
when causal) and takes its gradient. The JAX package has no backward
kernel, and neither has the port: the (Tq, Tk) scores exist only inside
the backward, one layer at a time under rematerialised blocks.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import count_launch, load_library

HEAD_DIM = 64  # the kernel is compiled for D = 64 (every Whisper size)
BLOCK_K = 1536  # JAX's largest KV block: more keys run its online kernel (K5)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# Kernel launches made by `flash_attention`, by the TPU kernel each one
# stands in for (ints that callers reset; `count_launch` adds to them under a
# lock): K1 non-causal, K1's causal mode, and K5 (Tk > 1536, causal or not).
launches = 0
launches_causal = 0
launches_online = 0

_ENTRY = {torch.bfloat16: "whisper_fa_forward_bf16",
          torch.float32: "whisper_fa_forward_f32"}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math, (B,Tq,H,D) -> (B,Tq,H,D).

    q is upcast to fp32, scaled by D^-0.5 and rounded back to its type;
    S = qK^T in fp32; causal sets S to MASK_VALUE where key > query (a
    select, as the TPU kernels mask); a plain fp32 softmax; P is rounded to
    V's type before P V (fp32 accumulation); then division by l with an
    l == 0 guard.
    """
    d = q.shape[-1]
    qs = (q.float() * d ** -0.5).to(k.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if causal:
        _check_causal(q, k)
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    o = o * torch.where(l == 0, 1.0, 1.0 / l)
    return o.transpose(1, 2).to(q.dtype)


def _check_causal(q: torch.Tensor, k: torch.Tensor) -> None:
    if q.shape[1] != k.shape[1]:
        # the mask aligns queries and keys at position 0; a suffix query
        # (incremental decode) would mask almost everything
        raise ValueError(f"causal flash attention requires tq == tk, got "
                         f"{q.shape[1]} vs {k.shape[1]}")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C types of a built kernel library's entry points."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    return bind(load_library("flash_attention", "flash_attention.cu"))


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
    # 16-byte vectors (fp32) and TMA's rule for bf16: a 16-byte-aligned
    # base and strides that are multiples of 16 bytes
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if (x.stride(3) != 1 or x.data_ptr() % 16
                or any(s % vec for s in x.stride()[:3])):
            raise ValueError(
                f"{name} must have a contiguous, 16-byte-aligned head dim "
                f"(strides {x.stride()}, data_ptr {x.data_ptr():#x})")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    """One launch of the kernel on the current stream; counts it."""
    _check_cuda(q, k, v)
    fn = getattr(load_kernel(), _ENTRY[q.dtype])
    b, tq, h, d = q.shape
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, tq, k.shape[1], h, *strides, d ** -0.5, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err} (1: a tensor map did not encode)")
    if k.shape[1] > BLOCK_K:
        count_launch(__name__, "launches_online")
    elif causal:
        count_launch(__name__, "launches_causal")
    else:
        count_launch(__name__)
    return out


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool) -> torch.Tensor:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if causal:
        _check_causal(q, k)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return _launch(q, k, v, causal)


class _FlashAttention(torch.autograd.Function):
    """Kernel (or plain) forward; backward by recompute through the plain
    `attention_core`, as JAX's `_flash_diff_bwd` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad):
        from ..models.layers import attention_core

        q, k, v = ctx.saved_tensors
        mask = None
        if ctx.causal:
            # (Tq, Tk) shaped: the backward does not bake in Tq == Tk
            mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                              device=q.device).tril()
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_() for x in (q, k, v)]
            out = attention_core(*qkv, mask=mask)
            grads = torch.autograd.grad(out, qkv, grad)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False) -> torch.Tensor:
    """Attention (B,Tq,H,D) x (B,Tk,H,D) -> (B,Tq,H,D) in q's dtype,
    differentiable in q, k and v on both devices.

    CUDA tensors launch the Hopper kernel (bf16 or fp32, D = 64, any Tk >= 1;
    causal needs Tq == Tk) on the current stream or raise; CPU tensors take
    `flash_attention_reference`.
    """
    return _FlashAttention.apply(q, k, v, causal)
