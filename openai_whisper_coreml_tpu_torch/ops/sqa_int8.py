"""Single-query attention over int8 K/V: the Hopper kernel, its wrapper and
its plain version.

`sqa_int8(q, k8, k_scale, v8, v_scale, pos, valid_from)` is the port of
the JAX package's `ops/sqa_int8.py:sqa_int8` (TPU kernel `_sqa_kernel`).
The decode step runs it on every single-token step for int8 cross-attention
and for the int8 self-attention cache. It reads K/V in the layout the
caches store them, int8 (B, H, D, S) with fp32 (B, H, 1, S) column scales;
the TPU kernel's packed layout and block-diagonal head packing are Mosaic
workarounds and are not ported. `pos` and `valid_from` may be ints, device
scalars or (B,) per-row bounds (the TPU kernel takes scalars only).

On a CUDA tensor the wrapper launches the kernel in `csrc/sqa.cu` (one
kernel with K3, `ops/sqa_self.py`, over another K/V format) or raises; on
a CPU tensor it runs `sqa_int8_reference`, the same math in PyTorch.
The kernel splits each row's columns across a thread-block cluster of
`split_count(cols, batch * heads)` CTAs (`slice_bounds` gives each CTA's columns) and
combines their shares over distributed shared memory in the same launch;
`splits` forces another cluster size (the split sweep).
There is no fallback from the card to the plain version. `decode_step`
calls the kernel through `sqa_int8_layers`, which checks one step's
stacked K/V and builds the launch arguments once for all its layers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Union

import numpy as np
import torch

from ._build import count_launch, load_library

HEAD_DIM = 64  # the kernel is compiled for D = 64 (every Whisper size)
MAX_COLS = 4096  # kSqaMaxCols in csrc/sqa.cu (K3 and K6)
MAX_SPLITS = 16  # kMaxSplits: the largest cluster (past 8 is non-portable)
# the split rule's constants (kGridCtas, kMinSliceCols, kMaxSliceCols)
GRID_CTAS, MIN_SLICE_COLS, MAX_SLICE_COLS = 320, 56, 384
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

Bound = Union[int, torch.Tensor]

# Kernel launches made by `sqa_int8` (an int that callers reset;
# `count_launch` adds to it under a lock).
launches = 0

_ENTRY = {torch.bfloat16: "whisper_sqa_int8_bf16",
          torch.float32: "whisper_sqa_int8_f32"}


def split_count(cols: int, rows: int) -> int:
    """The kernel's split rule (`split_count` in csrc/sqa.cu), CTAs per
    (row, head) for `rows` = batch x heads: the largest power of two up to 8
    that keeps the grid within GRID_CTAS CTAs and the slices at
    MIN_SLICE_COLS columns or more, raised to the smallest power of two
    (up to MAX_SPLITS) that leaves at most MAX_SLICE_COLS columns a CTA."""
    s = 1
    while s < 8 and 2 * s * rows <= GRID_CTAS and 2 * s * MIN_SLICE_COLS <= cols:
        s *= 2
    while s < MAX_SPLITS and s * MAX_SLICE_COLS < cols:
        s *= 2
    return s


def slice_bounds(lo: int, hi: int, vec_cols: int, splits: int) -> list:
    """Each cluster rank's columns [c0, c1) (`slice_of` in csrc/sqa.cu):
    the row's [lo, hi] widened to whole vectors of `vec_cols` columns and
    cut into `splits` contiguous runs of vectors whose lengths differ by
    one at most. A rank whose run is empty gets c0 == c1."""
    v0 = lo // vec_cols
    n = hi // vec_cols + 1 - v0
    return [((v0 + n * r // splits) * vec_cols, (v0 + n * (r + 1) // splits) * vec_cols)
            for r in range(splits)]


def column_mask(cols: int, pos: Bound, valid_from: Bound,
                device: torch.device) -> torch.Tensor:
    """(B|1, 1, S) bool, True on columns valid_from <= c <= pos (per row)."""
    c = torch.arange(cols, device=device)
    pos = torch.as_tensor(pos, device=device).reshape(-1, 1, 1)
    valid_from = torch.as_tensor(valid_from, device=device).reshape(-1, 1, 1)
    return (c <= pos) & (c >= valid_from)


def sqa_int8_reference(q: torch.Tensor, k8: torch.Tensor, k_scale: torch.Tensor,
                       v8: torch.Tensor, v_scale: torch.Tensor, pos: Bound,
                       valid_from: Bound) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math, (B,H,D) -> (B,H,D).

    q in fp32; int8 -> fp32 K; logits times K's column scale times D^-0.5;
    columns outside [valid_from, pos] set to -0.7 FLT_MAX; fp32 softmax;
    weights times V's column scale, then times int8 -> fp32 V; q's dtype.
    """
    d = q.shape[-1]
    logits = torch.einsum("bhd,bhds->bhs", q.float(), k8.float())
    logits = logits * k_scale[:, :, 0] * d ** -0.5
    keep = column_mask(k8.shape[-1], pos, valid_from, q.device)
    logits = torch.where(keep, logits, MASK_VALUE)
    w = torch.softmax(logits, dim=-1) * v_scale[:, :, 0]
    return torch.einsum("bhs,bhds->bhd", w, v8.float()).to(q.dtype)


class SqaArgs(ctypes.Structure):
    """The launch's scalar arguments, `struct SqaArgs` in `csrc/sqa.cu`:
    per-row bounds as (pointer, element stride, value), strides in elements
    (K/V and scales: one layer's (B, H, D, S) and (B, H, 1, S) slice; K3
    leaves the scales' at 0), the stream, D^-0.5 and the cluster size
    (0: `split_count`)."""

    _fields_ = ([("pos", ctypes.c_void_p), ("pos_stride", ctypes.c_longlong),
                 ("valid_from", ctypes.c_void_p), ("vf_stride", ctypes.c_longlong)]
                + [(n, ctypes.c_longlong) for n in (
                    "q_sb", "q_sh", "k_sb", "k_sh", "k_sd", "ks_sb", "ks_sh",
                    "v_sb", "v_sh", "v_sd", "vs_sb", "vs_sh", "o_sb", "o_sh")]
                + [("stream", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in (
                    "pos_value", "vf_value", "batch", "heads", "cols")]
                + [("sm_scale", ctypes.c_float), ("splits", ctypes.c_int)])


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C types of K6's entry points and of the split rule in `lib`."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(SqaArgs)] + [ctypes.c_void_p] * 6
    lib.whisper_sqa_split_count.restype = ctypes.c_int
    lib.whisper_sqa_split_count.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library; sets its C types."""
    return bind(load_library("sqa", "sqa.cu"))


def bound_tensor(x: Bound, batch: int, device: torch.device) -> Bound:
    """A bound as the kernels take it: a Python int, or an int32 device
    scalar or (B,) vector. The caller keeps the result alive until the
    launch is enqueued (after that the caching allocator may reuse its
    memory: reuse is ordered on the stream)."""
    if isinstance(x, (int, np.integer)):
        return int(x)
    t = x.to(device=device, dtype=torch.int32)
    if t.ndim != 0 and tuple(t.shape) != (batch,):
        raise ValueError(f"a per-row bound must have shape ({batch},), got "
                         f"{tuple(t.shape)}")
    return t


def launch_args(pos: Bound, valid_from: Bound, q_strides: tuple, o_strides: tuple,
                k: torch.Tensor, v: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None, splits: int = 0) -> SqaArgs:
    """SqaArgs for `bound_tensor` bounds, the (row, head) strides of q and
    of the output, one layer's (B, H, D, S) K/V and (B, H, 1, S) scales and
    a cluster size (0: the rule), on the current stream of K's device."""
    if not 0 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits must be 0 (the rule) or 1..{MAX_SPLITS}, got {splits}")
    args = SqaArgs()
    args.splits = splits
    if isinstance(pos, int):
        args.pos_value = pos
    else:
        args.pos, args.pos_stride = pos.data_ptr(), (pos.stride(0) if pos.ndim else 0)
    if isinstance(valid_from, int):
        args.vf_value = valid_from
    else:
        args.valid_from = valid_from.data_ptr()
        args.vf_stride = valid_from.stride(0) if valid_from.ndim else 0
    args.batch, args.heads, d, args.cols = k.shape
    args.q_sb, args.q_sh = q_strides
    args.o_sb, args.o_sh = o_strides
    args.k_sb, args.k_sh, args.k_sd = k.stride()[:3]
    args.v_sb, args.v_sh, args.v_sd = v.stride()[:3]
    if k_scale is not None:
        args.ks_sb, args.ks_sh = k_scale.stride()[:2]
        args.vs_sb, args.vs_sh = v_scale.stride()[:2]
    args.sm_scale = d ** -0.5
    args.stream = torch.cuda.current_stream(k.device).cuda_stream
    return args


def check_dmajor(name: str, x: torch.Tensor, shape: tuple) -> None:
    """x must have `shape` and a unit last (column) stride."""
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name} needs a unit column stride, got {x.stride()}")


def _check_int8_kv(device: torch.device, k8, k_scale, v8, v_scale, shape: tuple,
                   max_cols: int = MAX_COLS) -> None:
    """int8 K/V of `shape` (..., D, S) and fp32 (..., 1, S) scales on `device`."""
    if k8.dtype != torch.int8 or v8.dtype != torch.int8:
        raise TypeError(f"sqa_int8 takes int8 K/V, got {k8.dtype}, {v8.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"sqa_int8 takes fp32 scales, got {k_scale.dtype}, "
                        f"{v_scale.dtype}")
    if shape[-2] != HEAD_DIM:
        raise ValueError(f"sqa_int8 needs D={HEAD_DIM}, got K/V {shape}")
    if not 1 <= shape[-1] <= max_cols:
        raise ValueError(f"sqa_int8 takes 1..{max_cols} columns, got {shape[-1]}")
    scales = shape[:-2] + (1, shape[-1])
    for name, x, want in (("k8", k8, shape), ("v8", v8, shape),
                          ("k_scale", k_scale, scales), ("v_scale", v_scale, scales)):
        check_dmajor(name, x, want)
        if x.device != device:
            raise ValueError(f"{name} on {x.device}, q on {device}")


def sqa_int8(q: torch.Tensor, k8: torch.Tensor, k_scale: torch.Tensor,
             v8: torch.Tensor, v_scale: torch.Tensor, pos: Bound,
             valid_from: Bound, splits: int = 0) -> torch.Tensor:
    """(B,H,D) queries against int8 (B,H,D,S) K/V with (B,H,1,S) scales,
    attending columns valid_from <= c <= pos; returns (B,H,D) in q's dtype.

    CUDA tensors launch the Hopper kernel (q bf16 or fp32, D = 64) on the
    current stream, with `splits` CTAs a row (0: `split_count`), or raise;
    CPU tensors take `sqa_int8_reference`.
    """
    if q.device.type == "cpu":
        return sqa_int8_reference(q, k8, k_scale, v8, v_scale, pos, valid_from)
    if q.device.type != "cuda":
        raise ValueError(f"sqa_int8 runs on cuda or cpu, not {q.device}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"sqa_int8 takes a bf16 or fp32 query, got {q.dtype}")
    b, h, d = q.shape
    _check_int8_kv(q.device, k8, k_scale, v8, v_scale, (b, h, d, k8.shape[-1]))
    if q.stride(-1) != 1:
        raise ValueError(f"sqa_int8 needs a unit-stride q, got strides {q.stride()}")
    pos = bound_tensor(pos, b, q.device)
    valid_from = bound_tensor(valid_from, b, q.device)
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    fn = getattr(load_kernel(), _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        args = launch_args(pos, valid_from, q.stride()[:2], out.stride()[:2], k8, v8,
                           k_scale, v_scale, splits)
        err = fn(args, q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(), v8.data_ptr(),
                 v_scale.data_ptr(), out.data_ptr())
    if err != 0:
        raise RuntimeError(f"sqa_int8 kernel launch failed: CUDA error {err}")
    count_launch(__name__)
    return out


LayerAttend = Callable[[torch.Tensor, int], torch.Tensor]


def sqa_int8_layers(k8: torch.Tensor, k_scale: torch.Tensor, v8: torch.Tensor,
                    v_scale: torch.Tensor, pos: Bound, valid_from: Bound,
                    splits: int = 0) -> LayerAttend:
    """`attend(q, l)`: `sqa_int8` of one decode step's q (B, 1, H, D)
    against layer l of stacked int8 K/V (L, B, H, D, S) and scales
    (L, B, H, 1, S); returns (B, 1, H, D).

    The validated fast entry of a decode step: K/V, scales and bounds are
    checked, and the launch arguments and stream fixed, once here; each
    call then checks q's shape and layout and launches with the layer's
    pointers. A q the entry does not take (another shape, a strided view)
    goes through `sqa_int8`. CPU tensors take the plain version. `splits`
    as in `sqa_int8`."""
    batch = k8.shape[1]
    dev = k8.device
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        return lambda q, l: sqa_int8(q[:, 0], k8[l], k_scale[l], v8[l], v_scale[l],
                                     pos, valid_from, splits)[:, None]
    _check_int8_kv(dev, k8, k_scale, v8, v_scale, k8.shape)
    pos_t = bound_tensor(pos, batch, dev)
    vf_t = bound_tensor(valid_from, batch, dev)
    heads, d = k8.shape[2], k8.shape[3]
    q_shape = (batch, 1, heads, d)  # contiguous: row stride H * D, head stride D
    args = launch_args(pos_t, vf_t, (heads * d, d), (heads * d, d), k8[0], v8[0],
                       k_scale[0], v_scale[0], splits)
    ref = ctypes.byref(args)
    lib = load_kernel()
    fns = {dtype: getattr(lib, name) for dtype, name in _ENTRY.items()}
    tables = [(t.data_ptr(), t.stride(0) * t.element_size())
              for t in (k8, k_scale, v8, v_scale)]
    n_layers = k8.shape[0]

    def attend(q: torch.Tensor, l: int) -> torch.Tensor:
        if not 0 <= l < n_layers:
            raise IndexError(f"layer {l} of {n_layers}")
        fn = fns.get(q.dtype)
        if fn is None or q.shape != q_shape or not q.is_contiguous() or q.device != dev:
            return sqa_int8(q[:, 0], k8[l], k_scale[l], v8[l], v_scale[l],
                            pos_t, vf_t, splits)[:, None]
        out = torch.empty_like(q)
        err = fn(ref, q.data_ptr(), *(p + l * step for p, step in tables),
                 out.data_ptr())
        if err != 0:
            raise RuntimeError(f"sqa_int8 kernel launch failed: CUDA error {err}")
        count_launch(__name__)
        return out

    return attend
