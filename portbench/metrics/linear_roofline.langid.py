"""The encoder's and cross-attention K/V's linears (the kernel
`fused_linear_kernel`) over the traced slice: the bound of the slice's
linear products over the summed device time of those kernels, in %.

The work is the same whatever implements it: windows encoded (K1's grids,
`readers.slice_work`) times, per window, the encoder's q, k, v, out and
MLP products in every block and the cross-attention's K and V in every
decoder layer (`counts.cross_kv_flops`), at 2 operations a multiply-add.
Bytes: each linear's bf16 input read and bf16 output written once; the
weights are left out (read once a call of many windows, under 1 % of the
activations), and the FLOPs bound it anyway. The bound is the larger of
the FLOPs over the bf16 dense peak and the bytes over the HBM rate. A
program without the kernel (one whose linears run as a GEMM and
elementwise passes) reads None."""

from portbench.lib.readers import slice_work
from portbench.lib.trace import kernels_named
from portbench.metrics import counts

KERNEL = ("fused_linear_kernel",)


def window_work(d):
    """One window's linear products: (FLOPs, bytes)."""
    n, t, f = d["n_audio_state"], d["n_audio_ctx"], d["n_ffn"]
    nt = d["n_text_state"]
    ops = (d["n_audio_layer"] * (2.0 * t * 4 * n * n + 2.0 * t * 2 * n * f)
           + counts.cross_kv_flops(d))
    nbytes = 2.0 * t * (d["n_audio_layer"] * (4 * (n + n) + (n + f) + (f + n))
                        + d["n_text_layer"] * 2 * (n + nt))
    return ops, nbytes


def read(rec):
    ks = kernels_named(rec.slice, *KERNEL)
    spent = sum(k.end_ns - k.start_ns for k in ks) * 1e-9
    windows = slice_work(rec)["windows"] if ks else 0
    if spent <= 0 or windows <= 0:
        return None
    ops, nbytes = window_work(rec.dims)
    return 100.0 * windows * counts.bound_s(nbytes, ops, "bf16") / spent
