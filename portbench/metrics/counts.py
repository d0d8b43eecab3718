"""Operations and bytes from shapes: each kernel's least work, the whole
model's FLOPs, and the published peaks of the card.

A roofline bound is the larger of the bytes over the HBM bandwidth and the
operations over the dense peak of their type; each input byte is read
once and each output byte written once, whatever a kernel reads again.
Peaks: NVIDIA H100 SXM data sheet, dense (no sparsity), at 700 W."""

from __future__ import annotations

from typing import Dict

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "fp8": 1979e12, "int8": 1979e12, "tf32": 495e12, "fp32": 67e12}


def bound_s(nbytes: float, ops: float, op_type: str) -> float:
    """The least time the card could take for `nbytes` and `ops`."""
    return max(nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[op_type])


# -- kernels -----------------------------------------------------------------------

def k1(batch: int, heads: int, t: int, head_dim: int) -> Dict[str, float]:
    """K1, the encoder's bf16 flash attention over (B, T, H, D), not causal:
    QK^T and PV at 2 operations a multiply-add; q, k, v read and o
    written once, 2 bytes each."""
    ops = 4.0 * batch * heads * t * t * head_dim
    nbytes = 4.0 * batch * t * heads * head_dim * 2
    return {"ops": ops, "bytes": nbytes, "bound_s": bound_s(nbytes, ops, "bf16")}


def k6(batch: int, heads: int, cols: int, head_dim: int) -> Dict[str, float]:
    """K6, a single-token step's attention over int8 K/V (B, H, D, S) with
    one fp32 scale per (b, h, column) each, bf16 query and output: q.k and
    p.v over every column, the int8 values and the scales read once."""
    ops = 4.0 * batch * heads * cols * head_dim
    nbytes = (2.0 * batch * heads * head_dim * cols  # k8, v8
              + 2.0 * batch * heads * cols * 4  # scales
              + 2.0 * batch * heads * head_dim * 2)  # q, out
    return {"ops": ops, "bytes": nbytes, "bound_s": bound_s(nbytes, ops, "bf16")}


# -- the model ---------------------------------------------------------------------

def encoder_flops(d: Dict[str, int]) -> float:
    """One 30 s window through the encoder: the conv stem, and per layer the
    four projections, attention over 1500 positions and the MLP."""
    n, t, f = d["n_audio_state"], d["n_audio_ctx"], d["n_ffn"]
    frames = 2 * t
    stem = 2.0 * frames * 3 * d["n_mels"] * n + 2.0 * t * 3 * n * n
    layer = 2.0 * t * 4 * n * n + 4.0 * t * t * n + 2.0 * t * 2 * n * f
    return stem + d["n_audio_layer"] * layer


def cross_kv_flops(d: Dict[str, int]) -> float:
    """One window's cross-attention K and V in every decoder layer."""
    n, s = d["n_text_state"], d["n_audio_ctx"]
    return d["n_text_layer"] * 2.0 * s * 2 * n * n


def decoder_token_flops(d: Dict[str, int], context: float) -> float:
    """One token through the decoder at `context` attended self positions:
    per layer the self-attention's four projections, the cross-attention's
    query and output, attention over the context and the 1500 audio
    positions, and the MLP; then the tied-embedding logits."""
    n, s, f = d["n_text_state"], d["n_audio_ctx"], d["n_ffn"]
    layer = 2.0 * 6 * n * n + 4.0 * (context + s) * n + 2.0 * 2 * n * f
    return d["n_text_layer"] * layer + 2.0 * n * d["n_vocab"]


def model_flops(d: Dict[str, int], windows: float, cross_windows: float,
                tokens: float, context: float) -> float:
    """`windows` encoded, `cross_windows` given cross K/V, and `tokens`
    decoder tokens at a mean `context` of attended self positions."""
    return (windows * encoder_flops(d) + cross_windows * cross_kv_flops(d)
            + tokens * decoder_token_flops(d, context))
