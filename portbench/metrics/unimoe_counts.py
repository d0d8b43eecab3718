"""Operations of the Uni-MoE family (`families/unimoe.py`) from its shapes
and the work a slice did: the expert products' FLOPs and the whole
model's. Products count 2 operations a multiply-add; the elementwise
work (norms, RoPE, SwiGLU's gate, softmax) is left out."""

from __future__ import annotations

from typing import Dict

from portbench.metrics import counts


def swiglu_row_flops(hidden: int, ffn: int) -> float:
    """One row through one SwiGLU expert: gate and up (hidden -> 2 ffn),
    down (ffn -> hidden)."""
    return 2.0 * hidden * 3 * ffn


def expert_flops(d: Dict[str, float], rows: float, tokens: float) -> float:
    """`rows` (row, routed expert) pairs and `tokens` rows through the
    shared experts."""
    return (rows * swiglu_row_flops(d["hidden"], d["expert_ffn"])
            + tokens * d["n_shared"] * swiglu_row_flops(d["hidden"], d["shared_ffn"]))


def layer_token_flops(d: Dict[str, float]) -> float:
    """One row through one decoder layer's q, k, v, o and router products
    and its shared experts (the routed experts and the attention over
    the context are counted apart)."""
    h, dh = d["hidden"], d["hidden"] // d["n_head"]
    nq, nk = d["n_head"] * dh, d["n_kv_head"] * dh
    routes = d["n_experts"] + d["n_null_experts"]
    return (2.0 * h * (nq + 2 * nk) + 2.0 * nq * h + 2.0 * h * routes
            + expert_flops(d, 0, 1))


def window_flops(d: Dict[str, float]) -> float:
    """One 30 s window through the encoder and the connector's linear."""
    return counts.encoder_flops(d) + 2.0 * d["audio_tokens"] * d["n_audio_state"] * d["hidden"]


def model_flops(d: Dict[str, float], windows: float, layer_tokens: float, rows: float,
                attn_pairs: float, answers: float) -> float:
    """`windows` encoded; `layer_tokens` rows through a decoder layer
    (summed over layers) and `rows` routed pairs (summed over layers);
    `attn_pairs` causal (query, key) pairs a layer, summed over clips;
    `answers` rows through the head."""
    dh = d["hidden"] // d["n_head"]
    return (windows * window_flops(d) + layer_tokens * layer_token_flops(d)
            + rows * swiglu_row_flops(d["hidden"], d["expert_ffn"])
            + d["n_layer"] * attn_pairs * 4.0 * d["n_head"] * dh
            + answers * 2.0 * d["hidden"] * d["n_vocab"])
