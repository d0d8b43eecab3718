"""The expert products' bound over their device time, in %: the
`fused_linear_kernel` launches made under the spans `moe.experts` and
`moe.shared` in the spanned slice. Their work is read from the program's
counters over that slice: the routed (row, expert) pairs and the tokens
through the shared experts, less those whose products ran outside the
fused kernel (`moe.unfused_rows`, `moe.unfused_tokens`), at the FLOPs of
a SwiGLU row (`unimoe_counts`), over 989 TFLOP/s, the H100's dense bf16
peak. None without a spanned slice, its counters or such launches."""

from portbench.lib.spans import _clipped_s
from portbench.metrics import counts, unimoe_counts

KERNEL = "fused_linear_kernel"
SPANS = {"moe.experts", "moe.shared"}


def read(rec):
    ss, c = getattr(rec, "spans", None), getattr(rec, "span_counters", {})
    if ss is None or "moe.rows_routed" not in c:
        return None
    spent = sum(_clipped_s(dev, ss.slice.window_ns) for dev, chain in zip(ss.slice.device,
                                                                          ss.chains)
                if KERNEL in dev[2] and SPANS & set(chain))
    if spent <= 0:
        return None
    rows = c["moe.rows_routed"] - c.get("moe.unfused_rows", 0)
    tokens = c["moe.tokens"] - c.get("moe.unfused_tokens", 0)
    flops = unimoe_counts.expert_flops(rec.dims, rows, tokens)
    return 100.0 * counts.bound_s(0.0, flops, "bf16") / spent
