"""The model FLOPs of the plain traced slice's work over its length times
989 TFLOP/s, the H100's dense bf16 peak (the int8 weights are multiplied
in bf16), in %. The work: the windows encoded (K1's grid rows over the
encoder's layers), and the decoder's rows and routed pairs as the
program's MoE counters read them over the slice, with the clips'
causal attention pairs and answers as the harness handed them
(`unimoe_counts.model_flops`). None without the counters."""

from portbench.lib.readers import K1
from portbench.lib.trace import kernels_named
from portbench.metrics import counts, unimoe_counts


def read(rec):
    c = rec.counters
    if rec.slice is None or rec.slice.window_s <= 0 or "moe.tokens" not in c:
        return None
    windows = sum(k.grid[2] for k in kernels_named(rec.slice, *K1)) / rec.dims["n_audio_layer"]
    flops = unimoe_counts.model_flops(rec.dims, windows, c["moe.tokens"], c["moe.rows_routed"],
                                      rec.decode.get("attn_pairs", 0),
                                      rec.decode.get("clips", 0))
    return 100.0 * flops / (rec.slice.window_s * counts.PEAK_OPS_S["bf16"])
