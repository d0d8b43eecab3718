"""K6 (`sqa_kernel` over int8 K/V) over every launch in the traced slice:
the sum of each launch's bound from its shape over the sum of its device
time, in %. The cells' self-attention cache is bf16 (K3), so every K6
launch is a step's cross-attention over the 1500 audio positions; batch
and heads come from its grid (`counts.k6`)."""

from portbench.lib.readers import K6, roofline_pct
from portbench.metrics import counts


def read(rec):
    d = rec.dims
    hd = d["n_text_state"] // d["n_text_head"]
    return roofline_pct(rec, K6, lambda k: counts.k6(
        k.grid[2], k.grid[1], d["n_audio_ctx"], hd)["bound_s"])
