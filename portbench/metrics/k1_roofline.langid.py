"""K1 (`fa_fwd_bf16_kernel`, the encoder's flash attention) over every
launch in the traced slice: the sum of each launch's bound from its shape
(`counts.k1`: batch and heads from its grid, 1500 positions, 64 channels)
over the sum of its device time, in %."""

from portbench.lib.readers import K1, roofline_pct
from portbench.metrics import counts


def read(rec):
    d = rec.dims
    hd = d["n_audio_state"] // d["n_audio_head"]
    return roofline_pct(rec, K1, lambda k: counts.k1(
        k.grid[2], k.grid[1], d["n_audio_ctx"], hd)["bound_s"])
