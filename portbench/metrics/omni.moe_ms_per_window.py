"""Device time launched under the program's span `moe` (inclusive: the
router, the permutation, the routed and shared experts and the combine)
in the spanned slice, over the clips it answered, in ms. None without a
spanned slice or where the span never opened."""

from portbench.lib.spans import span_ms_per_window


def read(rec):
    ss = getattr(rec, "spans", None)
    return span_ms_per_window(ss, getattr(rec, "span_windows", 0), "moe", True)
