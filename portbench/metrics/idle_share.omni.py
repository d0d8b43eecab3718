"""The share of the plain traced slice in which the card ran no kernel,
copy or set (the union of its device intervals), in %."""

from portbench.lib.readers import idle_pct


def read(rec):
    return idle_pct(rec)
