"""Device-busy time of the traced slice (the union of its kernels, copies
and sets) over the 30 s windows whose language it identified, in ms."""


def read(rec):
    if rec.slice is None or rec.windows <= 0:
        return None
    return 1e3 * rec.slice.busy_s / rec.windows
