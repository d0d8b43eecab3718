"""The traced slice's length over its single-token decode steps, in ms.
Steps are the difference of the program's K3 launch count
(`ops.sqa_self.launches`) over the slice, divided by the decoder's layers:
every single-token step over the bf16 self-cache launches K3 once a
layer. The slice is one whole call, so its encoder's share is in it."""


def read(rec):
    steps = rec.counters.get("k3_launches", 0) / rec.dims["n_text_layer"]
    if rec.slice is None or steps <= 0:
        return None
    return 1e3 * rec.slice.window_s / steps
