"""Kernel launches the host made in the traced slice (the profiler's
cudaLaunchKernel, cudaLaunchKernelExC, cuLaunchKernel and cudaGraphLaunch
calls) over its single-token decode steps (see `batch.step_ms`)."""


def read(rec):
    steps = rec.counters.get("k3_launches", 0) / rec.dims["n_text_layer"]
    if rec.slice is None or steps <= 0 or rec.slice.launches <= 0:
        return None
    return rec.slice.launches / steps
