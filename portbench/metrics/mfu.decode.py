"""The model FLOPs of the work the traced slice completed (`counts.py`,
from the configuration's shapes and the slice's launches) over the
slice's length times 989 TFLOP/s, the H100's dense bf16 peak: the int8
weights are multiplied in bf16. In %."""

from portbench.lib.readers import mfu_pct


def read(rec):
    return mfu_pct(rec)
