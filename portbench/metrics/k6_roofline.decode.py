"""`k6_roofline.batch` over the decode cell's traced slice: K6's bound
from each launch's shape over its device time, in %. The cell's
self-attention cache is bf16 (K3), so every K6 launch is a step's
cross-attention over the 1500 audio positions."""

from portbench.lib.readers import load_reader

read = load_reader("k6_roofline.batch")
