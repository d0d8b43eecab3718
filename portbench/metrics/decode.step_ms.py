"""`batch.step_ms` over the decode cell's traced slice, one whole
`decoding.decode` call (its log-mel, encoder and cross-KV in it): the
slice's length over its single-token steps (K3 launches over the
decoder's layers), in ms."""

from portbench.lib.readers import load_reader

read = load_reader("batch.step_ms")
