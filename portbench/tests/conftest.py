"""Tiny stand-ins for the cells' files: the same kinds, options and checks
at widths a CPU test can hold (d_model 64, 2 heads, 2 + 2 layers, the
real vocabulary layout and 30 s windows)."""

from __future__ import annotations

import copy

import pytest

from portbench.lib import spec

TINY = {
    "name": "tiny", "source": "test", "family": "whisper", "d_model": 64, "encoder_layers": 2,
    "encoder_attention_heads": 2, "encoder_ffn_dim": 256, "decoder_layers": 2,
    "decoder_attention_heads": 2, "decoder_ffn_dim": 256, "num_mel_bins": 80,
    "vocab_size": 51865, "max_source_positions": 1500, "max_target_positions": 448,
    "n_languages": 99, "dtypes": {"weights": "int8"}, "reduced": [],
}


# d_model 128: the MLP weights pass the int8 rule's 65,536-element floor
WIDE = dict(TINY, d_model=128, encoder_ffn_dim=512, decoder_ffn_dim=512)


@pytest.fixture
def tiny_config():
    return copy.deepcopy(TINY)


def tiny_cell(name: str) -> dict:
    """The cell's file with its sizes cut for the CPU."""
    cell = copy.deepcopy(spec.cell_file(name))
    p, o = cell["params"], cell["options"]
    if cell["traffic"] == "batch_queue":
        p.update(windows_per_call=4, deck=16, pool_calls=2, warmup_sample_len=2,
                 duration_s={"median": 45.0, "sigma": 0.5, "min": 10.0, "max": 100.0})
        o.update(batch_size=4, sample_len=6)
    elif cell["traffic"] == "http_open_loop":
        p.update(rate=24.0, batch_size=4, warmup_batches=[2], warmup_sample_len=2,
                 wait_s=30.0, duration_s={"median": 4.0, "sigma": 0.5, "min": 2.0, "max": 8.0})
        o.update(sample_len=6)
    elif cell["traffic"] == "decode_batches":
        p.update(windows_per_call=2, pool_calls=2, warmup_sample_len=2)
        o.update(sample_len=6)
    else:
        p.update(windows_per_call=2, pool_calls=2, traced_calls=1)
        cell["check"]["windows"] = 3
    return cell
