"""Speech-like audio from a seed: a tone whose pitch and loudness move at
syllable rate, in noise (the port's smoke test's `speechy`, with the pitch,
the rates and the level drawn per recording). One recording is a pure
function of (seed, index), on the host (numpy) or on the card (torch), so
a process that did not make it can make it again."""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16_000


def _params(seed: int, index: int):
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, index])
    return (float(rng.uniform(110.0, 260.0)), float(rng.uniform(2.0, 5.0)),
            float(rng.uniform(0.1, 0.3)), int(rng.integers(0, 2**63 - 1)))


def speechy_np(n_samples: int, seed: int, index: int) -> np.ndarray:
    """(n_samples,) float32 on the host."""
    f0, rate, level, noise_seed = _params(seed, index)
    t = np.arange(n_samples, dtype=np.float64) / SAMPLE_RATE
    tone = level * np.sin(2 * np.pi * f0 * t) * (1 + 0.5 * np.sin(2 * np.pi * rate * t))
    noise = np.random.default_rng(noise_seed).standard_normal(n_samples, dtype=np.float32)
    return (tone.astype(np.float32) + 0.02 * noise).astype(np.float32)


def speechy_torch(n_samples: int, seed: int, index: int, device):
    """(n_samples,) float32 made on `device` (the same signal as
    `speechy_np`, with the noise drawn by torch)."""
    import torch

    f0, rate, level, noise_seed = _params(seed, index)
    t = torch.arange(n_samples, dtype=torch.float64, device=device) / SAMPLE_RATE
    tone = level * torch.sin(2 * np.pi * f0 * t) * (1 + 0.5 * torch.sin(2 * np.pi * rate * t))
    gen = torch.Generator(device=device).manual_seed(noise_seed)
    noise = torch.randn(n_samples, generator=gen, dtype=torch.float32, device=device)
    return tone.float() + 0.02 * noise
