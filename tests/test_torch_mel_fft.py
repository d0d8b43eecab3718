"""K4's FFT (`csrc/mel.cu`) emulated on the CPU.

The kernel computes each frame's 400-point real DFT as a 200-point complex
FFT of z[n] = x[2n] + i x[2n+1] in three stages (an 8-point DFT, a 25-point
DFT as 5 x 5, the split into the 201 bins), with the fp32 twiddles of
`ops/mel_kernel.fft_table`; the card runs it (tests/test_torch_kernels_cuda.py).
`emulate` below repeats those stages in that order, in fp32 PyTorch with
the same table and the kernel's formulas, and its log-mel is held:
  - to 1e-4 (the kernel's gate on the card) against the plain version on
    the unclamped log10 mel and against JAX's Pallas kernel (interpret
    mode) after the epilogue, on noise;
  - to 1e-3 against the fp64 oracle after the epilogue (the frontend's
    fidelity gate), on noise, a pure tone, silence and speech-like audio
    (a modulated tone in noise). Bins without real energy hold rounding
    noise in any fp32 transform, so on the last three only the
    post-epilogue gate, whose floor at max - 8 lies far above it, applies;
  - silence gives exactly -10 before the epilogue, in every bin.
"""

import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu.ops.mel_kernel import log_mel_pallas
from openai_whisper_coreml_tpu_torch import audio as taudio
from openai_whisper_coreml_tpu_torch.ops import mel_kernel as mk

from .oracles import oracle_log_mel

torch.set_num_threads(1)

SR = 16000


def _table():
    """The kernel's table as (twiddles (425,) complex64, window (400,))."""
    t = torch.from_numpy(mk.fft_table())
    tw = torch.complex(t[0:2 * mk.N_TWIDDLES:2], t[1:2 * mk.N_TWIDDLES:2])
    return tw, t[2 * mk.N_TWIDDLES:]


def _neg_i(a):
    return torch.complex(a.imag, -a.real)


def _dft5(a, c1, s1, c2, s2):
    """The kernel's 5-point DFT over the last axis (its formulas)."""
    a0, a1, a2, a3, a4 = a.unbind(-1)
    b1, b4, b2, b3 = a1 + a4, a1 - a4, a2 + a3, a2 - a3
    r1 = a0 + c1 * b1 + c2 * b2
    r2 = a0 + c2 * b1 + c1 * b2
    i1 = s1 * b4 + s2 * b3
    i2 = s2 * b4 - s1 * b3
    return torch.stack([a0 + (b1 + b2), r1 + _neg_i(i1), r2 + _neg_i(i2), r2 - _neg_i(i2),
                        r1 - _neg_i(i1)], dim=-1)


def _dft4(y):
    y0, y1, y2, y3 = y.unbind(-1)
    p0, p1, p2, p3 = y0 + y2, y0 - y2, y1 + y3, _neg_i(y1 - y3)
    return p0 + p2, p1 + p3, p0 - p2, p1 - p3


def _dft8(z, r):
    """The kernel's 8-point DFT over the last axis (decimation in
    frequency)."""
    u = z[..., :4] + z[..., 4:]
    v = z[..., :4] - z[..., 4:]
    v1, v2, v3 = v[..., 1], v[..., 2], v[..., 3]
    v = torch.stack([v[..., 0], torch.complex(r * (v1.real + v1.imag), r * (v1.imag - v1.real)),
                     _neg_i(v2),
                     torch.complex(r * (v3.imag - v3.real), -r * (v3.real + v3.imag))], dim=-1)
    even, odd = _dft4(u), _dft4(v)
    return torch.stack([x for pair in zip(even, odd) for x in pair], dim=-1)


def emulate(padded: torch.Tensor, n_mels: int) -> torch.Tensor:
    """Reflect-padded (B, 160 T + 400) fp32 -> (B, T, n_mels) unclamped
    log10 mel through the kernel's stages."""
    tw, win = _table()
    r = tw[225 + 50].real
    c1, s1 = tw[200 + 5].real, -tw[200 + 5].imag
    c2, s2 = tw[200 + 10].real, -tw[200 + 10].imag
    n_frames = (padded.shape[-1] - 400) // 160
    frames = padded.unfold(-1, 400, 160)[:, :n_frames]
    z = torch.complex(frames[..., 0::2] * win[0::2], frames[..., 1::2] * win[1::2])
    # A: z[25 n1 + n2] -> y[k1][n2], times W200^(n2 k1)
    y = _dft8(z.reshape(*z.shape[:-1], 8, 25).transpose(-1, -2), r).transpose(-1, -2)
    y = y * tw[:200].reshape(8, 25)
    # B: y[k1][5 m1 + m2] -> t[k1][j1][m2], times W25^(m2 j1), -> Z[k1 + 8 (j1 + 5 j2)]
    y = y.reshape(*y.shape[:-1], 5, 5)  # [k1][m1][m2]
    t = _dft5(y.transpose(-1, -2), c1, s1, c2, s2).transpose(-1, -2)  # [k1][j1][m2]
    m2, j1 = torch.meshgrid(torch.arange(5), torch.arange(5), indexing="xy")
    t = t * tw[200 + m2 * j1]
    x25 = _dft5(t, c1, s1, c2, s2)  # [k1][j1][j2]
    zk = x25.transpose(-1, -2).reshape(*x25.shape[:-3], 8, 25).transpose(-1, -2)
    zk = zk.reshape(*zk.shape[:-2], 200)  # Z[k1 + 8 k2] at 8 k2 + k1
    # C: the bins from Z[k] and Z[200 - k]
    c = zk[..., (200 - torch.arange(200)) % 200]
    e = torch.complex(zk.real + c.real, zk.imag - c.imag)
    o = torch.complex(zk.imag + c.imag, c.real - zk.real)
    xk = e + o * tw[225:]
    power = 0.25 * (xk.real * xk.real + xk.imag * xk.imag)
    last = e[..., 0] - o[..., 0]
    power = torch.cat([power, (0.25 * (last.real ** 2 + last.imag ** 2))[..., None]], -1)
    fbt = torch.from_numpy(taudio.mel_filters(n_mels).T)
    return torch.log10(torch.clamp(power @ fbt, min=1e-10))


def _pad(x: np.ndarray) -> torch.Tensor:
    xt = torch.from_numpy(np.atleast_2d(x))
    return torch.nn.functional.pad(xt[:, None], (200, 200), mode="reflect")[:, 0]


def _audio(kind: str, seconds: float, seed: int) -> np.ndarray:
    n = int(seconds * SR)
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return (rng.standard_normal(n) * 0.1).astype(np.float32)
    if kind == "tone":
        return (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    if kind == "silence":
        return np.zeros(n, np.float32)
    return (0.2 * np.sin(2 * np.pi * 200 * t) * (1 + 0.5 * np.sin(2 * np.pi * 2 * t))
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


def test_emulated_fft_is_the_dft():
    """The stages give numpy's FFT of the windowed frames (fp64 oracle) to
    fp32 rounding: a check of the factorisation itself."""
    x = _audio("noise", 0.5, 1)
    padded = _pad(x)
    out = emulate(padded, 80)
    frames = padded.double().unfold(-1, 400, 160)[:, :out.shape[1]].numpy()
    power = np.abs(np.fft.rfft(frames * taudio.hann_window(400).astype(np.float64))) ** 2
    want = np.log10(np.maximum(power @ taudio.mel_filters(80).T.astype(np.float64), 1e-10))
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("n_mels,batch", [(80, 1), (128, 1), (80, 3)])
def test_emulated_kernel_matches_plain_version_and_jax(n_mels, batch):
    rng = np.random.default_rng(10 + n_mels + batch)
    x = (rng.standard_normal((batch, 2 * SR)) * 0.1).astype(np.float32)
    padded = _pad(x)
    out = emulate(padded, n_mels)
    np.testing.assert_allclose(out.numpy(), mk.log_mel_kernel_reference(padded, n_mels).numpy(),
                               atol=1e-4)
    ref = np.asarray(log_mel_pallas(x, n_mels, interpret=True))
    np.testing.assert_allclose(mk.epilogue(out).numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("kind", ["noise", "tone", "silence", "speechy"])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_emulated_kernel_holds_the_fp64_gate(kind, n_mels):
    x = _audio(kind, 1.5, n_mels)
    out = mk.epilogue(emulate(_pad(x), n_mels))[0].numpy()
    ref = oracle_log_mel(x, taudio.mel_filters(n_mels))
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_silence_gives_minus_ten_before_the_epilogue():
    raw = emulate(_pad(_audio("silence", 1, 0)), 128)
    assert (raw == -10.0).all()
    assert (mk.log_mel_kernel_reference(_pad(_audio("silence", 1, 0)), 128) == -10.0).all()
