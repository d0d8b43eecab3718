"""The port's K4 log-mel (plain version, as the CPU runs it) against the JAX
package's Pallas kernel `log_mel_pallas` in interpret mode (1e-4, the JAX
kernel test's tolerance) and against the fp64 oracle (1e-3 max, 1e-5 mean,
the frontend's fidelity gate)."""

import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu.ops.mel_kernel import log_mel_pallas
from openai_whisper_coreml_tpu_torch import audio as taudio
from openai_whisper_coreml_tpu_torch.ops import mel_kernel as mk

from .oracles import oracle_log_mel

# tiny tensors: one torch thread per test worker keeps parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("seconds,n_mels,batch", [
    (1, 80, None), (30, 80, None), (2, 128, None), (1, 80, 3)])
def test_plain_k4_matches_jax_pallas(seconds, n_mels, batch):
    rng = np.random.default_rng(seconds * 1000 + n_mels)
    shape = (seconds * 16000,) if batch is None else (batch, seconds * 16000)
    x = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    ref = np.asarray(log_mel_pallas(x, n_mels, interpret=True))
    out = mk.log_mel(torch.from_numpy(x), n_mels).numpy()
    assert out.shape == ref.shape == shape[:-1] + (n_mels, seconds * 100)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_plain_k4_matches_fp64_oracle():
    x = (np.random.default_rng(4).standard_normal(16000) * 0.1).astype(np.float32)
    out = mk.log_mel(torch.from_numpy(x), 80).numpy()
    ref = oracle_log_mel(x, taudio.mel_filters(80))
    np.testing.assert_allclose(out, ref, atol=1e-3)
    assert np.abs(out - ref).mean() < 1e-5


def test_log_mel_spectrogram_on_cpu_is_the_plain_version():
    x = (np.random.default_rng(5).standard_normal((2, 32000)) * 0.1).astype(np.float32)
    xt = torch.from_numpy(x)
    padded = torch.nn.functional.pad(xt[:, None], (200, 200), mode="reflect")[:, 0]
    raw = mk.log_mel_kernel(padded, 128)
    assert torch.equal(raw, mk.log_mel_kernel_reference(padded, 128))
    log_max = raw.amax(dim=(1, 2), keepdim=True)
    expect = ((torch.maximum(raw, log_max - 8.0) + 4.0) / 4.0).transpose(1, 2)
    assert torch.equal(taudio.log_mel_spectrogram(x, 128), expect)
    assert torch.equal(taudio.log_mel_spectrogram(x[0], 128), expect[0])
    assert mk.launches == 0  # the CPU never launches the kernel


@pytest.mark.parametrize("n_mels", [80, 128])
def test_kernel_tables(n_mels):
    """The kernel's operands, checked where the CPU can see them: the FFT's
    twiddles against fp64 (each rounded once to fp32, the parts that are
    exactly 0 at 0), the Hann window, and the packed filterbank: the ranges
    it skips outside of, and their weights, which unpack to the
    filterbank."""
    table, pack, ranges = mk._tables(n_mels, torch.device("cpu"))
    assert table.dtype == torch.float32 and table.shape == (mk.TABLE_FLOATS,)
    # the kernel reads them through bare pointers
    assert table.is_contiguous() and pack.is_contiguous() and ranges.is_contiguous()
    tw = table[:2 * mk.N_TWIDDLES].double().reshape(-1, 2).numpy()
    k1, n2 = np.meshgrid(np.arange(8), np.arange(25), indexing="ij")
    for (lo, hi), n, e in (((0, 200), 200, (k1 * n2).ravel()), ((200, 225), 25, np.arange(25)),
                           ((225, 425), 400, np.arange(200))):
        exact = np.exp(-2j * np.pi * e / n)
        for got, want in ((tw[lo:hi, 0], exact.real), (tw[lo:hi, 1], exact.imag)):
            np.testing.assert_array_equal(got, np.where(np.abs(want) < 1e-12, 0, want)
                                          .astype(np.float32))
        assert np.abs(tw[lo:hi, 0] + 1j * tw[lo:hi, 1] - exact).max() < 6e-8
    np.testing.assert_array_equal(table[2 * mk.N_TWIDDLES:].numpy(), taudio.hann_window(400))
    fb = taudio.mel_filters(n_mels)
    unpacked = np.zeros_like(fb)
    for g, (lo, hi, start) in enumerate(ranges.numpy()):
        rows = fb[4 * g:4 * g + 4]
        assert not rows[:, :lo].any() and not rows[:, hi:].any()
        assert rows[:, lo].any() and rows[:, hi - 1].any()
        unpacked[4 * g:4 * g + 4, lo:hi] = pack[start:start + hi - lo].numpy().T
    np.testing.assert_array_equal(unpacked, fb)
    assert pack.shape == (int((ranges[:, 1] - ranges[:, 0]).sum()), 4)


def test_kernel_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        mk.log_mel_kernel(torch.zeros(1, 560, device="meta"), 80)
