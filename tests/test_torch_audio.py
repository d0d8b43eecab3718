"""Port log-mel frontend against the JAX frontend and the fp64 oracle."""

import numpy as np
import pytest
import torch

from openai_whisper_coreml_tpu import audio as jaudio
from openai_whisper_coreml_tpu_torch import audio as taudio

from .oracles import oracle_log_mel

# tiny tensors: one torch thread per test worker keeps parallel workers
# from oversubscribing the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("n_mels,batch", [(80, None), (128, 2)])
def test_log_mel_matches_jax_and_oracle(rng, n_mels, batch):
    n = 16000 * 3
    shape = (n,) if batch is None else (batch, n)
    audio = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    ours = taudio.log_mel_spectrogram(audio, n_mels).numpy()
    ref = np.asarray(jaudio.log_mel_spectrogram(audio, n_mels))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    rows = audio[None] if batch is None else audio
    outs = ours[None] if batch is None else ours
    for a, o in zip(rows, outs):
        np.testing.assert_allclose(o, oracle_log_mel(a, taudio.mel_filters(n_mels)),
                                   atol=1e-3)


def test_frontend_tables_match_jax():
    for n_mels in (80, 128):
        np.testing.assert_array_equal(taudio.mel_filters(n_mels),
                                      jaudio.mel_filters(n_mels))
    np.testing.assert_array_equal(taudio.hann_window(), jaudio.hann_window())
    for a, b in zip(taudio.dft_matrices(), jaudio.dft_matrices()):
        np.testing.assert_array_equal(a, b)


def test_pad_or_trim_numpy_and_tensor(rng):
    x = rng.standard_normal((2, 1000)).astype(np.float32)
    for length in (500, 1000, 1600):
        ref = np.asarray(jaudio.pad_or_trim(x, length))
        np.testing.assert_array_equal(taudio.pad_or_trim(x, length), ref)
        out = taudio.pad_or_trim(torch.from_numpy(x), length)
        assert isinstance(out, torch.Tensor)
        np.testing.assert_array_equal(out.numpy(), ref)


def test_log_mel_rejects_bad_lengths():
    with pytest.raises(ValueError, match="multiple of"):
        taudio.log_mel_spectrogram(np.zeros(1001, np.float32))
    with pytest.raises(ValueError, match="1D or 2D"):
        taudio.log_mel_spectrogram(np.zeros((1, 1, 1600), np.float32))
