"""The port's device log-mel (ops/mel.py) against the JAX package's
``log_mel_spectrogram`` and the port's host featurizer
(data/features.py::log_mel_numpy) at tests/test_mel.py's tolerance (atol
5e-5, rtol 1e-5), for 80 and 128 mels and input of several 30 s windows;
framing and the DFT basis equal to the JAX package's, the power spectrum
(fp64 DFT product here, fp32 there) close to its; and the device-time
helpers on a CPU-only run."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_utils  # noqa: F401  (caps torch's threads)
from ts_asr_whisper_tpu.ops import mel as jmel
from ts_asr_whisper_tpu_torch.data import features as tfeat
from ts_asr_whisper_tpu_torch.ops import mel as tmel
from ts_asr_whisper_tpu_torch.utils.device import force_execution
from ts_asr_whisper_tpu_torch.utils.devicetime import measure_device_ms

N = tfeat.N_SAMPLES


def _speech_like(rng, b, windows):
    """A tone plus noise, zero-padded after 70% of the input, as a
    recording padded to a 30 s multiple."""
    t = np.arange(windows * N) / 16000.0
    wav = (0.1 * np.sin(2 * np.pi * 440 * t)[None]
           + 0.01 * rng.standard_normal((b, t.size)))
    wav[:, int(0.7 * t.size):] = 0.0
    return wav.astype(np.float32)


@pytest.mark.parametrize("windows", [1, 3])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax_and_host(rng, n_mels, windows):
    wav = _speech_like(rng, 2, windows)
    out = tmel.log_mel_spectrogram(torch.from_numpy(wav), n_mels)
    assert out.dtype == torch.float32 and type(out) is torch.Tensor
    assert out.shape == (2, n_mels, windows * 3000)
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(wav), n_mels))
    host = tfeat.log_mel_numpy(wav, n_mels)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), host, atol=5e-5, rtol=1e-5)


def test_one_waveform_and_the_batch_floor(rng):
    """A 1-D waveform gets a batch axis; each row's max - 8 floor is its
    own (the batch does not couple rows)."""
    wav = _speech_like(rng, 3, 1)
    wav[1] *= 100.0
    batch = tmel.log_mel_spectrogram(torch.from_numpy(wav))
    single = tmel.log_mel_spectrogram(torch.from_numpy(wav[2]))
    assert single.shape == (1, 80, 3000)
    np.testing.assert_allclose(batch[2].numpy(), single[0].numpy(), atol=1e-6)


def test_frames_and_power_match_jax(rng):
    x = rng.standard_normal((2, N + 400)).astype(np.float32)
    np.testing.assert_array_equal(
        tmel._frame(torch.from_numpy(x), 3000).numpy(),
        np.asarray(jmel._frame(jnp.asarray(x), 3000)))
    np.testing.assert_array_equal(tmel._dft_basis().astype(np.float32),
                                  jmel._dft_kernel())
    wav = _speech_like(rng, 2, 1)
    p = tmel.power_spectrogram(torch.from_numpy(wav)).numpy()
    p_ref = np.asarray(jmel.power_spectrogram(jnp.asarray(wav)))
    assert p.shape == (2, 3000, 201)
    np.testing.assert_allclose(p, p_ref, rtol=1e-4, atol=1e-6)


def test_tf32_setting_is_restored():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tmel.log_mel_spectrogram(torch.zeros(N))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_device_helpers_on_the_cpu():
    """No card: the barrier has nothing to wait for, and the device time
    is None (not measured), never a host time."""
    force_execution({"a": [torch.ones(3)], "b": 1})
    force_execution([])
    if not torch.cuda.is_available():
        assert measure_device_ms(lambda: torch.ones(8).sum()) is None
