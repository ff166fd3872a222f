"""The operation and byte counts against hand counts at the shapes of the
kernel table in PERF.md."""

import pytest

from benchmark import roofline as R


def test_flash_forward_at_the_encoder_shape():
    # (16, 20, 1500, 64) bf16: 2 products of 2 * T * T * d per row
    flop, nbytes = R.flash_fwd(16 * 20, 1500, 64, 2)
    assert flop == 4 * 320 * 1500 * 1500 * 64
    assert nbytes == 4 * 320 * 1500 * 64 * 2
    assert R.bound_s(flop, nbytes) * 1e3 == pytest.approx(0.18637, rel=1e-4)
    assert R.bound_by(flop, nbytes) == "operations"


def test_flash_backward_at_the_training_shape():
    flop, nbytes = R.flash_bwd(4 * 20, 1500, 64, 2)
    assert flop == 10 * 80 * 1500 * 1500 * 64
    assert nbytes == 8 * 80 * 1500 * 64 * 2 + 4 * 80 * 1500
    assert R.bound_s(flop, nbytes) * 1e3 == pytest.approx(0.11648, rel=1e-4)


def test_ancestry_at_the_beam_shape():
    # Bb 10, H 20, pos 224, hd 64 bf16: the cache rows read dominate
    flop, nbytes = R.ancestry(10, 20, 224, 64, 2)
    assert flop == 4 * 10 * 20 * 225 * 64
    assert nbytes == 2 * 10 * 20 * 224 * 64 * 2 + 4 * 10 * 20 * 64 * 2 \
        + 4 * 10 * 224
    assert R.bound_by(flop, nbytes) == "bytes"
    assert R.bound_s(flop, nbytes) * 1e3 == pytest.approx(0.0035, abs=5e-5)


def test_psi_at_the_beam_shape():
    flop, nbytes = R.psi_gather(10 * 512, 375, 4, 10 * 375)
    assert flop == 2 * 5120 * 375
    assert R.bound_s(flop, nbytes, "float32") * 1e3 == pytest.approx(
        0.0023, abs=5e-5)


def test_model_flops_of_a_turbo_row_window():
    """~2.36 TFLOP a row-window of 125 tokens at turbo widths."""
    cfg = {"num_mel_bins": 128, "d_model": 1280, "encoder_ffn_dim": 5120,
           "decoder_ffn_dim": 5120, "encoder_layers": 32,
           "decoder_layers": 4, "max_source_positions": 1500,
           "vocab_size": 51866}
    layer = 8 * 1500 * 1280 ** 2 + 4 * 1500 ** 2 * 1280 \
        + 4 * 1500 * 1280 * 5120
    stem = 2 * 3000 * 1280 * 128 * 3 + 2 * 1500 * 1280 * 1280 * 3
    assert R.encoder_window_flops(cfg) == 32 * layer + stem
    dec = sum(R.decoder_token_flops(cfg, p) for p in range(127))
    total = R.encoder_window_flops(cfg) + R.cross_kv_flops(cfg) + dec
    assert total == pytest.approx(2.36e12, rel=0.02)
